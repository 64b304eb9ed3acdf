"""The comparison that decides ``correct`` fails when the timed path is
broken underneath, and the control (the reference in the precision below
the configuration's) fails the limits; a sound run passes.  On the CPU at
sizes a test run holds, skipping the harness's look for a card; the
``cuda`` lane repeats the controls at the cells' own sizes on the card."""

import os

import pytest

from perfbench import faults
from perfbench.control import control_readings
from perfbench.harness import cell_files, run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**33 + 77

# Sizes a test run holds: the frames at their real size (a trained model
# gives flat PDFs on smaller ones), few of them.
STREAM = {"window": 2, "pool_windows": 2, "ref_block": 2}
TRAIN = {"batch": 16, "split_frames": 32, "window_step_range": [0, 1]}
CELLS = {"flagship_int8.stream_b256": STREAM, "flagship_float.stream_b256": STREAM,
         "flagship_float.train_b64": TRAIN}


def _run(cell, fault=None, seconds=2.0):
    return run_cell(ROOT, cell, SEED, seconds, False, "cpu", backend="plain",
                    sizes=CELLS[cell], fault=fault)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["flagship_int8.stream_b256", "flagship_float.stream_b256"])
@pytest.mark.parametrize("name", sorted(faults.STREAM))
def test_a_broken_stream_is_not_correct(cell, name):
    result = _run(cell, faults.STREAM[name])
    assert result["correct"] is False, (name, result["checks"])
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
def test_a_broken_train_step_is_not_correct(name):
    result = _run("flagship_float.train_b64", faults.TRAIN[name])
    assert result["correct"] is False, (name, result["checks"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_limits(cell):
    readings = control_readings(ROOT, cell, SEED, "cpu", CELLS[cell])
    limits = cell_files(ROOT, cell)[4]
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_limits_at_the_cell_size(card, cell):
    limits = cell_files(ROOT, cell)[4]
    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
        readings = control_readings(ROOT, cell, seed, card)
        assert any(readings[k] > limits[k] for k in limits), (seed, readings, limits)
