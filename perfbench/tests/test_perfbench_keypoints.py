"""The HRNet keypoint cell and the four-card int8 cell on the CPU, through
``run_cell`` at sizes a test run holds: a sound run of each is correct; the
``half`` and ``stale`` faults under the keypoint stream's timed path, and
the fp8 control, fail the HRNet cell's limits; the four-card cell runs four
CPU replicas of the fused int8 forward (``ShardedPredict.staged()``, or the
same two stages made by the driver on a program without it) and is held to
the int8 cell's limits.  The new readers find nothing in an empty trace
and read a trace made by hand."""

import os

import pytest
import torch

from perfbench import faults, harness, roofline, roofline_hrnet
from perfbench.control_keypoints import control_readings
from perfbench.trace import TraceSummary
from spef_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**33 + 21
HRNET = "hrnet_w32_kp.kpstream_b64"
MESH = "flagship_int8.mesh4_b1024"
# The keypoint cell at a quarter of its frame on a side: its limits, set in
# pixels of the 768-wide frame, read four times looser here.
SIZES = {HRNET: {"window": 2, "pool_windows": 2, "ref_block": 2, "img_size": [128, 192],
                 "calibration_frames": 4},
         MESH: {"window": 8, "pool_windows": 2, "ref_block": 8}}
READERS = {"hrnet_mfu.serve": HRNET, "hrnet_forward_roofline": HRNET,
           "hrnet_launch_idle_ms.serve": HRNET, "hrnet_conv_fused_share.serve": HRNET,
           "mesh4_mfu.serve": MESH}
MS = 1_000_000


def _run(cell, fault=None):
    return harness.run_cell(ROOT, cell, SEED, 2.0, False, "cpu", backend="plain",
                            sizes=SIZES[cell], fault=fault)


@pytest.mark.parametrize("cell", [HRNET, MESH])
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"serve_p95_ms", "setup_s"} <= set(result["metrics"])


def test_the_four_card_cell_runs_on_a_program_without_staged(monkeypatch):
    from spef_tpu_torch.engine import ShardedPredict

    monkeypatch.delattr(ShardedPredict, "staged")
    result = _run(MESH)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("name", ["half", "stale"])
def test_a_broken_keypoint_stream_is_not_correct(name):
    result = _run(HRNET, faults.STREAM[name])
    assert result["correct"] is False, (name, result["checks"])
    assert result["failed"] >= 1


def test_the_control_fails_the_keypoint_limits():
    readings = control_readings(ROOT, HRNET, SEED, "cpu", SIZES[HRNET])
    limits = harness.cell_files(ROOT, HRNET)[4]
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)


def _ctx(cell):
    _, c, cfg, traffic, limits = harness.cell_files(ROOT, cell)
    return harness.Context(ROOT, c, cfg, traffic, limits, 1, 1.0, True, None, "plain", 0.0)


def test_every_new_reader_finds_nothing_in_an_empty_trace():
    for name, cell in READERS.items():
        assert harness.load_reader(name).read(TraceSummary([]), _ctx(cell)) is None, name


class _Event:
    """What ``TraceSummary`` reads of a kineto event."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self._name, self._start, self._end = name, start * MS, end * MS
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0


def test_the_readers_on_a_trace_made_by_hand():
    """A 1,000 ms stretch, two windows forwarded: the card busy 0-400 and
    500-900 ms, the forward's HRNet spans over 350-550 (idle inside them
    400-500: 100 ms, 50 a window)."""
    trace = TraceSummary([
        _Event("bench.stretch", 0, 1000, annotation=True),
        _Event("bench.forward", 0, 10, annotation=True),
        _Event("bench.forward", 500, 510, annotation=True),
        _Event("spef.hrnet.stage4", 350, 550, annotation=True),
        _Event("spef.hrnet.fuse", 420, 480, annotation=True),
        _Event("void kernel", 0, 400, device=True), _Event("void kernel", 500, 900, device=True),
    ])
    hr, mesh = _ctx(HRNET), _ctx(MESH)
    frames = 2 * hr.traffic["window"]
    flops = 2 * roofline_hrnet.model_macs(hr.cfg) * frames
    assert harness.load_reader("hrnet_mfu.serve").read(trace, hr) == pytest.approx(
        100 * flops / 1.0 / roofline.PEAK_OPS_S["bf16"])
    assert harness.load_reader("hrnet_launch_idle_ms.serve").read(trace, hr) == pytest.approx(50)
    frames = 2 * mesh.traffic["window"]
    assert harness.load_reader("mesh4_mfu.serve").read(trace, mesh) == pytest.approx(
        100 * 2 * roofline.model_macs(mesh.cfg) * frames / (4 * roofline.PEAK_OPS_S["int8"]))
    profiling.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.count("forward.conv_fused", 37)
            profiling.count("forward.conv_plain", 255)
        share = harness.load_reader("hrnet_conv_fused_share.serve").read(trace, hr)
    finally:
        profiling.reset_counters()
    assert share == pytest.approx(37 / 292)
