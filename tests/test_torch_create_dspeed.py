"""Port parity: ``python -m spef_tpu_torch.apps.create_dspeed`` against
``spef_tpu.apps.create_dspeed``.

  * The labels of all 11 scenarios at the full ``--n-frames 1499`` and of a
    small still set, both schemas (``--reference-format``): equal JSON.
  * One short scenario rendered at 64x96 by both: the same pixels (both
    files decoded by PIL, bit for bit, as ``tests/test_torch_synthetic_writers.py``
    holds the other writers).
  * ``render_images`` with 1 and 3 worker processes: the same files, byte
    for byte.
  * The frames the card's temporal phase writes (``--skip-still --render
    --img-height 240 --img-width 384 --n-frames 299``): one scenario's 300
    PNG files hash to the sha256 that ``spef_tpu_torch/assets/temporal_esa.json``
    recorded for JAX's numbers.
  * ``--figures``: the same file names as JAX's; without matplotlib an
    ``ImportError`` that names the flag.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from spef_tpu.apps import create_dspeed as jcreate
from spef_tpu_torch.apps import create_dspeed
from spef_tpu_torch.data.camera import DSPEED_CAMERA

from test_torch_temporal_cli import IMG_SIZE, N_FRAMES, TEMPORAL_ASSET

SCENARIOS = ("S", "TIR", "TIT", "TITR", "TAR", "TAT", "TATR", "CIR", "CAR", "CATR", "Docking")


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_all_scenario_labels_match_jax(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--n-still", "12", "--n-frames", "1499", "--reference-format"]
    create_dspeed.main(["--out", mine, *args])
    jcreate.main(["--out", theirs, *args])
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == sorted(
        (*SCENARIOS, "still"))
    for seq in (*SCENARIOS, "still"):
        labels = _json(os.path.join(mine, seq, "pose.json"))
        assert labels == _json(os.path.join(theirs, seq, "pose.json")), seq
        assert len(labels) == (12 if seq == "still" else 1500)
        assert not os.path.exists(os.path.join(mine, seq, "images"))
    # The reference schema names files by folder: compare it entry by entry.
    for seq in SCENARIOS:
        got = _json(os.path.join(mine, seq, "pose_reference_format.json"))
        want = _json(os.path.join(theirs, seq, "pose_reference_format.json"))
        assert list(got.values()) == list(want.values()), seq


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_rendered_scenario_matches_jax(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--skip-still", "--render", "--img-height", "64", "--img-width", "96",
            "--n-frames", "5", "--scenarios", "TITR"]
    create_dspeed.main(["--out", mine, *args])
    jcreate.main(["--out", theirs, *args])
    names = sorted(os.listdir(os.path.join(theirs, "TITR", "images")))
    assert sorted(os.listdir(os.path.join(mine, "TITR", "images"))) == names
    assert len(names) == 6
    for name in names:
        np.testing.assert_array_equal(_pixels(os.path.join(mine, "TITR", "images", name)),
                                      _pixels(os.path.join(theirs, "TITR", "images", name)),
                                      err_msg=name)


def _scenario(name, n_frames):
    initial_q = create_dspeed._np_quat_mul(np.array([0.0, -0.7071, 0.7071, 0.0]),
                                           np.array([1.0, 0.0, 0.0, 0.0]))
    sc = create_dspeed.scenario_table(initial_q)[name]
    return create_dspeed.generate_sequence(n_frames, sc["init"], sc["evo"], DSPEED_CAMERA,
                                           camera_movement=sc["camera"])


def test_render_workers_write_the_same_files(tmp_path):
    oris, poss = _scenario("CATR", 8)
    for workers in (1, 3):
        assert create_dspeed.render_images([(str(tmp_path / f"w{workers}"), oris, poss)],
                                           DSPEED_CAMERA, (48, 72), workers=workers) == workers
    one, three = tmp_path / "w1" / "images", tmp_path / "w3" / "images"
    names = sorted(os.listdir(one))
    assert sorted(os.listdir(three)) == names and len(names) == 9
    for name in names:
        assert (one / name).read_bytes() == (three / name).read_bytes(), name


def test_card_scenario_frames_hash_to_the_asset(tmp_path):
    """The first of the recorded scenarios, as the card's phase writes it."""
    record = _json(TEMPORAL_ASSET)
    assert record["n_frames"] == N_FRAMES + 1 and record["img_size"] == list(IMG_SIZE)
    assert sorted(record["scenarios"]) == sorted(SCENARIOS)
    oris, poss = _scenario("S", N_FRAMES)
    create_dspeed.render_images([(str(tmp_path / "S"), oris, poss)], DSPEED_CAMERA, IMG_SIZE,
                                workers=3)
    assert len(os.listdir(tmp_path / "S" / "images")) == N_FRAMES + 1
    assert create_dspeed.frames_sha256(str(tmp_path / "S")) == record["scenarios"]["S"]["frames_sha256"]


def test_figures_match_jax_names(tmp_path):
    oris, poss = _scenario("TAR", 30)
    for mod, where in ((create_dspeed, "port"), (jcreate, "jax")):
        os.makedirs(tmp_path / where)
        mod.make_figures(str(tmp_path / where), oris, poss, "TAR")
        mod.make_figures(str(tmp_path / where), oris, poss, "still", still=True)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "distributions.png", "trajectory.png"]


def test_figures_without_matplotlib_name_the_flag(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(ImportError, match="--figures needs matplotlib"):
        create_dspeed.main(["--out", str(tmp_path), "--skip-still", "--n-frames", "3",
                            "--scenarios", "S", "--figures"])
