"""``python -m spef_tpu_torch.apps.serve`` on an exported artifact and on a
directory of frames, against ``spef_tpu.apps.serve`` (the counterpart of
``tests/test_serve_cli.py``).

One ``small_mobile_q`` + ``ursonet_q`` experiment with quantization off
(float32 in both packages; regression heads, so each quaternion is the
normalized network output with no ``eigh`` between the two packages'
numbers), random init from the port's seed, saved by the port and read by
both; five 32x48 frames written as PNG by the port's writer.  JAX's serve
CLI (``--experiment``) and the port's (``--artifact``, exported by
``apps.export``, and ``--experiment``) print one ``name: q=[...] t=[...]``
line a frame; the lines agree within one unit of their printed rounding
(1e-4 for q, 1e-3 m for t: float32 on both sides, 1e-6 apart).
"""

import json
import re

import numpy as np
import pytest
import torch

from spef_tpu_torch.apps import export as export_app
from spef_tpu_torch.apps import serve
from spef_tpu_torch.data.png import write_png
from spef_tpu_torch.models.wrapper import import_model, save_model

torch.set_num_threads(1)

HW = (32, 48)
N_FRAMES = 5
LINE = re.compile(r"^(\S+\.png): q=(\[[^\]]*\]) t=(\[[^\]]*\])$")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(experiment, its exported artifact at a window of 4, frames dir)."""
    root = tmp_path_factory.mktemp("serve_cli")
    exp = root / "exp_serve"
    model = import_model("small_mobile_q", "ursonet_q", quantization=False,
                         ori_mode="regression", pos_mode="regression", img_size=HW, seed=7,
                         device="cpu")
    save_model(str(exp / "model"), model)
    (exp / "config.yaml").write_text(f"""\
MODEL:
  QUANTIZATION: false
  BACKBONE:
    NAME: small_mobile_q
  HEAD:
    NAME: ursonet_q
    ORI: regression
    POS: regression
DATA:
  PATH: {root}/none
  IMG_SIZE: [{HW[0]}, {HW[1]}]
""")
    artifact = str(root / "model.spef")
    export_app.main(["--experiment", str(exp), "--out", artifact, "--batch", "4",
                     "--device", "cpu"])
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.RandomState(3)
    for i in range(N_FRAMES):
        write_png(str(frames / f"f{i}.png"), rng.randint(0, 256, (*HW, 3), dtype=np.uint8))
    return str(exp), artifact, str(frames)


def _lines(out):
    """{frame name: (q, t)} of the per-frame lines."""
    rows = {}
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            rows[m.group(1)] = tuple(np.array(json.loads(m.group(i))) for i in (2, 3))
    return rows


def test_artifact_selftest(setup, capsys):
    _, artifact, _ = setup
    serve.main(["--artifact", artifact, "--selftest-frames", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Serving AOT artifact" in out and "variant=float" in out and "window=4x" in out
    assert "selftest:" in out and "frames/s sustained" in out


def test_frames_dir_matches_jax(setup, capsys):
    from spef_tpu.apps.serve import main as jax_serve_main

    exp, artifact, frames = setup
    jax_serve_main(["--experiment", exp, "--batch", "8", "--frames-dir", frames])
    want = _lines(capsys.readouterr().out)
    assert sorted(want) == [f"f{i}.png" for i in range(N_FRAMES)]
    for argv in (["--artifact", artifact], ["--experiment", exp, "--batch", "4"]):
        serve.main([*argv, "--frames-dir", frames, "--device", "cpu"])
        out = capsys.readouterr().out
        got = _lines(out)
        assert sorted(got) == sorted(want), argv
        for name, (q, t) in want.items():
            np.testing.assert_allclose(got[name][0], q, rtol=0, atol=1.01e-4, err_msg=name)
            np.testing.assert_allclose(got[name][1], t, rtol=0, atol=1.001e-3, err_msg=name)
        # two requests of the window of 4: 4 frames and 1, padded
        assert "latency stats: {" in out and "'requests': 2" in out


def test_frames_dir_refuses_jpeg(setup, tmp_path, monkeypatch):
    """A JPEG that does not decode is refused by name; on a host without
    the native loader's headers (monkeypatched) any JPEG is refused, naming
    them."""
    from spef_tpu_torch import native

    _, artifact, _ = setup
    (tmp_path / "frame.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    argv = ["--artifact", artifact, "--frames-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(IOError, match="frame.jpg"):
        serve.main(argv)
    monkeypatch.setattr(native, "missing", lambda: ("jpeglib.h", "png.h"))
    with pytest.raises(ValueError, match="missing jpeglib.h, png.h"):
        serve.main(argv)


@pytest.mark.parametrize("argv", [[], ["--experiment", "x", "--artifact", "y"]])
def test_exactly_one_of_experiment_and_artifact(argv):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)


@pytest.mark.parametrize("extra", [["--int8-graph", "g.pkl"], ["--int8-executor", "fused"],
                                   ["--int8-backend", "plain"], ["--batch", "8"], ["--ransac"],
                                   ["--border-gate", "0.02"], ["--crop-refine", "fine"]])
def test_artifact_refuses_experiment_only_flags(extra, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--artifact", "model.spef", *extra])
    assert f"{extra[0]} applies only to --experiment" in capsys.readouterr().err


def test_cuda_device_without_a_card_exits(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--artifact", setup[1]])
