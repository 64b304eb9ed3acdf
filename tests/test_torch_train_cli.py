"""The port's training CLIs on the CPU: ``apps.train`` and ``apps.build_int8``
with ``--device cpu``, and what they write read back by the JAX package.

  * ``apps.train`` on the flagship's config (``mobilenet_v2`` + URSONet,
    240x384, both augmentations on the device), warm-started from the
    flagship's checkpoint at a learning rate of 1e-5, on a D-SPEED set
    written by the JAX writer (one train frame; the valid and test frames
    of ``tests/test_torch_eval.py``): one epoch with ``--checkpoint``, then
    a second run resumed from it with ``--device-data``.  Its
    ``model/parameters.msgpack`` evaluated by JAX's ``spef_tpu.apps.eval``
    gives the ESAs the port's final evaluation wrote, within the 2e-3 of
    ``tests/test_torch_eval.py`` (two bf16 forwards of one checkpoint).
    A random-init model would not do: its flat PDFs swing the decoded
    orientations by tens of degrees between two bf16 forwards.
  * ``apps.build_int8`` on a tiny ``small_mobile`` config (48x64): the
    boundary recipe warm-started from a float checkpoint, calibrated, one
    QAT epoch.  Its ``int8_graph.pkl`` equals JAX's ``convert_qat_params``
    of the QAT parameters it saved, as ``tests/test_torch_convert.py``
    checks (no tolerance); the graph serves through ``apps.serve``'s
    ``carry`` and ``layer`` executors on the CPU.
  * The refusals: no CUDA without ``--device cpu``, ``--device-data`` with
    the host rotation warp (``ROT_AUGMENT`` without ``--device-augment``, as
    JAX's), ``--autotune``; a failing experiment writes ``error.log`` and
    the others go on.
"""

import json
import os
import pickle
import re
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from spef_tpu.models.wrapper import ModelWrapper as JaxModelWrapper
from spef_tpu.quant.qmodels import build_quant_backbone, build_quant_head
from spef_tpu_torch.apps import build_int8 as build_app
from spef_tpu_torch.apps import train as train_app

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_convert import assert_same_graph, jax_graph  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
FLAGSHIP_PARAMS = os.path.join(FLAGSHIP, "model", "parameters.msgpack")


def _config(path, still, **replace):
    with open(os.path.join(FLAGSHIP, "config.yaml")) as f:
        cfg = f.read().replace("PATH: /tmp/dspeed_syn/still", f"PATH: {still}")
    for old, new in replace.items():
        assert old in cfg, old
        cfg = cfg.replace(old, new)
    with open(path, "w") as f:
        f.write(cfg)
    return str(path)


_LINE = re.compile(r"\[(\w+)\] esa=([0-9.]+)")


def test_train_cli_resumes_and_its_checkpoint_evaluates_the_same_in_jax(tmp_path, capsys):
    from spef_tpu.apps import eval as jax_eval
    from spef_tpu.data.synthetic import create_synthetic_dataset

    still = create_synthetic_dataset(str(tmp_path / "dspeed"), n_train=1, n_valid=3, n_test=3,
                                     img_size=(240, 384), seed=7)
    cfg = _config(tmp_path / "exp_flagship.yaml", still,
                  **{"BATCH_SIZE: 64": "BATCH_SIZE: 1", "LR: 0.001": "LR: 1.0e-05"})
    common = ["--config", cfg, "--out", str(tmp_path / "out"), "--checkpoint",
              "--device-augment", "--warm-start", FLAGSHIP_PARAMS, "--device", "cpu"]
    first = train_app.main(common + ["--epochs", "1"])["exp_flagship"]
    assert first["start_epoch"] == 1 and first["epochs"][0]["batches"] == 1
    second = train_app.main(common + ["--epochs", "2", "--device-data"])["exp_flagship"]
    out = capsys.readouterr().out
    assert "Resumed from epoch 1" in out and second["start_epoch"] == 2
    assert [s["epoch"] for s in second["epochs"]] == [2]
    folder = second["folder"]
    ckpts = sorted(os.listdir(os.path.join(folder, "checkpoints")))
    assert {"ckpt_1.pt", "ckpt_2.pt", "best_model.msgpack", "meta_2.json"} <= set(ckpts)
    with open(os.path.join(folder, "score_error.json")) as f:
        mine = {p: v["esa"][0] for p, v in json.load(f)["scores"].items()}
    assert sorted(mine) == ["test", "valid"]
    assert all(abs(mine[p] - second["score"][p]["esa"][0]) < 1e-12 for p in mine)

    jax_eval.main(["--experiment", folder, "--batch-size", "3"])
    theirs = {m.group(1): float(m.group(2)) for m in _LINE.finditer(capsys.readouterr().out)}
    assert sorted(theirs) == ["test", "valid"]
    for phase in mine:
        assert abs(mine[phase] - theirs[phase]) <= 2e-3, (phase, mine, theirs)


def _tiny_set(root):
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset

    return create_synthetic_dataset(str(root), 8, 4, 4, img_size=(48, 64), seed=1001)


def _tiny_config(path, still, **more):
    return _config(path, still, **{"NAME: mobilenet_v2": "NAME: small_mobile",
                                   "BATCH_SIZE: 64": "BATCH_SIZE: 4",
                                   "- 240": "- 48", "- 384": "- 64"}, **more)


def test_build_int8_graph_equals_jax_conversion_and_serves(tmp_path):
    from spef_tpu_torch.apps import serve
    from spef_tpu_torch.models.wrapper import import_model, save_model
    from spef_tpu_torch.quant.bitwidth import load_bit_width

    still = _tiny_set(tmp_path / "dspeed")
    cfg = _tiny_config(tmp_path / "exp_tiny.yaml", still)
    fp32 = tmp_path / "fp32"
    save_model(str(fp32), import_model("small_mobile", "ursonet", ori_mode="classification",
                                       n_ori_bins=1232, pos_mode="classification",
                                       n_pos_bins=1000, device="cpu", seed=5))
    result = build_app.main(["--config", cfg, "--out", str(tmp_path / "build"), "--recipe",
                             "boundary", "--fp32-checkpoint", str(fp32 / "parameters.msgpack"),
                             "--calibrate", "percentile", "--qat-epochs", "1", "--device-data",
                             "--device", "cpu"])
    folder = result["folder"]
    for stage in ("qat", "int8", "weight_only"):
        assert all(np.isfinite(result["ladder"][stage][p]["esa"][0]) for p in ("valid", "test"))
    assert result["parity"]["ori_raw"]["cosine"] > 0.99
    for name in ("config.yaml", "int8_graph.pkl", "parity_report.json", "ladder.json"):
        assert os.path.isfile(os.path.join(folder, name)), name

    bw = load_bit_width(os.path.join(folder, "model", "bit_width.json"))
    with open(os.path.join(folder, "model", "parameters.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    module = JaxModelWrapper(
        backbone=build_quant_backbone("small_mobile_q", {"batchnorm": True, "residual": True},
                                      bw, True),
        head=build_quant_head("ursonet_q", 1232, 1000, bw, True))
    with open(os.path.join(folder, "int8_graph.pkl"), "rb") as f:
        graph = pickle.load(f)
    assert_same_graph(graph, jax_graph(module, variables, bw))

    frames = np.random.RandomState(0).randint(0, 256, (3, 48, 64, 3), np.uint8)
    for executor in ("carry", "layer"):
        server, img_size = serve.build_server(serve.parse_args([
            "--experiment", folder, "--int8-graph", os.path.join(folder, "int8_graph.pkl"),
            "--int8-executor", executor, "--batch", "4", "--device", "cpu"]))
        pose, _ = server.predict(frames)
        assert img_size == (48, 64) and pose["ori"].shape == (3, 4)
        assert np.isfinite(pose["pos"]).all()


def test_what_the_clis_refuse(tmp_path, capsys, monkeypatch):
    still = _tiny_set(tmp_path / "dspeed")
    cfg = _tiny_config(tmp_path / "exp_tiny.yaml", still)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_app.main(["--config", cfg, "--out", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="--device cpu"):
        build_app.main(["--config", cfg, "--out", str(tmp_path / "b")])
    with pytest.raises(NotImplementedError, match="item 1"):
        build_app.main(["--config", cfg, "--autotune", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device-data requires --device-augment"):
        train_app.main(["--config", cfg, "--out", str(tmp_path / "out_dd"), "--device-data",
                        "--device", "cpu"])

    # An unknown backbone and an unknown optimizer: each experiment fails
    # on its own, with its error.log.
    folder = tmp_path / "exps"
    folder.mkdir()
    _tiny_config(folder / "exp_a.yaml", still,
                 **{"NAME: small_mobile": "NAME: no_such_backbone"})
    _tiny_config(folder / "exp_b.yaml", still, **{"OPTIM: Adam": "OPTIM: Lion",
                                                  "ROT_AUGMENT: true": "ROT_AUGMENT: false"})
    results = train_app.main(["--experiments", str(folder), "--out", str(tmp_path / "out"),
                              "--epochs", "1", "--device", "cpu"])
    assert results == {"exp_a": None, "exp_b": None}
    with open(tmp_path / "out" / "exp_a" / "error.log") as f:
        assert "no_such_backbone" in f.read()
    with open(tmp_path / "out" / "exp_b" / "error.log") as f:
        assert "Lion" in f.read()
    assert "Experiment exp_b failed; continuing" in capsys.readouterr().err
