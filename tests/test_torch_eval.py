"""Port parity: the evaluation path (``train/trainer.py::evaluation``,
``apps/eval.py``) against the JAX package, and the recorded reference the
card's accuracy phase is held to.

  * ``evaluation`` on the same fixed predictions and batches (a padded last
    batch included) as ``spef_tpu.train.trainer.evaluation``: every score
    and error within 1e-6 (float32 scoring on both sides; the std and MAD
    of the per-frame errors are numpy on both).
  * ``python -m spef_tpu_torch.apps.eval --device cpu`` and
    ``python -m spef_tpu.apps.eval`` on one small experiment directory: the
    flagship's weights saved by the port (``save_model``) and read by both,
    the flagship's config, and a 240x384 D-SPEED still set of 3 + 3 frames
    written by the JAX writer.  Both forwards are bf16 (each package's
    default), so the printed ESAs are held within 2e-3 (seen: 0.0014 on
    valid, 0.0004 on test; the float32 forwards agree within the 0.05
    degrees and 1 mm of ``tests/test_torch_models.py``).  A random-init
    model would not do: its PDFs are flat, and the two bf16 forwards' last
    bits swing its decoded orientations by tens of degrees.  The JSON and
    CSV layouts are equal.
  * ``spef_tpu_torch/assets/flagship_test_esa.json``: the flagship's test
    ESA measured with the JAX package on the CPU, float and ``int8_carry``
    on the committed int8 graph, over the 2,000 test frames; the float value
    within 0.002 of the recorded ``eval_score_error.json``.

Regenerate the asset (the test split written by the port, about 2 minutes
of draws and rendering, then both JAX evaluations on the CPU, about 10
minutes in all) from the repo root with

    JAX_PLATFORMS=cpu python -m tests.test_torch_eval
"""

import json
import os
import re
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.train.trainer import evaluation as jax_evaluation
from spef_tpu_torch.train.trainer import evaluation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")
ESA_ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_test_esa.json")
# The flagship's test split (experiments/gen_dataset.sh): create_synthetic_dataset
# with these counts, at 240x384, seed 1001.
N_TRAIN, N_VALID, N_TEST = 20000, 2000, 2000


class _Fixed:
    """An engine that returns given poses, batch after batch."""

    def __init__(self, poses, wrap):
        self.poses, self.wrap = list(poses), wrap

    def predict(self, images):
        ori, pos = self.poses.pop(0)
        return {"ori": self.wrap(ori), "pos": self.wrap(pos)}, 0.5


def _batches(seed, n, bs):
    rs = np.random.RandomState(seed)
    out, poses = [], []
    for start in range(0, n, bs):
        k = min(bs, n - start)
        q = rs.randn(bs, 4).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        pos = np.stack([rs.uniform(-3, 3, bs), rs.uniform(-3, 3, bs),
                        rs.uniform(3, 35, bs)], -1).astype(np.float32)
        qp = q + rs.randn(bs, 4).astype(np.float32) * 0.2
        qp /= np.linalg.norm(qp, axis=-1, keepdims=True)
        pp = pos + rs.randn(bs, 3).astype(np.float32)
        mask = np.r_[np.ones(k), np.zeros(bs - k)].astype(np.float32)
        out.append({"images": np.zeros((bs, 2, 2, 3), np.uint8), "ori": q, "pos": pos,
                    "mask": mask})
        poses.append((qp, pp))
    return out, poses


def test_evaluation_matches_jax_on_fixed_predictions():
    data, poses = {}, {}
    for phase, seed, n in (("valid", 0, 37), ("test", 1, 64)):
        data[phase], poses[phase] = _batches(seed, n, 16)
    split = ("valid", "test")
    flat = [p for s in split for p in poses[s]]
    got = evaluation(_Fixed(flat, torch.from_numpy), data, None, split)
    want = jax_evaluation(_Fixed(flat, jnp.asarray), data, None, split)
    for rec, jrec in zip(got, want):  # (rec_score, rec_error)
        for phase in split:
            assert sorted(rec[phase]) == sorted(jrec[phase])
            for k, v in rec[phase].items():
                assert len(v) == 1 and v[0] == pytest.approx(jrec[phase][k][0], abs=1e-6), k
    assert sorted(got[0]["test"]) == ["esa", "ori", "pos"]
    # An orientation dot product above 1.01 is a broken prediction.
    broken = [(np.asarray(q) * 1.05, p) for q, p in poses["valid"]]
    with pytest.raises(ValueError, match="Intermediate sum"):
        evaluation(_Fixed(broken, torch.from_numpy), {"valid": data["valid"]}, None)


# ---------------------------------------------------------------------------
# apps.eval on a tiny experiment
# ---------------------------------------------------------------------------

SMALL_HW = (240, 384)


def _small_experiment(root):
    """The flagship's weights saved by the port, its config, and a small
    D-SPEED still set written by the JAX writer."""
    from spef_tpu.data.synthetic import create_synthetic_dataset
    from spef_tpu_torch.models.wrapper import import_model, save_model

    still = create_synthetic_dataset(os.path.join(root, "dspeed_tiny"), n_train=1, n_valid=3,
                                     n_test=3, img_size=SMALL_HW, seed=7)
    exp = os.path.join(root, "exp")
    model = import_model(ori_mode="classification", n_ori_bins=1232, pos_mode="classification",
                         n_pos_bins=1000, seed=7, device="cpu",
                         params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"))
    save_model(os.path.join(exp, "model"), model)
    with open(os.path.join(FLAGSHIP, "config.yaml")) as f:
        cfg = f.read()
    cfg = cfg.replace("PATH: /tmp/dspeed_syn/still", f"PATH: {still}")
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        f.write(cfg)
    return exp


_LINE = re.compile(r"\[(\w+)\] esa=([0-9.]+) ori_err=([0-9.]+)deg .* pos_err=([0-9.]+)m")


def _printed(out):
    return {m.group(1): tuple(float(g) for g in m.groups()[1:]) for m in _LINE.finditer(out)}


def test_eval_app_on_cpu_matches_the_jax_app(tmp_path, capsys):
    from spef_tpu.apps import eval as jax_eval
    from spef_tpu_torch.apps import eval as port_eval

    exp = _small_experiment(str(tmp_path))
    jexp = str(tmp_path / "exp_jax")
    shutil.copytree(exp, jexp)
    port_eval.main(["--experiment", exp, "--device", "cpu", "--batch-size", "2"])
    got = _printed(capsys.readouterr().out)
    jax_eval.main(["--experiment", jexp, "--batch-size", "2"])
    want = _printed(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == ["test", "valid"]
    for phase in got:
        assert abs(got[phase][0] - want[phase][0]) <= 2e-3, (phase, got, want)
    mine, theirs = (json.load(open(os.path.join(d, "eval_score_error.json"))) for d in (exp, jexp))
    assert sorted(mine) == sorted(theirs) == ["errors", "scores"]
    for sheet in ("scores", "errors"):
        assert mine[sheet].keys() == theirs[sheet].keys()
        for phase in mine[sheet]:
            assert mine[sheet][phase].keys() == theirs[sheet][phase].keys()
        with open(os.path.join(exp, f"eval_score_error_{sheet}.csv")) as f:
            rows = f.read().splitlines()
        with open(os.path.join(jexp, f"eval_score_error_{sheet}.csv")) as f:
            jrows = f.read().splitlines()
        assert rows[0] == jrows[0] and len(rows) == len(jrows) == 2
        # the CSV holds the JSON's values, one row
        flat = [v[0] for phase in mine[sheet].values() for v in phase.values()]
        assert [float(x) for x in rows[1].split(",")] == flat


def test_eval_app_refuses_what_it_does_not_port(tmp_path):
    from spef_tpu_torch.apps import eval as port_eval

    # The keypoint flags are ported (ROADMAP §A, item 8;
    # tests/test_torch_crop_refine.py): they parse, and the app goes on to
    # read the experiment, whose config this directory lacks.
    args = port_eval.parse_args(["--experiment", str(tmp_path), "--ransac", "--border-gate",
                                 "0.02", "--crop-refine", "x"])
    assert args.ransac and args.border_gate == 0.02 and args.crop_refine == "x"
    for flags in (["--ransac"], ["--border-gate", "0.02"], ["--crop-refine", "x"]):
        with pytest.raises(AssertionError, match="config.yaml does not exist"):
            port_eval.main(["--experiment", str(tmp_path), "--device", "cpu"] + flags)


def test_save_score_error_writes_the_jax_layout(tmp_path):
    from spef_tpu.utils.experiment import save_score_error as jax_save
    from spef_tpu_torch.utils.experiment import load_score_error, save_score_error

    scores = {"valid": {"esa": [0.1, 0.2], "ori": [0.3]}, "test": {"esa": [1.0 / 3.0]}}
    errors = {"valid": {"ori": [5.5]}}
    latency = {"valid": [1.25, 2.5, 3.0]}
    for d, fn in (("port", save_score_error), ("jax", jax_save)):
        fn(str(tmp_path / d), scores, errors, latency, name="s")
    assert load_score_error(str(tmp_path / "port"), "s") == load_score_error(
        str(tmp_path / "jax"), "s")
    for sheet in ("scores", "errors", "latency"):
        got = (tmp_path / "port" / f"s_{sheet}.csv").read_text()
        want = (tmp_path / "jax" / f"s_{sheet}.csv").read_text()
        assert got == want, sheet
    assert not (tmp_path / "port" / "s.xlsx").exists()


# ---------------------------------------------------------------------------
# The recorded reference of the card's accuracy phase
# ---------------------------------------------------------------------------


def test_recorded_flagship_test_esa():
    with open(ESA_ASSET) as f:
        rec = json.load(f)
    with open(os.path.join(FLAGSHIP, "eval_score_error.json")) as f:
        recorded = json.load(f)["scores"]["test"]["esa"][0]
    assert rec["n_frames"] == N_TEST and rec["img_size"] == [240, 384] and rec["seed"] == 1001
    assert abs(rec["float"]["esa"] - recorded) <= 0.002, (rec["float"]["esa"], recorded)
    assert 0.0 < rec["int8_carry"]["esa"] < 1.0
    assert rec["int8_graph_sha256"] == _sha256(ASSET)  # measured on the committed graph


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def measure(workdir, workers=4, batch_size=16):
    """Write the flagship's test split with the port's writer, then evaluate
    the JAX package on it on the CPU: the float flagship through
    ``spef_tpu.apps.eval`` and ``int8_carry`` on the committed graph through
    ``evaluation``.  Returns the record ``flagship_test_esa.json`` holds."""
    import time

    import jax

    from spef_tpu.apps import eval as jax_eval
    from spef_tpu.codec.facade import SPEUtils
    from spef_tpu.data.camera import load_camera
    from spef_tpu.data.dataset import load_dataset
    from spef_tpu.engine import SPEJax
    from spef_tpu.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.data.synthetic import _create_test_split
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    t0 = time.perf_counter()
    still = _create_test_split(os.path.join(workdir, "dspeed"), N_TRAIN, N_VALID, N_TEST,
                               img_size=(240, 384), seed=1001, workers=workers)
    t1 = time.perf_counter()
    exp = os.path.join(workdir, "exp_dspeed_synth")
    os.makedirs(exp, exist_ok=True)
    shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), exp)
    if not os.path.exists(os.path.join(exp, "model")):
        os.symlink(os.path.join(FLAGSHIP, "model"), os.path.join(exp, "model"))
    jax_eval.main(["--experiment", exp, "--data", still, "--batch-size", str(batch_size)])
    with open(os.path.join(exp, "eval_score_error.json")) as f:
        out = json.load(f)
    float_rec = {"esa": out["scores"]["test"]["esa"][0], "ori_deg": out["errors"]["test"]["ori"][0],
                 "pos_m": out["errors"]["test"]["pos"][0]}
    t2 = time.perf_counter()
    graph = load_int8_graph(ASSET)  # numpy leaves, Python scalars
    utils = SPEUtils.create(load_camera(still), ori_mode="classification",
                            pos_mode="classification", use_keypoints=False)
    data, _ = load_dataset(still, batch_size, (240, 384))
    stand_in = types.SimpleNamespace(variables=None)  # the forward is the graph's
    engine = SPEJax(stand_in, utils, forward_fn=build_int8_carry_forward(graph))
    score, error = jax_evaluation(engine, data, utils, ("test",))
    carry_rec = {"esa": score["test"]["esa"][0], "ori_deg": error["test"]["ori"][0],
                 "pos_m": error["test"]["pos"][0]}
    t3 = time.perf_counter()
    return {
        "what": "test ESA of the flagship exp_dspeed_synth on its D-SPEED test split, "
                "measured with the JAX package on the CPU",
        "how": "JAX_PLATFORMS=cpu python -m tests.test_torch_eval",
        "n_frames": N_TEST, "img_size": [240, 384], "seed": 1001,
        "split_written_by": "spef_tpu_torch.data.synthetic._create_test_split "
                            f"({N_TRAIN} train and {N_VALID} valid draws replayed)",
        "loader": "spef_tpu.data.dataset.load_dataset",
        "batch_size": batch_size,
        "float": dict(float_rec, executor="spef_tpu.apps.eval (bf16 flax forward)"),
        "int8_carry": dict(carry_rec, executor="spef_tpu.quant.int8_carry."
                                               "build_int8_carry_forward, jitted"),
        "int8_graph": "spef_tpu_torch/assets/flagship_boundary_int8_graph.pkl",
        "int8_graph_sha256": _sha256(ASSET),
        "jax": jax.__version__, "device": jax.devices()[0].platform,
        "seconds": {"write": round(t1 - t0, 1), "float": round(t2 - t1, 1),
                    "int8_carry": round(t3 - t2, 1)},
    }


if __name__ == "__main__":
    work = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "build", "test_split_esa")
    record = measure(work)
    with open(ESA_ASSET, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(record, indent=2))
