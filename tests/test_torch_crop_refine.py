"""Port parity: the two-pass crop-refine path and the keypoints mode of the
apps against the JAX package on the CPU.

The committed pair (``exp_keypoints_heatmap_synth`` as the coarse pass,
``exp_keypoints_crop2_synth`` as the fine pass; MobileNetV2 at 240x384,
bf16 convolutions in both packages) on the frames of a tiny D-SPEED still
set (2 valid + 2 test frames, written by the port's writer):

  * ``SPECropRefine`` through ``build_engine_variant``'s ``crop-refine`` and
    ``crop-refine-w8`` (RANSAC decode, the registry's gate): the coarse
    keypoints within 2e-3 (normalized; ~4 px at 1920), the boxes within
    4e-3, the gated keypoints within 4e-3 where both packages keep the
    same source; the port's pose within 0.5 deg and 5 cm of JAX's RANSAC
    on the port's keypoints wherever its consensus has 6 points or more,
    and the two engines' poses within a median of
    0.5 deg and 5 cm (the bf16 roundings of two convolution libraries move
    the keypoints, and RANSAC may turn that into another hypothesis on a
    frame: seen 6.1 deg on one of 4).  ``discover_engine_variants`` equals
    JAX's;
  * ``python -m spef_tpu_torch.apps.eval --ransac --crop-refine FINE
    --device cpu`` against ``spef_tpu.apps.eval`` with the same flags: the
    printed ESAs within 0.03 on these 2 + 2 frames (each frame's distance
    counts half of a split's mean).  With ``--border-gate 0.02`` added: the
    sidecar ``eval_score_error_ransac_gated_croprefine`` in both packages,
    with the same layout, and the port app's scores exactly its engine's
    with those options.  The gated decode's ESAs are not held to JAX's on
    these frames: a gate gives the control frame a weighted covariance
    whose axis signs JAX leaves to LAPACK and the port cannot pin (seen:
    one of these test frames 18 deg apart; the gated decoder is held to JAX
    in ``tests/test_torch_epnp.py`` and on the npz frames in
    ``tests/test_torch_keypoints_esa.py``); the other sidecar names by
    flag;
  * ``serve --crop-refine --ransac --device cpu``: the served poses equal
    the engine's; ``--int8-graph`` with ``--crop-refine`` refused;
  * keypoints training: three SGD steps of ``small_mobile`` + each keypoint
    head at 48x64, float32 on both sides, on targets encoded with crop
    windows (``Trainer._encode_targets`` against JAX's): every loss within
    5e-5 relative (seen 1.2e-5 with the heatmap head's softmax); the eval
    step's loss on crop batches within 5e-5 and its
    decoded metrics finite; ``apps.train`` trains a keypoints experiment on
    a crop set (``create_crop_dataset``) for one epoch.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "experiments", "train_synth")
COARSE = os.path.join(SYNTH, "exp_keypoints_heatmap_synth")
FINE = os.path.join(SYNTH, "exp_keypoints_crop2_synth")


def _dist(a_q, a_t, b_q, b_t):
    a_q, b_q = np.asarray(a_q, np.float64), np.asarray(b_q, np.float64)
    dot = np.clip(np.abs((a_q * b_q).sum(-1)), 0.0, 1.0)
    return 2 * np.degrees(np.arccos(dot)), np.linalg.norm(np.asarray(a_t) - np.asarray(b_t),
                                                          axis=-1)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset

    root = tmp_path_factory.mktemp("kp_split")
    return create_synthetic_dataset(str(root / "dspeed"), n_train=1, n_valid=2, n_test=2,
                                    img_size=(240, 384), seed=11)


@pytest.fixture(scope="module")
def frames(split):
    from spef_tpu_torch.data.dataset import load_dataset

    data, _ = load_dataset(split, 4, (240, 384))
    return np.concatenate([b["images"][:int(b["mask"].sum())] for phase in ("valid", "test")
                           for b in data[phase]])


def _experiment(root, split):
    """A copy of the coarse experiment (its model/ the committed one) whose
    config points at ``split`` and whose registry names the fine model by
    its absolute path."""
    exp = os.path.join(root, "exp_keypoints_heatmap_synth")
    os.makedirs(exp, exist_ok=True)
    with open(os.path.join(COARSE, "config.yaml")) as f:
        cfg = f.read().replace("PATH: /tmp/dspeed_syn/still", f"PATH: {split}")
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        f.write(cfg)
    if not os.path.exists(os.path.join(exp, "model")):
        os.symlink(os.path.join(COARSE, "model"), os.path.join(exp, "model"))
    with open(os.path.join(exp, "crop_refine.json"), "w") as f:
        json.dump({"fine_exp": FINE}, f)
    return exp


@pytest.fixture(scope="module")
def experiment(tmp_path_factory, split):
    return _experiment(str(tmp_path_factory.mktemp("kp_exp")), split)


@pytest.fixture(scope="module")
def coarse_models():
    from spef_tpu.models.wrapper import import_model as jimport
    from spef_tpu_torch.engine import load_experiment_model

    params = os.path.join(COARSE, "model", "parameters.msgpack")
    jmodel = jimport("mobilenet_v2", "keypoints_heatmap", img_size=(240, 384),
                     params_path=params, quantization=False, ori_mode="keypoints",
                     pos_mode="keypoints")
    return jmodel, load_experiment_model(COARSE, device="cpu")


def _utils(ransac=True):
    from spef_tpu.codec.facade import SPEUtils as JUtils
    from spef_tpu.data.camera import DSPEED_CAMERA as JCAM
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import DSPEED_CAMERA

    kw = dict(ori_mode="keypoints", pos_mode="keypoints", keypoints_ransac=ransac)
    return JUtils.create(JCAM, **kw), SPEUtils.create(DSPEED_CAMERA, device="cpu", **kw)


def test_discover_engine_variants_matches_jax(experiment):
    from spef_tpu.engine import discover_engine_variants as jdiscover
    from spef_tpu_torch.engine import discover_engine_variants

    assert discover_engine_variants(experiment) == jdiscover(experiment) == [
        "float", "crop-refine", "crop-refine-w8"]
    cwd = os.getcwd()
    try:  # the committed registry names the fine model from the repo root
        os.chdir(REPO)
        assert discover_engine_variants(COARSE) == jdiscover(COARSE)
        assert "crop-refine" in discover_engine_variants(COARSE)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("variant", ["crop-refine", "crop-refine-w8"])
def test_crop_refine_variants_match_jax(experiment, coarse_models, frames, variant):
    from spef_tpu.engine import build_engine_variant as jbuild
    from spef_tpu_torch.engine import SPECropRefine, build_engine_variant

    jmodel, model = coarse_models
    jutils, utils = _utils()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    engine = build_engine_variant(experiment, model, utils, variant, device="cpu")
    assert isinstance(engine, SPECropRefine)
    got, ms = engine.predict(frames)
    assert ms > 0
    want, _ = jbuild(experiment, jmodel, jutils, variant).predict(jnp.asarray(frames))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["keypoints_coarse"], want["keypoints_coarse"], atol=2e-3)
    np.testing.assert_allclose(got["crop_box"], want["crop_box"], atol=4e-3)
    same = np.repeat(got["gate_keep"] == want["gate_keep"], 2, axis=-1)
    assert same.mean() >= 0.9
    np.testing.assert_allclose(got["keypoints"][same], want["keypoints"][same], atol=4e-3)
    # The port's keypoints through JAX's RANSAC: the port's pose on every
    # frame with a consensus of 6 or more (with fewer, the refinement is
    # underdetermined and its float32 answer arbitrary: seen 5.6 deg on a
    # frame of 2 inliers).
    from spef_tpu.codec.epnp import epnp_ransac
    from spef_tpu.pose.rotations import dcm2quat

    cam = jutils.camera
    px = got["keypoints"].reshape(len(frames), 12, 2)[:, 1:] * np.array([cam.nu, cam.nv],
                                                                         np.float32)
    jr, jt, jinl = jax.jit(lambda x: epnp_ransac(jutils.keypoints.keypoints3d, x, jnp.asarray(
        cam.K, jnp.float32)))(jnp.asarray(px))
    posed = np.asarray(jinl).sum(-1) >= 6
    assert posed.sum() >= 3
    ang, d = _dist(got["ori"], got["pos"], np.asarray(dcm2quat(jr)), np.asarray(jt))
    assert ang[posed].max() <= 0.5 and d[posed].max() <= 0.05, (ang, d)
    # Engine against engine the keypoints differ by the two libraries' bf16
    # roundings, which RANSAC may turn into another hypothesis on a frame.
    ang, d = _dist(got["ori"], got["pos"], want["ori"], want["pos"])
    assert np.median(ang) <= 0.5 and np.median(d) <= 0.05, (ang, d)
    # The float model shared with the float variant is left as it was.
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


_LINE = re.compile(r"\[(\w+)\] esa=([0-9.]+) ori_err")


def _recorded(monkeypatch, module):
    """Patch ``module.evaluation`` (the one the app imports when it runs) to
    keep the poses its engine returns, two frames a batch (the split's)."""
    real = module.evaluation
    poses = []

    class Recorder:
        def __init__(self, engine):
            self.engine = engine

        def predict(self, images):
            pose, ms = self.engine.predict(images)
            poses.append([x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                          for x in (pose["ori"][:2], pose["pos"][:2])])
            return pose, ms

    monkeypatch.setattr(module, "evaluation",
                        lambda engine, *a, **kw: real(Recorder(engine), *a, **kw))
    return poses


@pytest.mark.parametrize("gate", [False, True])
def test_eval_app_keypoint_flags_match_the_jax_app(tmp_path, split, capsys, monkeypatch, gate):
    from spef_tpu.apps import eval as jax_eval
    from spef_tpu.train import trainer as jtrainer
    from spef_tpu_torch.apps import eval as port_eval
    from spef_tpu_torch.train import trainer

    exp = _experiment(str(tmp_path / "port"), split)
    jexp = _experiment(str(tmp_path / "jax"), split)
    flags = ["--ransac", "--crop-refine", FINE, "--batch-size", "4"]
    flags += ["--border-gate", "0.02"] if gate else []
    got = _recorded(monkeypatch, trainer)
    score, _ = port_eval.main(["--experiment", exp, "--device", "cpu"] + flags)
    printed = {m.group(1): float(m.group(2)) for m in _LINE.finditer(capsys.readouterr().out)}
    want = _recorded(monkeypatch, jtrainer)
    jax_eval.main(["--experiment", jexp] + flags)
    jprinted = {m.group(1): float(m.group(2)) for m in _LINE.finditer(capsys.readouterr().out)}
    assert sorted(printed) == sorted(jprinted) == ["test", "valid"]
    assert all(round(score[p]["esa"][0], 4) == printed[p] for p in printed)
    # The sidecar, the same layout in both packages.
    name = "eval_score_error_ransac" + ("_gated" if gate else "") + "_croprefine"
    mine, theirs = ({k: json.load(open(os.path.join(d, f"{name}.json")))[k] for k in
                     ("scores", "errors")} for d in (exp, jexp))
    for sheet in ("scores", "errors"):
        assert mine[sheet].keys() == theirs[sheet].keys() == {"valid", "test"}
        for phase in mine[sheet]:
            assert mine[sheet][phase].keys() == theirs[sheet][phase].keys()
    # Frame by frame, the two apps' poses.
    (q, t), (jq, jt) = (tuple(np.concatenate(x) for x in zip(*p)) for p in (got, want))
    ang, d = _dist(q, t, jq, jt)
    assert len(ang) == 4 and np.median(ang) <= 0.5 and np.median(d) <= 0.05, (ang, d)
    if not gate:  # the other sidecar names, by flag
        for flags, name in ((["--ransac"], "eval_score_error_ransac"),
                            (["--border-gate", "0.02"], "eval_score_error_gated"),
                            ([], "eval_score_error")):
            port_eval.main(["--experiment", exp, "--device", "cpu", "--batch-size", "4"] + flags)
            assert os.path.isfile(os.path.join(exp, f"{name}.json")), name


def test_serve_crop_refine_on_cpu(experiment, coarse_models, frames, capsys):
    from spef_tpu_torch.apps import serve
    from spef_tpu_torch.engine import SPECropRefine

    args = serve.parse_args(["--experiment", experiment, "--crop-refine", FINE, "--ransac",
                             "--batch", "4", "--selftest-frames", "4", "--device", "cpu"])
    server, img_size = serve.build_server(args)
    assert img_size == (240, 384)
    assert "two-pass crop-refine" in capsys.readouterr().out
    got, _ = server.predict(frames[:3])  # padded to the window of 4
    _, utils = _utils()
    from spef_tpu_torch.engine import load_experiment_model

    want, _ = SPECropRefine(coarse_models[1], load_experiment_model(FINE, device="cpu"), utils,
                            crop_hw=(240, 384), device="cpu").predict(frames[:3])
    for k in ("ori", "pos", "keypoints", "crop_box"):
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    serve.run_selftest(args, server, img_size)
    with pytest.raises(SystemExit, match="int8"):
        serve.build_server(serve.parse_args(
            ["--experiment", experiment, "--crop-refine", FINE, "--int8-graph", "x.pkl",
             "--device", "cpu"]))


# ---------------------------------------------------------------------------
# Keypoints training
# ---------------------------------------------------------------------------

H, W, B = 48, 64, 4


@pytest.mark.parametrize("head_name", ["keypoints_heatmap", "keypoints_regression"])
def test_keypoints_train_steps_match_jax(head_name):
    from spef_tpu.models.heads import KeypointHeatmapHead as JHeatmap
    from spef_tpu.models.heads import KeypointRegressionHead as JRegression
    from spef_tpu.models.mobilenet_v2 import SmallMobile as JSmallMobile
    from spef_tpu.models.wrapper import ModelWrapper as JWrapper
    from spef_tpu.train import step as jstep
    from spef_tpu.train import trainer as jtrainer
    from spef_tpu.train.loss import SPELoss as JLoss
    from spef_tpu.train.optimizer import import_optimizer as jimport_optimizer
    from spef_tpu_torch.models.wrapper import flax_variables, import_model
    from spef_tpu_torch.train import trainer
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state, make_train_step

    jutils, utils = _utils(ransac=False)
    model = import_model("small_mobile", head_name, ori_mode="keypoints", pos_mode="keypoints",
                         img_size=(H, W), device="cpu", compute_dtype=torch.float32, seed=5)
    if head_name == "keypoints_regression":
        model.head.dropout.rate = 0.0
        jhead = JRegression(n_outputs=24, dropout_rate=0.0)
    else:
        jhead = JHeatmap(n_outputs=24, compute_dtype=jnp.float32)
    variables = flax_variables(model)
    module = JWrapper(backbone=JSmallMobile(compute_dtype=jnp.float32), head=jhead)
    tx, _ = jimport_optimizer(0.01, "SGD", 0.9, 1e-4)
    jst = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx, apply_fn=module.apply)
    jloss = JLoss("keypoints", "keypoints")
    jtrain = jax.jit(jstep.make_train_step(jutils, jloss, compute_metrics=False))
    opt, _ = import_optimizer(model.parameters(), 0.01, "SGD", 0.9, 1e-4)
    state = create_train_state(model, opt)
    train = make_train_step(utils, SPELoss("keypoints", "keypoints"), compute_metrics=False)
    jt = jtrainer.Trainer(jutils, jloss)
    pt = trainer.Trainer(utils, SPELoss("keypoints", "keypoints"), device="cpu")
    rs = np.random.RandomState(3)
    for i in range(3):
        images = rs.rand(B, H, W, 3).astype(np.float32)
        q = rs.randn(B, 4).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        pos = np.stack([rs.uniform(-0.5, 0.5, B), rs.uniform(-0.5, 0.5, B),
                        rs.uniform(5, 15, B)], -1).astype(np.float32)
        crop = np.stack([rs.uniform(0.4, 0.6, B), rs.uniform(0.4, 0.6, B),
                         rs.uniform(0.3, 0.6, B)], -1).astype(np.float32)
        want_t = jt._encode_targets(jnp.asarray(q), jnp.asarray(pos), jnp.asarray(crop))
        got_t = pt._encode_targets(torch.from_numpy(q), torch.from_numpy(pos),
                                   torch.from_numpy(crop))
        assert sorted(got_t) == sorted(want_t) == ["keypoints", "ori", "pos"]
        np.testing.assert_allclose(got_t["keypoints"].numpy(), np.asarray(want_t["keypoints"]),
                                   rtol=1e-5, atol=1e-6)
        jst, jm = jtrain(jst, jnp.asarray(images), want_t, jax.random.PRNGKey(i))
        state, m = train(state, torch.from_numpy(images),
                         {k: torch.from_numpy(np.asarray(v).copy()) for k, v in want_t.items()},
                         torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=5e-5)
    # The eval step on a crop batch: the loss in crop-local coordinates, the
    # metrics of the keypoints mapped back to the full frame.
    u8 = (images * 255).astype(np.uint8)
    mask = np.ones(B, np.float32)
    jm = jax.jit(jt._build_eval_step())(jst, jnp.asarray(u8), jnp.asarray(q), jnp.asarray(pos),
                                        jnp.asarray(mask), jnp.asarray(crop))
    m = pt._eval_metrics(state, {"images": u8, "ori": q, "pos": pos, "mask": mask,
                                 "crop": crop})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=5e-5)
    assert all(np.isfinite(float(v)) for v in m.values())


def test_apps_train_takes_a_keypoints_crop_experiment(tmp_path):
    from spef_tpu_torch.apps import train as train_app
    from spef_tpu_torch.data.synthetic import create_crop_dataset, create_synthetic_dataset

    still = create_synthetic_dataset(str(tmp_path / "dspeed" / "still"), n_train=4, n_valid=2,
                                     n_test=1, img_size=(H, W), seed=3)
    crops = create_crop_dataset(still, str(tmp_path / "dspeed" / "crop"), img_size=(H, W),
                                splits=("train", "valid"))
    with open(os.path.join(FINE, "config.yaml")) as f:
        cfg = f.read()
    cfg = (cfg.replace("PATH: /tmp/dspeed_syn/crop2", f"PATH: {crops}")
           .replace("NAME: mobilenet_v2", "NAME: small_mobile")
           .replace("- 240\n  - 384", f"- {H}\n  - {W}").replace("BATCH_SIZE: 64", "BATCH_SIZE: 2"))
    path = tmp_path / "exp_kp_crop.yaml"
    path.write_text(cfg)
    out = train_app.main(["--config", str(path), "--out", str(tmp_path / "out"), "--epochs", "1",
                          "--device", "cpu"])
    (rec,) = out.values()
    assert rec is not None
    folder = next(p for p in (tmp_path / "out").iterdir() if p.is_dir())
    assert (folder / "model" / "parameters.msgpack").is_file()
    shutil.rmtree(tmp_path / "dspeed")
