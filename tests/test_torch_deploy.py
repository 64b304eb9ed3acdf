"""Port parity of the deployment artifact: ``spef_tpu_torch.deploy`` /
``apps.export`` (``torch.export``) against ``spef_tpu.deploy`` /
``spef_tpu.apps.export`` (``jax.export``), the counterpart of
``tests/test_deploy.py``.

  * The same weights, ``small_mobile_q`` + ``ursonet_q`` with quantization
    off (float32 in both packages, the port's random init read by JAX),
    exported by both packages for the CPU at a window of 4, 32x48: the two
    artifacts' poses on the same frames within float32 rounding (1e-6 on
    the soft-class PDFs and positions; each quaternion a top eigenvector of
    the decode's matrix, since an untrained model's PDFs are flat).
  * The port's artifact against its live predict: 0 difference on the CPU
    (the same ops on the same inputs); its padding and trimming; its load in
    a fresh process that imports nothing of the port but ``deploy``.
  * A keypoints-mode artifact (``small`` + regression keypoints, EPnP
    decode inside): unit quaternions, finite positions, the live predict's.
  * A JAX artifact refused by name; a hand kernel refusing to be traced.
  * ``apps.export`` float (``qat``) / ``--int8`` / ``--weight-only``
    against JAX's ``apps.export`` on one hand-assembled QAT experiment
    (JAX's QAT model, ``save_model`` and ``convert_qat_params``), each
    artifact pair within the tolerance of its forward's parity
    (``test_torch_qat.py``: QAT logits 5e-3; ``test_torch_int8_carry.py``:
    int8 bit for bit, weight-only 1e-3); the engine's ``exported`` variant.
"""

import json
import os
import pickle
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JaxUtils
from spef_tpu.data.camera import DSPEED_CAMERA as JAX_DSPEED
from spef_tpu.deploy import export_predict as jax_export_predict
from spef_tpu.deploy import load_exported as jax_load_exported
from spef_tpu.engine import build_predict_fn as jax_predict_fn
from spef_tpu.models.wrapper import import_model as jax_import_model
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import DSPEED_CAMERA, SPEED_CAMERA
from spef_tpu_torch.deploy import FORMAT, export_predict, load_exported
from spef_tpu_torch.engine import build_engine_variant, build_predict_fn, discover_engine_variants
from spef_tpu_torch.models.wrapper import import_model, save_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 48)
POSE_TOL = 1e-6  # float32 on both sides: PDFs and positions, absolute and relative
# The decode's quaternion is a top eigenvector of the PDF's scatter matrix
# A = H^T diag(p) H.  An untrained network's PDFs are flat, where A's top
# eigenvalue is (nearly) degenerate and any vector of its eigenspace is the
# answer: the quaternions are held by their quadratic form q^T A q against
# A's top eigenvalue, within float32 rounding.
FORM_RTOL = 1e-5


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


def _np(pose):
    return {k: np.asarray(v) for k, v in pose.items()}


def assert_pose_close(got, want, histogram, tol=POSE_TOL):
    """``got`` and ``want`` within ``tol`` on every output but the
    quaternions, which must both be top eigenvectors of ``want``'s A."""
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k != "ori":
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)
    h = np.asarray(histogram, np.float64)
    a = np.einsum("bn,ni,nj->bij", want["ori_soft"].astype(np.float64), h, h)
    top = np.linalg.eigvalsh(a)[:, -1]
    for q in (got["ori"], want["ori"]):
        q = q.astype(np.float64)
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(np.einsum("bi,bij,bj->b", q, a, q), top, rtol=FORM_RTOL)


@pytest.fixture(scope="module")
def float_setup(tmp_path_factory):
    """(port predict, JAX predict) on the same float32 weights, 4 + 4 bins
    a dimension, the D-SPEED camera."""
    params = tmp_path_factory.mktemp("deploy") / "model"
    spe = SPEUtils.create(DSPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="classification", n_pos_bins_per_dim=4, device="cpu")
    heads = dict(ori_mode="classification", n_ori_bins=spe.orientation.n_bins,
                 pos_mode="classification", n_pos_bins=spe.position.n_bins, img_size=HW,
                 quantization=False)
    model = import_model("small_mobile_q", "ursonet_q", seed=3, device="cpu", **heads)
    save_model(str(params), model)
    jax_spe = JaxUtils.create(JAX_DSPEED, ori_mode="classification", n_ori_bins_per_dim=4,
                              pos_mode="classification", n_pos_bins_per_dim=4)
    jax_model = jax_import_model("small_mobile_q", "ursonet_q",
                                 params_path=str(params / "parameters.msgpack"), **heads)
    return build_predict_fn(model, spe), jax_predict_fn(jax_model, jax_spe), spe


@pytest.fixture(scope="module")
def artifacts(float_setup, tmp_path_factory):
    """The two packages' artifacts of the same pipeline: (port path, port
    meta, JAX path)."""
    fn, jax_fn, _ = float_setup
    root = tmp_path_factory.mktemp("artifacts")
    mine, theirs = str(root / "port.spef"), str(root / "jax.spef")
    meta = export_predict(fn, 4, HW, mine, device="cpu", extra_meta={"variant": "float"})
    jax_export_predict(jax_fn, 4, HW, theirs, platforms=("cpu",))
    return mine, meta, theirs


def test_port_artifact_matches_the_jax_artifact(float_setup, artifacts):
    mine, meta, theirs = artifacts
    assert meta["format"] == FORMAT and meta["platforms"] == ["cpu"] and meta["tf32"] is False
    assert meta["outputs"] == {"ori_soft": [4, 24], "pos_soft": [4, 64], "ori": [4, 4],
                               "pos": [4, 3]}
    with zipfile.ZipFile(mine) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.pt2"]
        assert json.loads(zf.read("meta.json"))["variant"] == "float"
    with zipfile.ZipFile(theirs) as zf:
        jax_meta = json.loads(zf.read("meta.json"))
    shared = set(jax_meta) - {"format", "platforms", "jax_version", "created"}
    assert shared <= set(meta) and {k: meta[k] for k in shared} == {
        k: jax_meta[k] for k in shared}
    images = _frames(4, 0)
    got, ms = load_exported(mine).predict(images)
    assert ms > 0
    want, _ = jax_load_exported(theirs).predict(images)
    assert_pose_close(got, want, float_setup[2].orientation.histogram)


def test_exported_equals_live_and_pads_and_trims(float_setup, artifacts):
    fn = float_setup[0]
    engine = load_exported(artifacts[0])
    assert engine.batch == 4 and engine.device == torch.device("cpu")
    images = _frames(4, 1)
    full, _ = engine.predict(images)
    live = fn(torch.from_numpy(images))
    for k in live:
        torch.testing.assert_close(full[k], live[k], rtol=0, atol=0)
    part, _ = engine.predict(images[:2])
    for k in full:
        assert part[k].shape[0] == 2
        torch.testing.assert_close(part[k], full[k][:2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="exported window"):
        engine.predict(np.zeros((5, *HW, 3), np.uint8))


def test_exported_engine_turns_tf32_off_around_each_call(artifacts):
    """``torch.export`` records no global flag: the engine sets both TF32
    switches off for the call and gives the caller's back after."""
    engine = load_exported(artifacts[0])
    module, seen = engine._module, []

    def spy(x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return module(x)

    engine._module = spy
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        engine.predict(_frames(4, 0))
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_artifact_loads_in_a_fresh_process_without_the_model_code(artifacts):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from spef_tpu_torch.deploy import load_exported\n"
        f"pose, ms = load_exported({artifacts[0]!r}).predict(np.zeros((3, 32, 48, 3), np.uint8))\n"
        "assert pose['ori'].shape == (3, 4) and bool(pose['ori'].isfinite().all())\n"
        "port = sorted(m for m in sys.modules if m.startswith('spef_tpu'))\n"
        "assert port == ['spef_tpu_torch', 'spef_tpu_torch.deploy'], port\n"
        "print('FRESH_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FRESH_OK" in res.stdout


def test_keypoints_mode_roundtrip(tmp_path):
    """The EPnP decode (``eigh``, ``svd``, the LU solve) inside the exported
    program: the live predict's poses, unit quaternions."""
    spe = SPEUtils.create(DSPEED_CAMERA, ori_mode="keypoints", pos_mode="keypoints",
                          device="cpu")
    model = import_model("small", "keypoints_regression", img_size=HW, ori_mode="keypoints",
                         pos_mode="keypoints", n_keypoint_outputs=24, seed=5, device="cpu")
    fn = build_predict_fn(model, spe)
    path = str(tmp_path / "kp.spef")
    export_predict(fn, 4, HW, path, device="cpu")
    images = _frames(4, 0)
    out, _ = load_exported(path).predict(images)
    assert out["ori"].shape == (4, 4) and out["pos"].shape == (4, 3)
    assert bool(torch.isfinite(out["pos"]).all())
    torch.testing.assert_close(out["ori"].norm(dim=-1), torch.ones(4), rtol=0, atol=1e-4)
    live = fn(torch.from_numpy(images))
    for k in live:
        torch.testing.assert_close(out[k], live[k], rtol=0, atol=0)


def test_jax_artifact_and_non_artifacts_are_refused(artifacts, tmp_path):
    with pytest.raises(ValueError, match="JAX artifact"):
        load_exported(artifacts[2])
    (tmp_path / "empty.spef").write_bytes(b"")
    with pytest.raises(ValueError, match="not a .spef artifact"):
        load_exported(str(tmp_path / "empty.spef"))


@pytest.mark.parametrize("kernel", ["int8_matmul_requant", "int8_depthwise3x3", "fused_stem",
                                    "fused_mbconv"])
def test_hand_kernels_refuse_to_be_traced(kernel):
    """Under a tracer the wrappers raise, naming the ROADMAP item, before
    any build or launch (a traced CUDA tensor has no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from spef_tpu_torch.ops import _build, fused_block, int8_ops

    with FakeTensorMode():
        def t(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device="cuda")

        calls = {
            "int8_matmul_requant": lambda: int8_ops.int8_matmul_requant(
                t(8, 16, dtype=torch.int8), t(16, 8, dtype=torch.int8), t(8), t(8)),
            "int8_depthwise3x3": lambda: int8_ops.int8_depthwise3x3(
                t(1, 4, 4, 8, dtype=torch.int8), t(3, 3, 1, 8, dtype=torch.int8), t(8), t(8)),
            "fused_stem": lambda: fused_block.fused_stem(
                t(1, 8, 8, 3, dtype=torch.uint8), t(3, 3, 3, 8, dtype=torch.int8), t(8), t(8)),
            "fused_mbconv": lambda: fused_block.fused_mbconv(t(1, 4, 4, 8, dtype=torch.int8), {}),
        }
        with pytest.raises(_build.KernelTraceError, match="ROADMAP §A, item 10"):
            calls[kernel]()


# ---------------------------------------------------------------------------
# apps.export against JAX's apps.export on one QAT experiment
# ---------------------------------------------------------------------------

VARIANTS = {"qat": [], "int8": ["--int8"], "weight_only": ["--int8", "--weight-only"]}
# What each variant's forward is held to against JAX's (see the docstring).
VARIANT_TOL = {"qat": 5e-3, "int8": POSE_TOL, "weight_only": 1e-3}


@pytest.fixture(scope="module")
def qat_experiment(tmp_path_factory):
    """JAX's hand-assembled experiment of ``tests/test_deploy.py``
    (``small_mobile_q`` + ``ursonet_q`` at 4-bit weights and activations,
    32x48, ``bit_width.json`` and ``int8_graph.pkl``, numpy leaves)."""
    from spef_tpu.config.train_config import default_config, save_config
    from spef_tpu.models.wrapper import save_model as jax_save_model
    from spef_tpu.quant.bitwidth import default_bit_width
    from spef_tpu.quant.convert import convert_qat_params

    exp = tmp_path_factory.mktemp("export_exp") / "exp_export"
    (exp / "model").mkdir(parents=True)
    cfg = default_config()
    cfg.MODEL.BACKBONE.NAME = "small_mobile"
    cfg.MODEL.HEAD.NAME = "ursonet"
    cfg.MODEL.HEAD.ORI = "classification"
    cfg.MODEL.HEAD.POS = "regression"
    cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM = 4
    cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS = True
    cfg.MODEL.QUANTIZATION = True
    cfg.DATA.PATH = "/nonexistent"  # the camera falls back to SPEED's
    cfg.DATA.IMG_SIZE = list(HW)
    save_config(cfg, str(exp / "config.yaml"))
    bw = default_bit_width(n_blocks=2, w=4, a=4, shared=4)
    spe = JaxUtils.create(JAX_DSPEED, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="regression")
    qat = jax_import_model("small_mobile_q", "ursonet_q", img_size=HW, bit_width=bw,
                           quantization=True, ori_mode="classification",
                           n_ori_bins=spe.orientation.n_bins, pos_mode="regression", seed=7)
    jax_save_model(str(exp / "model"), qat, bw)
    graph = jax.tree_util.tree_map(np.asarray, convert_qat_params(qat))
    with open(exp / "int8_graph.pkl", "wb") as f:
        pickle.dump(graph, f)
    return str(exp)


@pytest.fixture(scope="module")
def exported_pairs(qat_experiment, tmp_path_factory):
    """{variant: (port artifact, JAX artifact)} written by the two CLIs."""
    from spef_tpu.apps.export import main as jax_export_main
    from spef_tpu_torch.apps.export import main as export_main

    root = tmp_path_factory.mktemp("cli")
    pairs = {}
    for variant, flags in VARIANTS.items():
        mine, theirs = str(root / f"{variant}.spef"), str(root / f"{variant}_jax.spef")
        meta = export_main(["--experiment", qat_experiment, "--out", mine, "--batch", "2",
                            "--device", "cpu", *flags])
        assert meta["variant"] == variant
        jax_export_main(["--experiment", qat_experiment, "--out", theirs, "--batch", "2",
                         "--platforms", "cpu", *flags])
        pairs[variant] = mine, theirs
    return pairs


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_export_cli_matches_jax(exported_pairs, variant):
    mine, theirs = exported_pairs[variant]
    images = np.random.RandomState(2).randint(0, 256, (2, *HW, 3), np.uint8)
    got, _ = load_exported(mine).predict(images)
    want, _ = jax_load_exported(theirs).predict(images)
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="regression", device="cpu")
    assert_pose_close(got, want, spe.orientation.histogram, tol=VARIANT_TOL[variant])


def test_export_cli_int8_is_the_live_executor_and_agrees_with_qat(qat_experiment,
                                                                  exported_pairs):
    """As ``tests/test_deploy.py``: the int8 artifact reproduces the live
    int8 executor, and the QAT and int8 artifacts, two executors of one
    quantized network, agree to 1e-2 in orientation."""
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.quant.int8_model import build_int8_forward

    images = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, *HW, 3), np.uint8))
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="regression", device="cpu")
    graph = load_int8_graph(os.path.join(qat_experiment, "int8_graph.pkl"))
    live = build_predict_fn(None, spe, forward_fn=build_int8_forward(graph, device="cpu"))(images)
    int8, _ = load_exported(exported_pairs["int8"][0]).predict(images)
    for k in live:
        torch.testing.assert_close(int8[k], live[k], rtol=0, atol=0)
    qat, _ = load_exported(exported_pairs["qat"][0]).predict(images)
    torch.testing.assert_close(int8["ori"], qat["ori"], rtol=1e-2, atol=1e-2)


def test_export_cli_refuses_weight_only_without_int8(qat_experiment):
    from spef_tpu_torch.apps.export import main as export_main

    with pytest.raises(SystemExit):
        export_main(["--experiment", qat_experiment, "--weight-only", "--device", "cpu"])


def test_engine_exported_variant(qat_experiment, exported_pairs, tmp_path):
    """``model.spef`` in an experiment directory is its ``exported``
    variant: ``build_engine_variant`` loads it (the model is not needed)."""
    import shutil

    exp = tmp_path / "exp"
    shutil.copytree(qat_experiment, exp)
    assert "exported" not in discover_engine_variants(str(exp))
    shutil.copy(exported_pairs["int8"][0], exp / "model.spef")
    assert discover_engine_variants(str(exp)) == ["float", "weight-only", "int8-carry",
                                                  "exported"]
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="regression", device="cpu")
    engine = build_engine_variant(str(exp), None, spe, "exported", device="cpu")
    images = np.random.RandomState(4).randint(0, 256, (2, *HW, 3), np.uint8)
    got, ms = engine.predict(images)
    want, _ = load_exported(exported_pairs["int8"][0]).predict(images)
    assert ms > 0 and engine.meta["variant"] == "int8"
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
