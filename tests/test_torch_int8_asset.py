"""The committed flagship int8 graph and its generator.

``spef_tpu_torch/assets/flagship_boundary_int8_graph.pkl`` is the flagship
(``exp_dspeed_synth``: MobileNetV2 + URSONet, 240x384, 12 orientation bins a
dimension with unused bins deleted, 10 position bins a dimension) converted
to an int8 graph with the boundary recipe by the JAX package:

  1. the quantized model (``mobilenet_v2_q`` + ``ursonet_q``,
     ``boundary_bit_width()``) takes the trained float weights
     (``quant/warmstart.py::copy_params``);
  2. ``convert_qat_params`` gives the integer graph;
  3. every activation grid is calibrated (``quant/calibrate.py``, 99.99th
     percentile) on 32 synthetic 240x384 frames (``data/synthetic.py``,
     seed 0) in the dataset's channel order, RGB;
  4. the leaves become numpy arrays, pickled.

Regenerate it (about a minute on a CPU) from the repo root with

    JAX_PLATFORMS=cpu python -m tests.test_torch_int8_asset
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
IMG_SIZE = (240, 384)
N_ORI_BINS, N_POS_BINS = 1232, 1000  # 12^3 minus the redundant bins; 10^3
N_CALIB_FRAMES = 32


def _quant_model(img_size):
    """The flagship's quantized twin (boundary recipe).  Parameter shapes do
    not depend on ``img_size``, which only sizes the init forward."""
    from spef_tpu.models.wrapper import import_model
    from spef_tpu.quant.bitwidth import boundary_bit_width

    return import_model("mobilenet_v2_q", "ursonet_q", img_size=img_size,
                        bit_width=boundary_bit_width(), ori_mode="classification",
                        n_ori_bins=N_ORI_BINS, pos_mode="classification",
                        n_pos_bins=N_POS_BINS)


def _synthetic_frames(n, seed):
    """``n`` synthetic frames in the dataset's channel order: ``render_frame``
    gives OpenCV's BGR, the dataset writes it with ``cv2.imwrite`` and reads
    it back as RGB, which is what the model was trained on."""
    from spef_tpu.data.synthetic import generate_positions, render_frame

    rng = np.random.RandomState(seed)
    oris, poss = generate_positions(rng, n)
    return np.stack([render_frame(q, p, img_size=IMG_SIZE, rng=rng)[..., ::-1]
                     for q, p in zip(oris, poss)])


def generate_asset(path=ASSET, seed=0):
    """Build the flagship boundary-recipe int8 graph and pickle it."""
    from spef_tpu.models.wrapper import import_model
    from spef_tpu.quant.calibrate import calibrate_graph
    from spef_tpu.quant.convert import convert_qat_params
    from spef_tpu.quant.warmstart import copy_params

    float_model = import_model(
        "mobilenet_v2", "ursonet", img_size=(32, 48),
        params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
        ori_mode="classification", n_ori_bins=N_ORI_BINS,
        pos_mode="classification", n_pos_bins=N_POS_BINS)
    qmodel = _quant_model((32, 48))
    qmodel.variables = copy_params(float_model.variables, qmodel.variables)
    graph = convert_qat_params(qmodel)
    frames = _synthetic_frames(N_CALIB_FRAMES, seed)
    graph, _ = calibrate_graph(graph, (frames[i:i + 8] for i in range(0, len(frames), 8)))
    graph = jax.tree_util.tree_map(np.asarray, graph)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(graph, f, protocol=4)
    return graph


def _load():
    from spef_tpu_torch.quant.int8_cuda import load_int8_graph

    return load_int8_graph(ASSET)


def test_asset_loads_without_jax():
    code = ("import sys; from spef_tpu_torch.quant.int8_cuda import load_int8_graph; "
            f"g = load_int8_graph({ASSET!r}); "
            "assert len(g['blocks']) == 17, len(g['blocks']); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'spef_tpu') "
            "or m.startswith(('jax.', 'flax.', 'spef_tpu.'))]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_asset_has_convert_shapes_and_recipe():
    """Same keys, shapes and dtypes as ``convert_qat_params`` gives for the
    flagship's quantized model; the boundary recipe's grids are present.
    The reference graph is converted from placeholder variables of the
    quantized model's shapes (``jax.eval_shape`` of its init), which is
    enough for shapes and takes a second instead of a full init."""
    from spef_tpu.models.wrapper import ModelWrapper, SPEModel
    from spef_tpu.quant.bitwidth import boundary_bit_width
    from spef_tpu.quant.convert import convert_qat_params
    from spef_tpu.quant.qmodels import build_quant_backbone, build_quant_head

    bw = boundary_bit_width()
    module = ModelWrapper(
        backbone=build_quant_backbone("mobilenet_v2_q", {"batchnorm": True, "residual": True},
                                      bw, True),
        head=build_quant_head("ursonet_q", N_ORI_BINS, N_POS_BINS, bw, True))
    shapes = jax.eval_shape(lambda rngs, x: module.init(rngs, x, False),
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 48, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), shapes)
    ref = jax.tree_util.tree_map(np.asarray, convert_qat_params(
        SPEModel(module, dict(variables), "mobilenet_v2_q", "ursonet_q", bw)))
    got = _load()
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    for (path, r), (_, g) in zip(ref_leaves, got_leaves):
        if np.ndim(r) > 0:
            assert g.shape == r.shape and g.dtype == r.dtype, (path, g.shape, r.shape)
    assert got["stem"]["act_qmax"] == 255.0 and got["head_conv"]["act_qmax"] == 255.0
    for blk in got["blocks"]:
        assert "act_step" not in blk["depthwise"]  # boundary recipe: real interiors
        assert "act_step" not in blk.get("expand", {})
    assert got["head"]["ori_w_int"].shape == (1280, N_ORI_BINS)
    assert got["head"]["pos_w_int"].shape == (1280, N_POS_BINS)


def _pose(outputs):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA

    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=12,
                            pos_mode="classification", n_pos_bins_per_dim=10, device="cpu")
    raw = {"ori_soft": torch.tensor(np.asarray(outputs[0])),
           "pos_soft": torch.tensor(np.asarray(outputs[1]))}
    return utils.decode(utils.last_activ(raw))


def _gap(a, b):
    """(orientation angle in degrees, up to quaternion sign; position m)."""
    dot = min(1.0, abs(float((a["ori"] * b["ori"]).sum())))
    return 2.0 * np.degrees(np.arccos(dot)), float(torch.linalg.vector_norm(a["pos"] - b["pos"]))


def test_port_plain_forward_on_asset_matches_jax_executors():
    """The port's plain int8 forward on the asset, at batch 1 on a synthetic
    frame, against JAX's Pallas executor (interpret mode) and its deployed
    executor ``int8_carry``.

    Not bit-exact at this size: the boundary recipe's real-valued interiors
    sum bf16 products in f32 over K up to 960, in the port's k order and in
    XLA's, so a few block outputs move by one int8 step.  Stated tolerance
    against Pallas: logits within 0.3, orientation within 2 degrees,
    position within 0.1 m.  ``int8_carry`` rounds differently again (it sums
    integer pixels in the stem and folds 1/255 into the multiplier), and on
    this PTQ-calibrated graph the PDFs are flat (max probability ~3%), so
    the JAX executors already disagree by several degrees among themselves.
    Stated tolerance against carry: no farther from it than JAX's Pallas
    executor is, plus the Pallas tolerance."""
    from jax.experimental.pallas import tpu as pltpu

    from spef_tpu.quant.int8_carry import build_int8_carry_forward
    from spef_tpu.quant.int8_pallas import build_pallas_forward
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward

    graph = _load()
    frame = _synthetic_frames(1, seed=123)
    got = build_cuda_forward(graph, backend="plain", device="cpu")(torch.from_numpy(frame))
    # Both JAX executors jitted, as they are served (eager runs op by op, 3x slower).
    carry = jax.jit(build_int8_carry_forward(graph))(jnp.asarray(frame))
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.jit(build_pallas_forward(graph, backend="pallas"))(jnp.asarray(frame))
    for g, p in zip(got, pallas):
        assert g.shape == p.shape and torch.isfinite(g).all()
        assert np.abs(g.numpy() - np.asarray(p)).max() < 0.3
    pose_port, pose_pallas, pose_carry = _pose(got), _pose(pallas), _pose(carry)
    ang, dist = _gap(pose_port, pose_pallas)
    assert ang < 2.0 and dist < 0.1, (ang, dist)
    ang_c, dist_c = _gap(pose_port, pose_carry)
    ang_jax, dist_jax = _gap(pose_pallas, pose_carry)
    assert ang_c < ang_jax + 2.0 and dist_c < dist_jax + 0.1, (ang_c, ang_jax, dist_c, dist_jax)


if __name__ == "__main__":
    g = generate_asset()
    print(f"wrote {ASSET} ({os.path.getsize(ASSET) / 2**20:.1f} MiB, "
          f"{len(g['blocks'])} blocks)")
