"""Port parity: ``build_fused_forward(backend="plain")`` of the port against
the JAX deployment executor ``spef_tpu.quant.int8_fused.build_fused_forward``
(Pallas kernels in interpret mode on the CPU), on ``small_mobile_q`` and on
one frame of the committed flagship graph.

The JAX side gets an explicit ``plan`` (every node fused), which keeps the
TPU tuning table out of it.  At 48x64 both blocks pass the TPU kernel's shape
limits and run ``fused_mbconv``; at 32x48 the stride-2 block (width 24 -> 12)
goes to ``_xla_block`` on the JAX side, while the port runs K4 everywhere.

The int8 FC logits are ``acc * (pool_step * scale) + bias`` with the integer
accumulator ``acc = p_int . W`` on both sides, the same float ops in the same
order: identical pooled integers ``p_int`` give identical logits, bit for
bit.  Recipes with every interior on a grid must give equal logits.  Under
the boundary recipes (float32 hidden tensor, real-valued depthwise output)
the JAX interpret kernel fuses multiply-adds and sums in XLA's order, so a
block output can move by one int8 step and a pooled integer can flip; the
test recovers the pooled integers' differences from the logits (the FC
weights of the small head are 64 x 67, of full row rank) and states how many
may differ.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.models.wrapper import import_model
from spef_tpu.quant.bitwidth import boundary_bit_width, default_bit_width
from spef_tpu.quant.convert import convert_qat_params
from spef_tpu.quant.int8_fused import build_fused_forward as jax_fused_forward
from spef_tpu_torch.ops.fused_block import fused_mbconv, fused_stem
from spef_tpu_torch.ops.int8_ops import int8_matmul_requant
from spef_tpu_torch.quant.int8_fused import build_fused_forward
from spef_tpu_torch.quant.int8_graph import load_int8_graph

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")


def _w4a4():
    bw = default_bit_width(n_blocks=2, w=4, a=4, shared=4)
    bw["inverted_residual"][0] = [(4, 4), (4, 4), (4,)]
    return bw


def _family(name):
    """The bit-width families of tests/test_int8_sweep_parity.py
    (``_fused_family``): an a4 base, and 'w8a8' with wide unsigned grids."""
    if name == "w8a8":
        bw = default_bit_width(n_blocks=2, w=8, a=8, shared=8)
        bw["inverted_residual"] = [[(8, 8), (8, 8), (8,)] for _ in range(2)]
        return bw
    bw = default_bit_width(n_blocks=2, w=8, a=4, shared=4)
    bw["inverted_residual"] = {
        "dw_w1": [[(8, 4), (1, 4), (8,)] for _ in range(2)],
        "expand_a3": [[(8, 3), (8, 4), (8,)] for _ in range(2)],
        "one_block_mixed": [[(8, 3), (1, 4), (2,)], [(8, 4), (8, 4), (8,)]],
    }[name]
    return bw


def _saturate(model):
    """Shrink every learned activation range so the unsigned 8-bit stem and
    head grids fill q > 127 (the bits-carry regime)."""
    model.variables = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.full_like(v, np.log2(0.25))
        if path and getattr(path[-1], "key", None) == "log2_scale" else v,
        model.variables)


CONFIGS = {
    # name: (bit widths, model seed, image seed, saturate, pooled integers that may differ)
    "w4a4": (_w4a4(), 11, 5, False, 0),
    "default_float_handoff": (None, 13, 9, False, 0),
    "boundary": (boundary_bit_width(n_blocks=2), 23, 29, False, 2),
    "boundary_saturated": (boundary_bit_width(n_blocks=2), 31, 37, True, 2),
    "family_dw_w1": (_family("dw_w1"), 7, 11, False, 0),
    "family_expand_a3": (_family("expand_a3"), 7, 11, False, 0),
    "family_one_block_mixed": (_family("one_block_mixed"), 7, 11, False, 0),
    "family_w8a8": (_family("w8a8"), 7, 11, False, 0),
}


def _setup(config, hw):
    bw, seed, img_seed, saturate, flips = CONFIGS[config]
    model = import_model(
        backbone_name="small_mobile_q", head_name="ursonet_q", img_size=hw, bit_width=bw,
        ori_mode="classification", n_ori_bins=64, pos_mode="regression", seed=seed)
    if saturate:
        _saturate(model)
    graph = convert_qat_params(model) if bw is None else convert_qat_params(model, bw)
    images = np.random.RandomState(img_seed).randint(0, 256, (4, *hw, 3), np.uint8)
    return graph, images, flips


def _both(graph, images):
    plan = {"stem": "fused", "blocks": ["fused"] * len(graph["blocks"])}
    want = jax_fused_forward(graph, interpret=True, plan=plan)(jnp.asarray(images))
    np_graph = jax.tree_util.tree_map(np.asarray, graph)
    got = build_fused_forward(np_graph, backend="plain", device="cpu")(torch.from_numpy(images))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _pooled_diff(graph, want, got):
    """The difference of the two sides' pooled integers, (B, C), recovered
    from the logits: ``acc = rint((logit - bias) / scale)`` is the integer FC
    accumulator, and ``d_acc = d_p . [W_ori | W_pos]`` has one solution when
    the stacked weights have full row rank (checked)."""
    head = graph["head"]
    d_acc, weights = [], []
    for w, g, name in zip(want, got, ("ori", "pos")):
        assert g.shape == w.shape and g.dtype == np.float32
        scale = np.asarray(head[f"{name}_scale"]) * np.float32(head["pool_step"])
        bias = np.asarray(head[f"{name}_bias"])
        d_acc.append(np.rint((g - bias) / scale) - np.rint((w - bias) / scale))
        weights.append(np.asarray(head[f"{name}_w_int"], np.float64))
    d_acc, weights = np.concatenate(d_acc, 1), np.concatenate(weights, 1)
    assert np.linalg.matrix_rank(weights) == weights.shape[0]
    d_p = np.rint(np.linalg.lstsq(weights.T, d_acc.T, rcond=None)[0].T)
    np.testing.assert_array_equal(d_p @ weights, d_acc)
    return d_p


def _check(graph, want, got, flips, label):
    d_p = _pooled_diff(graph, want, got)
    if flips == 0:
        assert not d_p.any(), f"{label}: pooled integers differ at {np.argwhere(d_p)}"
        for w, g, name in zip(want, got, ("ori", "pos")):
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {name} logits")
    else:
        assert np.abs(d_p).max() <= 1 and np.count_nonzero(d_p) <= flips, (label, d_p)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_fused_forward_matches_jax_fused_kernels(config):
    """48x64: every node runs the fused Pallas kernels on the JAX side.
    Integer recipes: logits bit for bit.  Boundary recipes: at most 2 of the
    batch's 4 x 64 pooled integers differ, by one."""
    graph, images, flips = _setup(config, (48, 64))
    want, got = _both(graph, images)
    _check(graph, want, got, flips, config)


@pytest.mark.parametrize("config", ["w4a4", "boundary"])
def test_plain_fused_forward_where_jax_falls_back_to_xla(config):
    """32x48: the JAX executor sends the stride-2 block (width 24 -> 12) to
    ``_xla_block``; the port runs K4.  Integer recipe: bit for bit.  Boundary
    recipe: ``_xla_block`` rounds the hidden tensor to bf16, so at most 2 of
    the 4 x 64 pooled integers differ, by one."""
    graph, images, flips = _setup(config, (32, 48))
    want, got = _both(graph, images)
    _check(graph, want, got, flips, config)


def test_cuda_backend_on_cpu_is_the_plain_backend():
    """backend='cuda' on CPU tensors runs the wrappers' plain versions: the
    same numbers as backend='plain', and no launch counted."""
    graph, images, _ = _setup("boundary", (32, 48))
    np_graph = jax.tree_util.tree_map(np.asarray, graph)
    counters = (fused_stem, fused_mbconv, int8_matmul_requant)
    before = [f.launches for f in counters]
    fwd = build_fused_forward(np_graph, backend="cuda", device="cpu")
    a = fwd(torch.from_numpy(images))
    b = build_fused_forward(np_graph, backend="plain", device="cpu")(torch.from_numpy(images))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    assert fwd.launches_per_call == {"fused_stem": 1, "fused_mbconv": 2,
                                     "int8_matmul_requant": 1}
    assert fwd.takes_uint8


def test_rejects_unknown_backend_and_float_frames():
    graph, images, _ = _setup("w4a4", (32, 48))
    np_graph = jax.tree_util.tree_map(np.asarray, graph)
    with pytest.raises(ValueError):
        build_fused_forward(np_graph, backend="xla", device="cpu")
    fwd = build_fused_forward(np_graph, backend="plain", device="cpu")
    with pytest.raises(ValueError):
        fwd(torch.from_numpy(images).float() / 255.0)


def test_plain_fused_forward_on_asset_matches_jax_fused_executor():
    """The committed flagship graph (boundary recipe, 17 blocks), one
    synthetic 240x384 frame, all 19 nodes: the port's plain fused forward
    against the JAX fused executor in interpret mode (about 11 s, jitted).

    Not bit-exact at this size: the boundary recipe's float32 hidden tensors
    and real-valued depthwise outputs meet XLA's fused multiply-adds and its
    summation order over K up to 960, so a few block outputs move by one
    int8 step.  Stated tolerance, as for the layer executor in
    tests/test_torch_int8_asset.py: logits within 0.3, orientation within
    2 degrees, position within 0.1 m (seen: 0.08, 0.17 degrees, 0.02 m)."""
    from test_torch_int8_asset import _gap, _pose, _synthetic_frames

    graph = load_int8_graph(ASSET)
    frame = _synthetic_frames(1, seed=123)
    got = build_fused_forward(graph, backend="plain", device="cpu")(torch.from_numpy(frame))
    plan = {"stem": "fused", "blocks": ["fused"] * len(graph["blocks"])}
    want = jax.jit(jax_fused_forward(graph, interpret=True, plan=plan))(jnp.asarray(frame))
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert np.abs(g.numpy() - np.asarray(w)).max() < 0.3
    ang, dist = _gap(_pose(got), _pose(want))
    assert ang < 2.0 and dist < 0.1, (ang, dist)
