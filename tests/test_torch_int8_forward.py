"""Port parity: ``build_cuda_forward(backend="plain")`` against the JAX
``build_pallas_forward(backend="pallas")`` (Pallas kernels in interpret mode)
on ``small_mobile_q`` at 32x48, for the recipes of tests/test_int8_pallas.py.

The int8 FC logits are ``acc * (pool_step * scale) + bias`` with the integer
accumulator ``acc = p_int . W`` on both sides, the same float ops in the same
order: identical pooled ints ``p_int`` give identical logits, bit for bit.
So the test requires the logits to be equal, and recovers ``acc`` from them
to report which accumulators differ if they are not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spef_tpu.models.wrapper import import_model
from spef_tpu.quant.bitwidth import boundary_bit_width, default_bit_width
from spef_tpu.quant.convert import convert_qat_params
from spef_tpu.quant.int8_pallas import build_pallas_forward
from spef_tpu_torch.quant.int8_cuda import build_cuda_forward

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)


def _w4a4_setup():
    bw = default_bit_width(n_blocks=2, w=4, a=4, shared=4)
    bw["inverted_residual"][0] = [(4, 4), (4, 4), (4,)]
    return bw, 11, 5


def _saturate(model):
    """Shrink every learned activation range so the unsigned 8-bit stem and
    head grids fill q > 127 (the bits-carry regime)."""
    model.variables = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.full_like(v, np.log2(0.25))
        if path and getattr(path[-1], "key", None) == "log2_scale" else v,
        model.variables)


RECIPES = {
    # name: (bit_width, model seed, image seed, saturate)
    "w4a4": (*_w4a4_setup(), False),
    "default_float_handoff": (None, 13, 9, False),
    "boundary": (boundary_bit_width(n_blocks=2), 23, 29, False),
    "boundary_saturated": (boundary_bit_width(n_blocks=2), 31, 37, True),
}


def _graph(recipe):
    bw, seed, img_seed, saturate = RECIPES[recipe]
    model = import_model(
        backbone_name="small_mobile_q", head_name="ursonet_q", img_size=(32, 48),
        bit_width=bw, ori_mode="classification", n_ori_bins=64, pos_mode="regression",
        seed=seed)
    if saturate:
        _saturate(model)
    images = np.random.RandomState(img_seed).randint(0, 256, (4, 32, 48, 3), np.uint8)
    return convert_qat_params(model), images


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_plain_forward_matches_pallas(recipe):
    graph, images = _graph(recipe)
    with pltpu.force_tpu_interpret_mode():
        want = build_pallas_forward(graph, backend="pallas")(jnp.asarray(images))
    np_graph = jax.tree_util.tree_map(np.asarray, graph)
    fwd = build_cuda_forward(np_graph, backend="plain", device="cpu")
    got = fwd(torch.from_numpy(images))
    head = graph["head"]
    for k, (w, g, name) in enumerate(zip(want, got, ("ori", "pos"))):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        scale = np.asarray(head[f"{name}_scale"]) * np.float32(head["pool_step"])
        bias = np.asarray(head[f"{name}_bias"])
        acc_w, acc_g = np.rint((w - bias) / scale), np.rint((g - bias) / scale)
        np.testing.assert_array_equal(acc_g, acc_w, err_msg=f"{recipe}: {name} accumulators")
        np.testing.assert_array_equal(g, w, err_msg=f"{recipe}: {name} logits")


def test_cuda_backend_on_cpu_is_the_plain_backend():
    """backend='cuda' on CPU tensors runs the wrappers' plain versions: the
    same numbers as backend='plain', and no launch counted."""
    from spef_tpu_torch.ops.int8_ops import int8_depthwise3x3, int8_matmul_requant

    graph, images = _graph("boundary")
    np_graph = jax.tree_util.tree_map(np.asarray, graph)
    before = (int8_matmul_requant.launches, int8_depthwise3x3.launches)
    a = build_cuda_forward(np_graph, backend="cuda", device="cpu")(torch.from_numpy(images))
    b = build_cuda_forward(np_graph, backend="plain", device="cpu")(torch.from_numpy(images))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (int8_matmul_requant.launches, int8_depthwise3x3.launches) == before
    fwd = build_cuda_forward(np_graph, backend="cuda", device="cpu")
    # small_mobile: 2 expands + 2 projects + head conv; 2 depthwise.
    assert fwd.launches_per_call == {"int8_matmul_requant": 5, "int8_depthwise3x3": 2}


def test_rejects_unknown_backend():
    graph, _ = _graph("w4a4")
    with pytest.raises(ValueError):
        build_cuda_forward(jax.tree_util.tree_map(np.asarray, graph), backend="xla",
                           device="cpu")
