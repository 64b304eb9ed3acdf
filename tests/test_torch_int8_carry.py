"""Port parity: the int8 executors of the converted graph against the JAX
package on the same graph and frames (``small_mobile_q`` at 48x64, QAT
parameters drawn from a seed):

  * ``quant.int8_carry.build_int8_carry_forward`` (plain backend) against
    ``spef_tpu.quant.int8_carry``: logits bit for bit on the integer
    recipes (the default a4, w8a8 with its shifted unsigned grids, and the
    bit-width sweep's families of ``tests/test_int8_sweep_parity.py``),
    whose every sum is an integer.  On the boundary recipes the projections
    sum bf16 real values, in k order here and in XLA's order there, which
    may move an int8 output by one step at a tie: at this size none does,
    and the logits are held bit for bit too;
  * ``quant.int8_model.int8_forward`` against JAX's, bit for bit at this
    size (its stem and depthwise sum real values in float32, in
    oneDNN's order and XLA's);
  * ``build_weight_only_forward``: bf16 activations summed in float32 in
    two orders round to different bf16 values now and then: logits within
    1e-3 (their scale is 0.1 to 1);
  * the plain K1 / K2 in their carry modes (division, shifted emit, the
    ``-zp`` halo at the image borders) against the JAX carry's own
    formula (``_conv_acc``, ``_zp_bias``, ``_requant_int8``) bit for bit,
    and against a float64 evaluation of it except within 1e-4 of a tie.

The int8 FC makes each logit ``acc * scale + bias`` with an integer
``acc = p_int . W``, so equal logits mean equal pooled int8 vectors, and
with them the int8 head-conv output they average.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.quant import int8_carry as jcarry
from spef_tpu.quant.int8_model import build_int8_forward as jbuild_int8
from spef_tpu.quant.int8_model import build_weight_only_forward as jbuild_weight_only
from spef_tpu_torch.ops.int8_ops import (
    int8_depthwise3x3, int8_depthwise3x3_plain, int8_matmul_requant, int8_matmul_requant_plain)
from spef_tpu_torch.quant import bitwidth
from spef_tpu_torch.quant.convert import convert_qat_params
from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
from spef_tpu_torch.quant.int8_model import build_int8_forward, build_weight_only_forward

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qat import qat_pair  # noqa: E402

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)


def _w8a8():
    return bitwidth.default_bit_width(2, w=8, a=8, shared=8)


def _family(name):
    """The 2-block analogues of the bit-width sweep's families."""
    bw = _w8a8()
    if name == "dw_w1":
        bw["inverted_residual"] = [[(8, 8), (1, 8), (8,)] for _ in range(2)]
    elif name == "dw_w2":
        bw["inverted_residual"] = [[(8, 8), (2, 8), (8,)] for _ in range(2)]
    elif name == "expand_a3":
        bw["inverted_residual"] = [[(8, 3), (8, 8), (8,)] for _ in range(2)]
    elif name == "proj_w2":
        bw["inverted_residual"] = [[(8, 8), (8, 8), (2,)] for _ in range(2)]
    elif name == "shared_a3":
        bw["shared_act"] = 3
    elif name == "one_block_mixed":
        bw["inverted_residual"] = [[(8, 3), (1, 8), (2,)], [(8, 8), (8, 8), (8,)]]
    return bw


def _saturated(tree):
    """Every learned range shrunk to 0.25: the unsigned 8-bit grids fill
    q > 127 (the shifted-carry regime)."""
    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    (np.asarray(np.log2(0.25), np.float32) if k == "log2_scale" else v))
                for k, v in t.items()}
    return walk(tree)


RECIPES = {
    "default_a4": None,
    "w8a8": _w8a8(),
    **{f: _family(f) for f in ("dw_w1", "dw_w2", "expand_a3", "proj_w2", "shared_a3",
                               "one_block_mixed")},
    "boundary": bitwidth.boundary_bit_width(2),
    "boundary_saturated": bitwidth.boundary_bit_width(2),
}


def _setup(recipe, seed=3):
    from spef_tpu_torch.models.wrapper import flax_variables, load_flax_variables

    bw = RECIPES[recipe]
    model, _, _ = qat_pair("small_mobile_q", bw, seed=seed)
    if recipe.endswith("saturated"):
        load_flax_variables(model, _saturated(flax_variables(model)))
    graph = convert_qat_params(model)
    images = np.random.RandomState(11).randint(0, 256, (4, 48, 64, 3), np.uint8)
    return graph, images


def _logits(out):
    return [np.asarray(o) if not torch.is_tensor(o) else o.numpy() for o in out]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_carry_plain_backend_matches_jax_carry(recipe):
    graph, images = _setup(recipe)
    want = _logits(jax.jit(jcarry.build_int8_carry_forward(graph))(jnp.asarray(images)))
    fwd = build_int8_carry_forward(graph, backend="plain", device="cpu")
    got = _logits(fwd(torch.from_numpy(images)))
    assert np.abs(want[0]).max() > 0.05  # not a trivial output
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=recipe)
    # float frames in [0, 1] take the same integer path
    got_f = _logits(fwd(torch.from_numpy(images).float() / 255.0))
    for g, w in zip(got_f, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("recipe", ["default_a4", "w8a8", "one_block_mixed", "boundary"])
def test_int8_forward_and_weight_only_match_jax(recipe):
    graph, images = _setup(recipe)
    x = jnp.asarray(images)
    want = _logits(jax.jit(jbuild_int8(graph))(x))
    got = _logits(build_int8_forward(graph, device="cpu")(torch.from_numpy(images)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=recipe)
    want = _logits(jax.jit(jbuild_weight_only(graph))(x))
    got = _logits(build_weight_only_forward(graph, device="cpu")(torch.from_numpy(images)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=recipe)


def test_carry_cuda_backend_on_cpu_is_the_plain_backend():
    graph, images = _setup("w8a8")
    before = (int8_matmul_requant.launches, int8_depthwise3x3.launches)
    fwd = build_int8_carry_forward(graph, backend="cuda", device="cpu")
    a = fwd(torch.from_numpy(images))
    b = build_int8_carry_forward(graph, backend="plain", device="cpu")(torch.from_numpy(images))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (int8_matmul_requant.launches, int8_depthwise3x3.launches) == before
    # small_mobile: 2 expands + 2 projects + the head conv; 2 depthwise.
    assert fwd.launches_per_call == {"int8_matmul_requant": 5, "int8_depthwise3x3": 2}
    assert fwd.takes_uint8
    with pytest.raises(ValueError):
        build_int8_carry_forward(graph, backend="xla", device="cpu")


# ---------------------------------------------------------------------------
# K1 / K2 plain versions in the carry's modes
# ---------------------------------------------------------------------------


def _tie_free(v64, q, qmin, qmax, zp):
    """Where the float64 value ``v64`` (before the round) is not within
    1e-4 of a tie, ``q`` must be its rounded, clipped, shifted grid index."""
    want = np.clip(np.round(v64), qmin, qmax) - zp
    at_tie = np.abs(v64 - (np.floor(v64) + 0.5)) <= 1e-4
    assert np.all((q == want) | at_tie)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("in_zp,out_qmax", [(128, 255.0), (128, 127.0), (0, 255.0)])
@pytest.mark.parametrize("hw", [(5, 7), (8, 9)])
def test_k2_plain_carry_modes_match_the_jax_formula(stride, in_zp, out_qmax, hw):
    """A shifted input padded with ``-zp`` at every image border, the bias
    with the zero point folded in, the requant by division and the shifted
    emit: JAX's carry arithmetic bit for bit."""
    rng = np.random.RandomState(stride * 100 + in_zp + hw[0])
    c = 24
    x = rng.randint(-128, 128, (2, *hw, c)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8)
    entry = {"w_int": w, "mult_core": (rng.rand(c) * 1e-2).astype(np.float32),
             "bias": (rng.randn(c) * 0.3).astype(np.float32)}
    in_step, out_step = 0.05, float(np.float32(0.3 if out_qmax > 127 else 0.6) / 7)
    out_zp = jcarry._zp(out_qmax)
    bias = np.array(jcarry._zp_bias(entry, in_step, float(in_zp)))
    acc = jcarry._conv_acc(jnp.asarray(x), jnp.asarray(w), stride, c, pad_value=-in_zp)
    yf = jnp.maximum(acc * (entry["mult_core"] * in_step) + bias, 0.0)
    want = np.asarray(jcarry._requant_int8(yf, out_step, out_qmax, zp=out_zp))
    args = [torch.from_numpy(a) for a in (x, w.reshape(3, 3, c), entry["mult_core"], bias)]
    got = int8_depthwise3x3_plain(*args, stride=stride, in_step=in_step, out_inv_step=None,
                                  out_step=out_step, out_qmax=out_qmax, out_zp=int(out_zp),
                                  halo=-in_zp).numpy()
    np.testing.assert_array_equal(got, want)
    # float64: the exact integer sum over the -zp halo, the epilogue unrounded
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=-in_zp)
    ho, wo = (hw[0] - 1) // stride + 1, (hw[1] - 1) // stride + 1
    acc64 = sum(xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
                * w[dy, dx, 0].astype(np.float64) for dy in range(3) for dx in range(3))
    v = np.maximum(acc64 * (entry["mult_core"].astype(np.float64) * in_step) + bias, 0) / out_step
    _tie_free(v, got, 0, out_qmax, out_zp)
    assert got.min() < -100 or out_zp == 0  # the shifted grid is used to its bottom


@pytest.mark.parametrize("case", ["expand_shifted", "project", "project_residual_ratio",
                                  "project_residual_same_step"])
def test_k1_plain_carry_modes_match_the_jax_formula(case):
    rng = np.random.RandomState(len(case))
    m, k, n = 300, 48, 40
    in_zp = 128.0 if case == "expand_shifted" else 0.0
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (1, 1, k, n)).astype(np.int8)
    entry = {"w_int": w, "mult_core": (rng.rand(n) * 1e-3).astype(np.float32),
             "bias": (rng.randn(n) * 0.3).astype(np.float32)}
    in_step = 0.07
    bias = np.array(jcarry._zp_bias(entry, in_step, in_zp))
    acc = jcarry._conv_acc(jnp.asarray(x)[None, None], jnp.asarray(w), 1, 1)[0, 0]
    pf = acc * (entry["mult_core"] * in_step) + bias
    mult = torch.from_numpy(entry["mult_core"] * np.float32(in_step))
    args = [torch.from_numpy(x), torch.from_numpy(w[0, 0]), mult, torch.from_numpy(bias)]
    if case == "expand_shifted":
        want = np.asarray(jcarry._requant_int8(jnp.maximum(pf, 0.0), 0.02, 255.0, zp=128.0))
        got = int8_matmul_requant_plain(*args, relu=True, out_inv_step=None, out_step=0.02,
                                        out_qmax=255.0, out_qmin=0.0, out_zp=128)
    elif case == "project":
        want = np.asarray(jcarry._requant_int8(pf, 0.03, 127.0, -128.0))
        got = int8_matmul_requant_plain(*args, relu=False, out_inv_step=None, out_step=0.03,
                                        out_qmax=127.0, out_qmin=-128.0)
    else:
        res = rng.randint(-100, 100, (m, n)).astype(np.int8)
        shared, ratio = 0.04, (0.7 if case.endswith("ratio") else 1.0)
        q = jnp.clip(jnp.round(pf / shared), -128, 127).astype(jnp.int32) + res
        if ratio != 1.0:
            want = np.asarray(jnp.clip(jnp.round(q.astype(jnp.float32) * ratio), -128, 127))
        else:
            want = np.asarray(jnp.clip(q, -128, 127))
        got = int8_matmul_requant_plain(*args, relu=False, out_inv_step=None, out_step=shared,
                                        out_qmax=127.0, out_qmin=-128.0, res_ratio=ratio,
                                        res_qmax=127.0, res_qmin=-128.0,
                                        residual=torch.from_numpy(res))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int8))
    # float64: the exact integer sum, the epilogue unrounded
    acc64 = x.astype(np.float64) @ w[0, 0].astype(np.float64)
    pf64 = acc64 * (entry["mult_core"].astype(np.float64) * in_step) + bias
    if case == "expand_shifted":
        _tie_free(np.maximum(pf64, 0) / 0.02, got.numpy(), 0, 255, 128)
    elif case == "project":
        _tie_free(pf64 / 0.03, got.numpy(), -128, 127, 0)


def test_parity_harness_is_the_jax_one():
    """``compare_tensors`` gives JAX's numbers (the same numpy), and
    ``predict_and_compare`` holds the QAT forward against the carry."""
    from spef_tpu.quant.parity import compare_tensors as jcompare
    from spef_tpu_torch.models.wrapper import flax_variables, load_flax_variables
    from spef_tpu_torch.quant.parity import compare_tensors, predict_and_compare

    rng = np.random.RandomState(2)
    a, b = rng.randn(50).astype(np.float32), rng.randn(50).astype(np.float32)
    b[:10] = a[:10]
    assert compare_tensors(torch.from_numpy(a), b) == jcompare(a, b)
    model, _, variables = qat_pair("small_mobile_q", _w8a8())
    load_flax_variables(model, variables)
    graph = convert_qat_params(model)
    images = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 48, 64, 3),
                                                               np.uint8))
    report = predict_and_compare(model, build_int8_carry_forward(graph, device="cpu"), images)
    assert report["ori_raw"]["cosine"] > 0.999 and report["pos_raw"]["cosine"] > 0.999
    assert "pose" not in report


def test_carry_options_are_checked():
    x = torch.zeros(2, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(3, 3, 8, dtype=torch.int8)
    v = torch.zeros(8)
    for kw in (dict(out_step=0.1),  # out_inv_step defaults to 1.0: both given
               dict(out_inv_step=None, out_step=0.1, out_zp=64),
               dict(out_inv_step=2.0, out_bits=True, out_zp=128)):
        with pytest.raises(ValueError):
            int8_depthwise3x3(x, w, v, v, **kw)
    with pytest.raises(ValueError):  # a halo needs int8 values in
        int8_depthwise3x3(x.float(), w, v, v, out_inv_step=None, halo=-128)
    with pytest.raises(ValueError):
        int8_matmul_requant(torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 4,
                            dtype=torch.int8), v[:4], v[:4], out_inv_step=1.0, out_step=1.0)
