"""Port parity: the plain K1/K2 of spef_tpu_torch against the JAX kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU (as
tests/test_pallas_ops.py does) and, for the cases the TPU sends to XLA
(stride-2 and float-output depthwise), ``xla_depthwise3x3``.  Inputs come
from numpy seeds.  Int8 outputs must match bit for bit.  Real-valued sums
(bf16 operands) are compared bit for bit on inputs whose f32 partial sums
are exact (multiples of 1/8), so summation order cannot matter; on general
real inputs a stated tolerance covers the order XLA picks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spef_tpu.ops.pallas.int8_ops import (
    int8_depthwise3x3 as jax_dw,
    int8_matmul_requant as jax_mm,
    xla_depthwise3x3,
    xla_matmul_requant,
)
from spef_tpu_torch.ops.int8_ops import (
    int8_depthwise3x3,
    int8_depthwise3x3_plain,
    int8_matmul_requant,
    int8_matmul_requant_plain,
)

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a):
    """float32 numpy values rounded to bf16 (as float32 numpy)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _mm_inputs(seed, m=160, k=64, n=256):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randint(-16, 16, (m, k)).astype(np.int8),
        w=rng.randint(-8, 8, (k, n)).astype(np.int8),
        mult=(rng.rand(n) * 1e-2).astype(np.float32),
        bias=(rng.randn(n) * 0.1).astype(np.float32),
        res=rng.randint(-7, 8, (m, n)).astype(np.int8),
        bits=rng.randint(-128, 128, (m, k)).astype(np.int8),
    )


def _run_mm(x, d, residual=None, **kw):
    with pltpu.force_tpu_interpret_mode():
        want = jax_mm(jnp.asarray(x), jnp.asarray(d["w"]), jnp.asarray(d["mult"]),
                      jnp.asarray(d["bias"]),
                      residual=None if residual is None else jnp.asarray(residual),
                      block_m=64, block_n=128, **kw)
    x_t = _t(x) if x.dtype != np.float32 else _t(x).to(torch.bfloat16)
    got = int8_matmul_requant(x_t, _t(d["w"]), _t(d["mult"]), _t(d["bias"]),
                              residual=None if residual is None else _t(residual), **kw)
    return np.asarray(want), got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()


MM_CASES = {
    "int8_relu": dict(relu=True, out_inv_step=8.0, out_qmax=15.0, out_qmin=0.0),
    "int8_signed_no_relu": dict(relu=False, out_inv_step=4.0, out_qmax=127.0, out_qmin=-128.0),
    "bits_in_bits_out": dict(relu=True, out_inv_step=3.0, out_qmax=255.0, out_qmin=0.0,
                             in_unsigned=True, out_bits=True),
    "residual": dict(relu=False, out_inv_step=4.0, out_qmax=7.0, out_qmin=-8.0,
                     res_ratio=0.75, res_qmax=127.0, res_qmin=-128.0),
}


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_plain_k1_int_inputs_bit_exact(case):
    d = _mm_inputs(0)
    kw = MM_CASES[case]
    x = d["bits"] if kw.get("in_unsigned") else d["x"]
    want, got = _run_mm(x, d, residual=d["res"] if case == "residual" else None, **kw)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_plain_k1_f32_out():
    """f32 output: the JAX interpret kernel is compiled by XLA's CPU backend,
    which contracts ``acc*mult + bias`` into a fused multiply-add; the port
    rounds the product first.  They differ by at most the product's rounding
    (half an ulp, 2^-24 |acc*mult|) plus one rounding of the sum (2^-23 |y|)."""
    d = _mm_inputs(1)
    want, got = _run_mm(d["x"], d, relu=False, out_inv_step=None)
    assert got.dtype == np.float32
    acc = d["x"].astype(np.float64) @ d["w"].astype(np.float64)
    bound = np.abs(acc * d["mult"]) * 2.0 ** -24 + np.abs(want) * 2.0 ** -23
    assert (np.abs(got - want) <= bound).all()


def test_plain_k1_bf16_input_exact_sums():
    """Boundary recipe: bf16 real-valued input (the depthwise output).  On
    multiples of 1/8 every f32 partial sum is exact, so K1's k-order sum
    and XLA's blocked sum agree: int8 out bit for bit."""
    d = _mm_inputs(2, m=96, k=48, n=128)
    rng = np.random.RandomState(3)
    x = (rng.randint(0, 64, (96, 48)) / 8.0).astype(np.float32)
    want, got = _run_mm(x, d, relu=False, out_inv_step=2.0, out_qmax=127.0, out_qmin=-128.0)
    np.testing.assert_array_equal(got, want)


def test_plain_k1_bf16_input_general():
    """General bf16 values: f32 partial sums round, in K1's k order vs
    XLA's order.  Stated tolerance: at most one int8 step, on at most 0.5%
    of the outputs."""
    d = _mm_inputs(4, m=128, k=96, n=128)
    x = _bf16_np((np.random.RandomState(5).rand(128, 96) * 6.0).astype(np.float32))
    want, got = _run_mm(x, d, relu=False, out_inv_step=2.0, out_qmax=127.0, out_qmin=-128.0)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


def test_xla_matmul_requant_truncates_bf16_input():
    """Documents a fault of the JAX reference: ``xla_matmul_requant`` takes
    an int32 dot, which truncates a bf16 real-valued input to integers
    (int8_ops.py:351-352), while the Pallas K1 keeps the bf16 product.  The
    port follows the Pallas kernel."""
    xb = jnp.asarray([[1.5, 2.25]], jnp.bfloat16)
    w = jnp.asarray([[1], [2]], jnp.int8)
    one, zero = jnp.ones((1,), jnp.float32), jnp.zeros((1,), jnp.float32)
    trunc = np.asarray(xla_matmul_requant(xb, w, one, zero, relu=False, out_inv_step=None))
    with pltpu.force_tpu_interpret_mode():
        exact = np.asarray(jax_mm(xb, w, one, zero, relu=False, out_inv_step=None))
    got = int8_matmul_requant(torch.tensor([[1.5, 2.25]], dtype=torch.bfloat16),
                              torch.tensor([[1], [2]], dtype=torch.int8),
                              torch.ones(1), torch.zeros(1), relu=False, out_inv_step=None)
    assert trunc[0, 0] == 5.0  # 1 + 2*2: the fractions were dropped
    assert exact[0, 0] == 6.0 and got.item() == 6.0


def _dw_inputs(seed, b=2, h=12, w=10, c=40):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randint(-64, 64, (b, h, w, c)).astype(np.int8),
        bits=rng.randint(-128, 128, (b, h, w, c)).astype(np.int8),
        w=rng.randint(-8, 8, (3, 3, c)).astype(np.int8),
        mult=(rng.rand(c) * 1e-2).astype(np.float32),
        bias=(rng.randn(c) * 0.05).astype(np.float32),
    )


DW_CASES = {
    # name: (stride, input, out_inv_step, out_qmax, in_unsigned, out_bits, JAX fn)
    "s1_int8": (1, "x", 6.0, 127.0, False, False, "pallas"),
    "s1_bits_in_bits_out": (1, "bits", 2.0, 255.0, True, True, "pallas"),
    "s2_int8": (2, "x", 6.0, 127.0, False, False, "xla"),
    "s2_bits_in_bits_out": (2, "bits", 2.0, 255.0, True, True, "xla"),
    "s1_bf16_out": (1, "x", None, 127.0, False, False, "xla"),
    "s2_bits_in_bf16_out": (2, "bits", None, 127.0, True, False, "xla"),
    "s1_real_in_int8_out": (1, "real", 6.0, 127.0, False, False, "xla"),
    "s2_real_in_bf16_out": (2, "real", None, 127.0, False, False, "xla"),
}


@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_plain_k2_bit_exact(case):
    stride, src, inv, qmax, in_uns, out_bits, ref = DW_CASES[case]
    d = _dw_inputs(7)
    # Real inputs (float handoff) on multiples of 1/8: exact tap sums.
    x = ((d["x"].astype(np.float32) + 64) / 8.0) if src == "real" else d[src]
    in_step = 1.0 if src == "real" else 0.05
    kw = dict(stride=stride, in_step=in_step, out_inv_step=inv, out_qmax=qmax,
              in_unsigned=in_uns, out_bits=out_bits)
    args = (jnp.asarray(d["w"]), jnp.asarray(d["mult"]), jnp.asarray(d["bias"]))
    if ref == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want = jax_dw(jnp.asarray(x), *args, **kw)
    else:
        want = xla_depthwise3x3(jnp.asarray(x), *args, **kw)
    got = int8_depthwise3x3(_t(x), _t(d["w"]), _t(d["mult"]), _t(d["bias"]), **kw)
    want = np.asarray(want.astype(jnp.float32) if inv is None else want)
    got = got.float().numpy() if inv is None else got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_plain_k2_real_input_general():
    """General f32 input (rounded to bf16 by the kernel): tap sums round in
    K2's (dy, dx) order vs XLA's conv order.  Stated tolerance: bf16 output
    within 1 bf16 ulp (2^-7 relative) plus 1e-6 absolute."""
    d = _dw_inputs(8)
    x = (np.random.RandomState(9).rand(*d["x"].shape) * 4.0).astype(np.float32)
    kw = dict(stride=1, in_step=1.0, out_inv_step=None)
    want = np.asarray(xla_depthwise3x3(jnp.asarray(x), jnp.asarray(d["w"]),
                                       jnp.asarray(d["mult"]), jnp.asarray(d["bias"]),
                                       **kw).astype(jnp.float32))
    got = int8_depthwise3x3(_t(x), _t(d["w"]), _t(d["mult"]), _t(d["bias"]), **kw)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    d = _mm_inputs(10, m=8, k=16, n=8)
    n_mm, n_dw = int8_matmul_requant.launches, int8_depthwise3x3.launches
    a = int8_matmul_requant(_t(d["x"]), _t(d["w"]), _t(d["mult"]), _t(d["bias"]),
                            out_inv_step=4.0)
    b = int8_matmul_requant_plain(_t(d["x"]), _t(d["w"]), _t(d["mult"]), _t(d["bias"]),
                                  out_inv_step=4.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dd = _dw_inputs(11, c=8)
    a = int8_depthwise3x3(_t(dd["x"]), _t(dd["w"]), _t(dd["mult"]), _t(dd["bias"]))
    b = int8_depthwise3x3_plain(_t(dd["x"]), _t(dd["w"]), _t(dd["mult"]), _t(dd["bias"]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (int8_matmul_requant.launches, int8_depthwise3x3.launches) == (n_mm, n_dw)
