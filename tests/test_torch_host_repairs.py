"""Two repairs of the port, held against the JAX package on the CPU.

  * The orientation decode on a singular ``A = H^T diag(p) H``
    (``codec/softclass.py``): a one-hot PDF gives ``A`` of rank 1, a two-hot
    PDF rank 2.  Where the LU meets an exact zero pivot (a one-hot PDF at
    bin 5 of the ``create(8, 3)`` codec) JAX's ``inv`` returns non-finite
    values and the port's ``inv_ex`` the same, where ``torch.linalg.inv``
    raised; elsewhere both return finite values, those of an inverse of a
    singular matrix (rounding noise of order 1e7, not compared).  The
    non-finite values stand in JAX's places for every PDF; which of them
    are NaN and which infinite follows each library's pivoting, and is held
    to JAX's only at bin 5, where the two agree.  The quaternions agree up
    to sign within 1e-5 (the dominant eigenvector of ``A``).  The position
    decode has no inverse.  A batch with one such row decodes every other
    row as before.
  * The weight-only forward (``quant/int8_model.py``): the 1x1 layers as
    bf16 x bf16 products with float32 sums.  On the CPU (no ``mm.dtype``
    kernel) the same bf16 operands are multiplied in float32: the products
    are exact, so ``_mm_f32_out`` is the float64 product of the operands
    rounded once per sum, within float32 summation noise (1e-5 relative).
    The whole forward on ``small_mobile_q`` (8-bit and boundary recipes)
    against JAX's ``build_weight_only_forward``: logits within 1e-3 (bf16
    activations: a float32 sum rounded to bf16 in another order moves a
    value by one bf16 step).
  * What the card's check of the weight-only forward would see of a GEMM
    that rounds its sums to bf16: on the flagship's int8 asset and the 8
    committed JPEG frames, every 1x1 sum, every 3x3 sum, or both rounded to
    bf16 before the epilogue move the logits by more than
    ``chip_smoke.WEIGHT_ONLY_LOGIT_TOL`` from the float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.softclass import OrientationSoftClassification as JOri
from spef_tpu.quant.int8_model import build_weight_only_forward as jbuild_weight_only
from spef_tpu_torch.codec.softclass import OrientationSoftClassification
from spef_tpu_torch.quant.bitwidth import boundary_bit_width, default_bit_width
from spef_tpu_torch.quant.convert import convert_qat_params
from spef_tpu_torch.quant import int8_model
from spef_tpu_torch.quant.int8_model import _mm_f32_out, build_weight_only_forward

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import ASSET, JPEG_REF, WEIGHT_ONLY_LOGIT_TOL  # noqa: E402
from test_torch_qat import qat_pair  # noqa: E402

torch.set_num_threads(1)


def _codecs():
    return JOri.create(8, 3), OrientationSoftClassification.create(8, 3, device="cpu")


def _pdfs(hot_bins):
    n = JOri.create(8, 3).histogram.shape[0]
    p = np.zeros((len(hot_bins), n), np.float32)
    for row, bins in enumerate(hot_bins):
        p[row, bins] = 1.0 / len(bins)
    return p


def _same_non_finite(inv, jinv, tests=(np.isfinite,)):
    for test in tests:
        np.testing.assert_array_equal(test(inv), test(jinv), err_msg=test.__name__)


@pytest.mark.parametrize("bins", [(5,), (0,), (5, 40), (17, 250)])
def test_singular_decode_matches_jax_and_does_not_raise(bins):
    jcodec, codec = _codecs()
    p = _pdfs([bins])
    jq, jinv = (np.asarray(v) for v in jcodec.decode(p))
    q, inv = (v.numpy() for v in codec.decode(torch.from_numpy(p)))
    _same_non_finite(inv, jinv)
    if bins == (5,):  # an exact zero pivot
        assert np.isnan(jinv).any() and np.isinf(jinv).any()
        _same_non_finite(inv, jinv, (np.isnan, np.isposinf, np.isneginf))
    sign = np.sign(np.sum(q * jq, axis=-1, keepdims=True))
    np.testing.assert_allclose(q * sign, jq, rtol=0, atol=1e-5)


def test_one_singular_row_leaves_the_batch_alone():
    jcodec, codec = _codecs()
    rs = np.random.RandomState(0)
    logits = rs.randn(3, jcodec.histogram.shape[0]).astype(np.float32) * 3
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    p[1] = _pdfs([(5,)])[0]
    q, inv = (v.numpy() for v in codec.decode(torch.from_numpy(p)))
    jq, jinv = (np.asarray(v) for v in jcodec.decode(p))
    for row in (0, 2):
        sign = np.sign(np.dot(q[row], jq[row]))
        np.testing.assert_allclose(q[row] * sign, jq[row], rtol=0, atol=1e-5)
        np.testing.assert_allclose(inv[row], jinv[row], rtol=1e-3)
    assert not np.isfinite(inv[1]).all()
    _same_non_finite(inv, jinv)


def test_the_1x1_route_sums_exact_products_in_float32():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 5, 7, 96).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.randint(-127, 128, (96, 24)).astype(np.float32)).to(torch.bfloat16)
    got = _mm_f32_out(x, w)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7, 24)
    want = (x.double().reshape(-1, 96) @ w.double()).reshape(2, 5, 7, 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("recipe", ["w8a8", "boundary"])
def test_weight_only_matches_jax(recipe):
    bw = {"w8a8": default_bit_width(2, w=8, a=8, shared=8),
          "boundary": boundary_bit_width(2)}[recipe]
    model, _, _ = qat_pair("small_mobile_q", bw, seed=4)
    graph = convert_qat_params(model)
    images = np.random.RandomState(12).randint(0, 256, (4, 48, 64, 3), np.uint8)
    want = [np.asarray(o) for o in jax.jit(jbuild_weight_only(graph))(jnp.asarray(images))]
    got = [o.numpy() for o in build_weight_only_forward(graph, device="cpu")(
        torch.from_numpy(images))]
    assert np.abs(want[0]).max() > 0.05
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=recipe)


@pytest.mark.parametrize("rounded", ["1x1", "3x3", "both"])
def test_bf16_rounded_sums_break_the_cards_weight_only_limit(rounded, monkeypatch):
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    graph = load_int8_graph(ASSET)
    x = torch.from_numpy(np.load(JPEG_REF)["decoded"])
    want = build_weight_only_forward(graph, device="cpu")(x)
    mm, conv = int8_model._mm_f32_out, int8_model._conv
    if rounded in ("1x1", "both"):
        monkeypatch.setattr(int8_model, "_mm_f32_out",
                            lambda a, w: mm(a, w).to(torch.bfloat16).float())
    if rounded in ("3x3", "both"):
        monkeypatch.setattr(int8_model, "_conv",
                            lambda a, layer: conv(a, layer).to(torch.bfloat16).float())
    got = build_weight_only_forward(graph, device="cpu")(x)
    d = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert d > WEIGHT_ONLY_LOGIT_TOL, d
