"""What K1's and K3's tensor-core kernels are promised by the Python around
them, held on the CPU: the packed weight layouts their mma loads read, the
stem's k order, and the tie rule that bounds how K1's bf16 tensor-core sum
may differ from the plain version's k-ordered sum.  No card and no JAX are
needed: the kernels themselves are held against these in
``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from spef_tpu_torch.ops import fused_block, int8_ops
from spef_tpu_torch.ops.fused_block import fused_stem_plain, pack_stem_weights
from spef_tpu_torch.ops.int8_ops import (
    int8_matmul_requant,
    int8_matmul_requant_plain,
    int8_matmul_requant_rounding_input,
    pack_mm_weights,
    tie_mismatches,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (a) weight packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 96])
@pytest.mark.parametrize("k", [16, 24, 27, 32, 96, 160, 960])
def test_pack_mm_weights_round_trip_and_padding(k, n):
    g = torch.Generator().manual_seed(k + n)
    w = torch.randint(-128, 128, (k, n), generator=g).to(torch.int8)
    packed = pack_mm_weights(w)
    assert set(packed) == {"int8", "bf16"}
    kpad = -(-k // 32) * 32
    w8, w16 = packed["int8"], packed["bf16"]
    assert w8.dtype == torch.int8 and w16.dtype == torch.bfloat16
    assert w8.shape == w16.shape == (n, kpad) and w8.is_contiguous() and w16.is_contiguous()
    assert torch.equal(w8[:, :k].t(), w)  # the B operand: (N, K), k innermost
    assert not w8[:, k:].any()  # zeros up to the mma depth
    assert torch.equal(w16.float(), w8.float())  # int8 values are exact in bf16


@pytest.mark.parametrize("cout", [32, 10, 8, 1])
def test_pack_stem_weights_round_trip_and_padding(cout):
    g = torch.Generator().manual_seed(cout)
    w = torch.randint(-128, 128, (3, 3, 3, cout), generator=g).to(torch.int8)
    packed = pack_stem_weights(w)
    coutp = -(-cout // 8) * 8
    assert packed.dtype == torch.int8 and packed.shape == (coutp, 32) and packed.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                assert torch.equal(packed[:cout, dy * 9 + dx * 3 + ci], w[dy, dx, ci])
    assert not packed[:, 27:].any() and not packed[cout:].any()


def _stem_patches(frames: torch.Tensor) -> torch.Tensor:
    """``(B, Ho, Wo, 32)`` float64: for each output pixel the 27 input bytes
    of its 3x3 stride-2 window in k = (dy, dx, ci) order, zeros outside the
    frame and from k = 27: the A rows K3 gathers."""
    b, h, w, _ = frames.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = torch.nn.functional.pad(frames.double(), (0, 0, 1, 1, 1, 1))
    cols = []
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                cols.append(xp[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2, ci])
    patches = torch.stack(cols, dim=-1)
    return torch.nn.functional.pad(patches, (0, 5))


@pytest.mark.parametrize("shape,cout", [((2, 9, 13, 3), 10), ((1, 8, 10, 3), 32),
                                        ((3, 16, 7, 3), 16)])
def test_stem_k_order_gives_the_plain_sums(shape, cout):
    """Patches in (dy, dx, ci) order times the packed weights are the plain
    version's integer sums exactly, odd sizes included, and through its
    epilogue its output."""
    g = torch.Generator().manual_seed(sum(shape) + cout)
    frames = torch.randint(0, 256, shape, generator=g).to(torch.uint8)
    w = torch.randint(-128, 128, (3, 3, 3, cout), generator=g).to(torch.int8)
    sums = _stem_patches(frames) @ pack_stem_weights(w).double().t()
    assert torch.equal(sums[..., :cout], fused_block._stem_sums(frames, w))
    assert not sums[..., cout:].any()
    mult = torch.rand(cout, generator=g) * 2e-2 / 255.0
    bias = torch.randn(cout, generator=g) * 0.05
    q = torch.clamp(torch.round(torch.clamp_min(sums[..., :cout].float() * mult + bias, 0.0)
                                * int8_ops._f32(127 / 0.3)), 0, 127)
    assert torch.equal(fused_stem_plain(frames, w, mult, bias, 127 / 0.3, 127.0),
                       q.to(torch.int8))


# ---------------------------------------------------------------------------
# (b) K1's tie rule for bf16 input
# ---------------------------------------------------------------------------

EPI_KEYS = ("residual", "relu", "out_inv_step", "out_qmax", "out_qmin", "res_ratio", "res_qmax",
            "res_qmin", "out_bits")


def _operands(residual, m=600, k=96, n=24, seed=0):
    """A projection as the boundary recipe runs it: bf16 real values in,
    int8 out, optionally with a residual on the shared grid."""
    g = torch.Generator().manual_seed(seed + k + n)
    x = (torch.rand(m, k, generator=g) * 6).to(torch.bfloat16)
    w = torch.randint(-8, 8, (k, n), generator=g).to(torch.int8)
    mult = torch.rand(n, generator=g) * 4.0 / (k ** 0.5 * 14.0 * 2.0)
    bias = torch.randn(n, generator=g) * 0.05
    kw = dict(relu=False, out_inv_step=12.0, out_qmax=127.0, out_qmin=-128.0)
    if residual:
        kw.update(residual=torch.randint(-100, 100, (m, n), generator=g).to(torch.int8),
                  res_ratio=0.75, res_qmax=127.0, res_qmin=-128.0)
    return x, w, mult, bias, kw


def _reordered(x, w, mult, bias, kw, order):
    """K1's plain version with the bf16 sum taken in another order:
    ``reversed`` (k = K-1..0), ``blocks`` (float32 sums of 16 products, one
    mma's depth, then summed), or with the k-ordered sums moved by one unit
    in the last place, ``ulp_down`` / ``ulp_up``."""
    xf, wf = x.float(), w.float()
    k = x.shape[1]
    acc = torch.zeros(x.shape[0], w.shape[1])
    if order == "reversed":
        for i in reversed(range(k)):
            acc.addcmul_(xf[:, i:i + 1], wf[i])
    elif order == "blocks":
        for k0 in range(0, k, 16):
            part = torch.zeros_like(acc)
            for i in range(k0, min(k0 + 16, k)):
                part.addcmul_(xf[:, i:i + 1], wf[i])
            acc += part
    else:
        for i in range(k):
            acc.addcmul_(xf[:, i:i + 1], wf[i])
        acc = torch.nextafter(acc, torch.full_like(acc, float("-inf" if order == "ulp_down"
                                                             else "inf")))
    full = dict(residual=None, relu=True, out_inv_step=None, out_qmax=127.0, out_qmin=0.0,
                res_ratio=1.0, res_qmax=127.0, res_qmin=-128.0, out_bits=False)
    full.update(kw)
    return int8_ops._mm_epilogue(acc, mult, bias, *(full[name] for name in EPI_KEYS))


@pytest.mark.parametrize("order", ["reversed", "blocks"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain_out", "residual"])
def test_reordered_bf16_sum_differs_only_where_the_tie_rule_admits(residual, order):
    x, w, mult, bias, kw = _operands(residual)
    want = int8_matmul_requant_plain(x, w, mult, bias, **kw)
    got = _reordered(x, w, mult, bias, kw, order)
    v, eps, step = int8_matmul_requant_rounding_input(x, w, mult, bias, **kw)
    assert v.shape == want.shape and v.dtype == torch.float64 and eps.shape == want.shape
    assert step == 1
    mismatches, refused = tie_mismatches(got, want, v, eps, step)
    assert refused == 0
    assert mismatches <= 0.005 * want.numel()
    assert want.unique().numel() > 16
    # The bound is tight enough to mean something: few outputs sit on a tie.
    at_tie = ((v - (torch.floor(v) + 0.5)).abs() <= eps).float().mean()
    assert at_tie < 0.01, float(at_tie)


@pytest.mark.parametrize("order", ["ulp_down", "ulp_up"])
def test_residual_ratio_above_one_admits_two_steps_at_a_tie_and_no_more(order):
    """A residual sum requantized by 1.25: where the projection sits on a tie
    of the shared grid, a sum one unit in the last place away rounds to the
    neighbouring shared-grid value, and 1.25 times that moves the output by
    one step or by two.  The rule admits both there (``step`` 2) and refuses
    three; held to ``step`` 1 it refuses the two-step outputs."""
    g = torch.Generator().manual_seed(7)
    m, k, n = 512, 32, 16
    # Eighths times small integers, a power-of-two multiplier, biases in
    # 64ths: every sum is exact and many projections sit exactly on a tie.
    x = (torch.randint(-16, 16, (m, k), generator=g).float() / 8.0).to(torch.bfloat16)
    w = torch.randint(-4, 4, (k, n), generator=g).to(torch.int8)
    mult = torch.full((n,), 0.125)
    bias = torch.randint(-64, 64, (n,), generator=g).float() / 64.0
    kw = dict(relu=False, out_inv_step=32.0, out_qmax=127.0, out_qmin=-128.0,
              residual=torch.randint(-50, 50, (m, n), generator=g).to(torch.int8),
              res_ratio=1.25, res_qmax=127.0, res_qmin=-128.0)
    want = int8_matmul_requant_plain(x, w, mult, bias, **kw)
    got = _reordered(x, w, mult, bias, kw, order)
    v, eps, step = int8_matmul_requant_rounding_input(x, w, mult, bias, **kw)
    assert step == 2
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(d.max()) == 2 and int((d == 1).sum()) > 0  # both kinds occur
    mismatches, refused = tie_mismatches(got, want, v, eps, step)
    assert mismatches == int((d > 0).sum()) and refused == 0
    assert tie_mismatches(got, want, v, eps, 1) == (mismatches, int((d == 2).sum()))
    # A third step is refused even there.
    flat = got.clone().flatten()
    two = int((d.flatten() == 2).nonzero()[0])
    flat[two] += 1 if got.flatten()[two] > want.flatten()[two] else -1
    assert tie_mismatches(flat.view(got.shape), want, v, eps, step) == (mismatches, 1)
    assert int8_matmul_requant_rounding_input(
        x, w, mult, bias, **{**kw, "res_ratio": 0.75})[2] == 1


def test_rounding_input_is_the_value_the_plain_version_rounds():
    """Away from ties, rounding ``v`` reproduces the plain version's output;
    with a float32 output ``v`` is the output within ``eps``."""
    x, w, mult, bias, kw = _operands(False, seed=3)
    want = int8_matmul_requant_plain(x, w, mult, bias, **kw)
    v, eps, _ = int8_matmul_requant_rounding_input(x, w, mult, bias, **kw)
    clear = (v - (torch.floor(v) + 0.5)).abs() > eps
    assert clear.float().mean() > 0.99
    rounded = torch.clamp(torch.round(v), -128, 127).to(torch.int8)
    assert torch.equal(rounded[clear], want[clear])
    f32_kw = dict(relu=True, out_inv_step=None)
    y = int8_matmul_requant_plain(x, w, mult, bias, **f32_kw)
    v, eps, step = int8_matmul_requant_rounding_input(x, w, mult, bias, **f32_kw)
    assert step == 0 and y.dtype == torch.float32
    assert bool(((y.double() - v).abs() <= eps).all())
    assert bool((eps < 1e-3 * (v.abs() + 1.0)).all())  # and eps is small


@pytest.mark.parametrize("unsigned", [False, True], ids=["int8_in", "bits_in"])
def test_integer_input_sums_are_exact_so_nothing_sits_between(unsigned):
    """Integer inputs: ``v`` is exact, so rounding it gives the plain
    version's output at every element, ties included."""
    g = torch.Generator().manual_seed(11)
    x = torch.randint(-128, 128, (300, 24), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (24, 40), generator=g).to(torch.int8)
    mult = torch.full((40,), 2.0 ** -12)
    bias = torch.randint(-8, 8, (40,), generator=g).float() / 16.0
    kw = dict(relu=True, out_inv_step=4.0, out_qmax=127.0, out_qmin=0.0, in_unsigned=unsigned)
    want = int8_matmul_requant_plain(x, w, mult, bias, **kw)
    v, _, _ = int8_matmul_requant_rounding_input(x, w, mult, bias, **kw)
    assert torch.equal(torch.clamp(torch.round(v), 0, 127).to(torch.int8), want)


def test_wrapper_on_cpu_is_the_plain_version_packed_or_not():
    x, w, mult, bias, kw = _operands(True, m=64)
    before = int8_matmul_requant.launches
    want = int8_matmul_requant_plain(x, w, mult, bias, **kw)
    assert torch.equal(int8_matmul_requant(x, w, mult, bias, **kw), want)
    assert torch.equal(int8_matmul_requant(x, w, mult, bias, packed=pack_mm_weights(w), **kw),
                       want)
    assert int8_matmul_requant.launches == before
