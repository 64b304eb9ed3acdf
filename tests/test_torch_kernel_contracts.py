"""What K4's kernel is promised by the Python around it, held on the CPU:
the weight layouts its tensor-core loads read, the tie rule that bounds how
its tensor-core projection may differ from the plain version's k-ordered
sum, and the output tile its launcher is handed.  No card is needed: the
kernel itself is held against these in ``tests/test_torch_cuda.py``.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import random_mbconv_operands  # noqa: E402 - the repo root's smoke script
from spef_tpu_torch.ops import fused_block  # noqa: E402
from spef_tpu_torch.ops.fused_block import (  # noqa: E402
    MBCONV_SMEM_MAX,
    choose_mbconv_tile,
    fused_mbconv_plain,
    fused_mbconv_rounding_input,
    mbconv_smem_bytes,
    mbconv_warp_grid,
    pack_mbconv_weights,
    tie_mismatches,
    unpack_mbconv_weights,
)


# ---------------------------------------------------------------------------
# (a) weight packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dw_grid", [False, True])
@pytest.mark.parametrize("cin,ch,cout", [(16, 96, 24), (24, 144, 24), (32, 192, 64),
                                         (160, 960, 320), (6, 10, 7)])
def test_pack_mbconv_weights_round_trip_and_padding(cin, ch, cout, dw_grid):
    g = torch.Generator().manual_seed(cin + ch + cout)
    wts, _ = random_mbconv_operands(g, cin, ch, cout)
    wts["w1"] = torch.randint(-128, 128, (cin, ch), generator=g).to(torch.int8)
    wts["w3"] = torch.randint(-128, 128, (ch, cout), generator=g).to(torch.int8)
    packed = pack_mbconv_weights(wts, dw_grid=dw_grid)
    for name, t in wts.items():  # the unpacked operands stay, for the plain version
        assert packed[name] is t
    # Beside them only what the kernel reads: one blob a chunk, and m3 / b3.
    assert set(packed) - set(wts) == {"wblob", "aux3"}
    back = unpack_mbconv_weights(packed)
    assert torch.equal(back["w1"], wts["w1"]) and torch.equal(back["w3"], wts["w3"])

    kpad, chp, coutp = -(-cin // 32) * 32, -(-ch // 32) * 32, -(-cout // 8) * 8
    lay = fused_block._mbconv_layouts(wts, dw_grid)  # the blob's pieces before they are joined
    w1p, w3p = lay["w1p"], lay["w3p"]
    assert w1p.dtype == torch.int8 and w1p.shape == (chp, kpad) and w1p.is_contiguous()
    assert not w1p[ch:].any() and not w1p[:, cin:].any()  # zeros up to the mma depth
    assert w3p.dtype == (torch.int8 if dw_grid else torch.bfloat16)
    assert w3p.shape == (chp // 32, coutp, 32) and w3p.is_contiguous()
    # bf16 holds every int8 value exactly; k is innermost, chunk by chunk.
    full = w3p.float().permute(0, 2, 1).reshape(chp, coutp)
    assert torch.equal(full[:ch, :cout], wts["w3"].float())
    assert not full[ch:].any() and not full[:, cout:].any()
    # The small operands, a chunk: m1, b1, m2, b2 and the nine taps, zeros past Ch.
    aux = lay["aux"].permute(1, 0, 2).reshape(13, chp)
    assert lay["aux"].shape == (chp // 32, 13, 32) and lay["aux"].is_contiguous()
    for row, name in enumerate(("m1", "b1", "m2", "b2")):
        assert torch.equal(aux[row, :ch], wts[name])
    assert torch.equal(aux[4:, :ch], wts["w2"].reshape(9, ch).float())
    assert not aux[:, ch:].any()
    assert torch.equal(packed["aux3"][0, :cout], wts["m3"])
    assert torch.equal(packed["aux3"][1, :cout], wts["b3"])
    assert packed["aux3"].shape == (2, coutp) and not packed["aux3"][:, cout:].any()
    # What the kernel copies, a chunk: the w1 rows, the w3 rows (each with the
    # 16 bytes of padding its shared-memory row has) and the small operands.
    blob = packed["wblob"]
    w3_row = 32 * w3p.element_size()
    sizes = [32 * (kpad + 16), coutp * (w3_row + 16), 13 * 32 * 4]
    assert blob.dtype == torch.uint8 and blob.shape == (chp // 32, sum(sizes))
    assert blob.is_contiguous() and sum(sizes) % 16 == 0
    b1, b3, baux = blob.split(sizes, dim=1)
    b1 = b1.reshape(chp // 32, 32, kpad + 16)
    assert torch.equal(b1[..., :kpad].reshape(chp, kpad).view(torch.int8), w1p)
    assert not b1[..., kpad:].any()
    b3 = b3.reshape(chp // 32, coutp, w3_row + 16)
    assert torch.equal(b3[..., :w3_row].contiguous().view(w3p.dtype), w3p)
    assert not b3[..., w3_row:].any()
    assert torch.equal(baux.contiguous().view(torch.float32).view(chp // 32, 13, 32),
                       lay["aux"])


def test_pack_mbconv_weights_without_expand():
    wts, _ = random_mbconv_operands(torch.Generator().manual_seed(1), 32, 32, 16, expand=False)
    packed = pack_mbconv_weights(wts)
    lay = fused_block._mbconv_layouts(wts, False)
    assert "w1p" not in lay and lay["w3p"].shape == (1, 16, 32)
    assert packed["wblob"].shape == (1, 16 * (64 + 16) + 13 * 32 * 4)  # no w1 rows
    assert torch.equal(unpack_mbconv_weights(packed)["w3"], wts["w3"])


# ---------------------------------------------------------------------------
# (b) the tie rule
# ---------------------------------------------------------------------------

TIE_CASES = {
    # name: (x shape, Ch, Cout, stride, random_mbconv_operands kwargs)
    "s1_plain_out": ((2, 9, 11, 16), 96, 24, 1, dict()),
    "s2_plain_out": ((2, 9, 11, 16), 96, 24, 2, dict()),
    "s1_residual_ratio": ((2, 8, 8, 24), 144, 24, 1, dict(residual="ratio")),
    "s1_residual_same_step": ((2, 8, 8, 24), 144, 24, 1, dict(residual="same")),
    "no_expand": ((2, 8, 8, 32), 32, 16, 1, dict(expand=False)),
}


def _case(name):
    shape, ch, cout, stride, opts = TIE_CASES[name]
    g = torch.Generator().manual_seed(sum(shape) + ch)
    x = torch.randint(-64, 64, shape, generator=g).to(torch.int8)
    wts, kw = random_mbconv_operands(g, shape[-1], ch, cout, **opts)
    kw.update(stride=stride)
    return x, wts, kw


def _reordered(x, wts, kw, order):
    """K4's plain version with the projection summed in another order:
    ``reversed`` (k = K-1..0) or ``blocks`` (float32 sums of 16, then
    summed); or with the k-ordered sums moved by one unit in the last place,
    ``ulp_down`` / ``ulp_up``, the least a differently rounded sum differs."""
    dw_keys = ("stride", "in_unsigned", "inv_h", "qmax_h", "inv_d", "qmax_d")
    out_keys = ("use_residual", "inv_sh", "qmax_sh", "ratio_out", "qmin_o", "qmax_o")
    full = dict(in_unsigned=False, inv_h=None, qmax_h=127.0, inv_d=None, qmax_d=127.0,
                qmin_o=-128.0, qmax_o=127.0)
    full.update(kw)
    yb = fused_block._mbconv_depthwise(x, wts, *(full[k] for k in dw_keys))
    w3f = wts["w3"].float()
    ch, cout = w3f.shape
    p = torch.zeros(yb.shape[0], cout)
    if order == "reversed":
        for k in reversed(range(ch)):
            p.addcmul_(yb[:, k:k + 1], w3f[k])
    elif order in ("ulp_down", "ulp_up"):
        for k in range(ch):
            p.addcmul_(yb[:, k:k + 1], w3f[k])
        p = torch.nextafter(p, torch.full_like(p, float("-inf" if order == "ulp_down" else "inf")))
    else:
        for k0 in range(0, ch, 16):
            part = torch.zeros_like(p)
            for k in range(k0, min(k0 + 16, ch)):
                part.addcmul_(yb[:, k:k + 1], w3f[k])
            p += part
    out = fused_block._mbconv_finish(p, x, wts, *(full[k] for k in out_keys))
    return out.view(fused_mbconv_plain(x, wts, **kw).shape)


@pytest.mark.parametrize("order", ["reversed", "blocks"])
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_reordered_projection_differs_only_where_the_tie_rule_admits(case, order):
    x, wts, kw = _case(case)
    want = fused_mbconv_plain(x, wts, **kw)
    got = _reordered(x, wts, kw, order)
    v, eps, step = fused_mbconv_rounding_input(x, wts, **kw)
    assert v.shape == want.shape and v.dtype == torch.float64 and eps.shape == want.shape
    assert step == 1
    mismatches, refused = tie_mismatches(got, want, v, eps, step)
    assert refused == 0
    assert mismatches <= 0.005 * want.numel()
    assert want.unique().numel() > 16
    # The bound is tight enough to mean something: few outputs sit on a tie.
    at_tie = ((v - (torch.floor(v) + 0.5)).abs() <= eps).float().mean()
    assert at_tie < 0.01, float(at_tie)


def test_rounding_input_is_the_value_the_plain_version_rounds():
    """Away from ties, rounding ``v`` reproduces the plain version's output."""
    x, wts, kw = _case("s1_plain_out")
    want = fused_mbconv_plain(x, wts, **kw)
    v, eps, _ = fused_mbconv_rounding_input(x, wts, **kw)
    clear = (v - (torch.floor(v) + 0.5)).abs() > eps
    assert clear.float().mean() > 0.99
    rounded = torch.clamp(torch.round(v), -128, 127).to(torch.int8)
    assert torch.equal(rounded[clear], want[clear])


def test_tie_rule_refuses_two_steps_and_one_step_away_from_a_tie():
    x, wts, kw = _case("s1_plain_out")
    want = fused_mbconv_plain(x, wts, **kw)
    v, eps, step = fused_mbconv_rounding_input(x, wts, **kw)
    assert tie_mismatches(want, want, v, eps, step) == (0, 0)
    flat_v = v.flatten()
    inner = (want.flatten().abs() < 100).nonzero().flatten()  # room to move without wrapping
    dist = (flat_v - (torch.floor(flat_v) + 0.5)).abs()
    far = inner[dist[inner].argmax()]   # the output furthest from a tie
    near = inner[dist[inner].argmin()]  # the one closest to it

    def moved(index, by):
        got = want.clone().flatten()
        got[index] += by
        return tie_mismatches(got.view(want.shape), want, v, eps, step)

    assert moved(far, 1) == (1, 1)   # one step, but nowhere near a tie
    assert moved(far, 2) == (1, 1)
    assert moved(near, 2) == (1, 1)  # two steps are refused even at a tie
    # At an exact tie (eps widened to reach it) one step is admitted.
    wide = eps.clone().flatten()
    wide[near] = dist[near]
    got = want.clone().flatten()
    got[near] += 1
    assert tie_mismatches(got.view(want.shape), want, v, wide.view(v.shape), step) == (1, 0)


def test_rounding_input_step_follows_the_residual_ratio():
    x, wts, kw = _case("s1_residual_ratio")
    assert fused_mbconv_rounding_input(x, wts, **kw)[2] == 1  # ratio 0.8
    assert fused_mbconv_rounding_input(x, wts, **{**kw, "ratio_out": 1.25})[2] == 2
    assert fused_mbconv_rounding_input(x, wts, **{**kw, "ratio_out": None})[2] == 1


@pytest.mark.parametrize("order", ["ulp_down", "ulp_up"])
def test_residual_ratio_above_one_admits_two_steps_at_a_tie_and_no_more(order):
    """A residual sum requantized by 1.25: where the projection sits on a
    tie of the shared grid, a sum one unit in the last place away rounds to
    the neighbouring shared-grid value, and 1.25 times that moves the output
    by one step or by two.  The rule admits both there (``step`` 2), refuses
    three, and with ``step`` 1 refuses the two-step outputs."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-8, 8, (2, 8, 8, 32), generator=g).to(torch.int8)
    # Exact sums in eighths: many projections sit exactly on a tie.
    wts, kw = random_mbconv_operands(g, 32, 64, 32, exact=True, residual="ratio")
    kw.update(stride=1, ratio_out=1.25)
    want = fused_mbconv_plain(x, wts, **kw)
    got = _reordered(x, wts, kw, order)
    v, eps, step = fused_mbconv_rounding_input(x, wts, **kw)
    assert step == 2
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(d.max()) == 2 and int((d == 1).sum()) > 0  # both kinds occur
    mismatches, refused = tie_mismatches(got, want, v, eps, step)
    assert mismatches == int((d > 0).sum()) and refused == 0
    # Held to one step, exactly the two-step outputs are refused.
    assert tie_mismatches(got, want, v, eps, 1) == (mismatches, int((d == 2).sum()))
    # A third step is refused even there, and two steps away from a tie too.
    flat = got.clone().flatten()
    two = int((d.flatten() == 2).nonzero()[0])
    flat[two] += 1 if got.flatten()[two] > want.flatten()[two] else -1
    assert tie_mismatches(flat.view(got.shape), want, v, eps, step) == (mismatches, 1)
    dist = (v - (torch.floor(v) + 0.5)).abs().flatten()
    inner = ((want.flatten().abs() < 100) & (d.flatten() == 0)).nonzero().flatten()
    far = inner[dist[inner].argmax()]
    flat = got.clone().flatten()
    flat[far] += 2
    assert tie_mismatches(flat.view(got.shape), want, v, eps, step) == (mismatches + 1, 1)


# ---------------------------------------------------------------------------
# (c) the tile choice
# ---------------------------------------------------------------------------

FLAGSHIP_BLOCKS = [
    # (H, W, Cin, Ch, Cout, stride, expand) of the 17 blocks at 240x384
    (120, 192, 32, 32, 16, 1, False), (120, 192, 16, 96, 24, 2, True),
    (60, 96, 24, 144, 24, 1, True), (60, 96, 24, 144, 32, 2, True),
    (30, 48, 32, 192, 32, 1, True), (30, 48, 32, 192, 32, 1, True),
    (30, 48, 32, 192, 64, 2, True), (15, 24, 64, 384, 64, 1, True),
    (15, 24, 64, 384, 64, 1, True), (15, 24, 64, 384, 64, 1, True),
    (15, 24, 64, 384, 96, 1, True), (15, 24, 96, 576, 96, 1, True),
    (15, 24, 96, 576, 96, 1, True), (15, 24, 96, 576, 160, 2, True),
    (8, 12, 160, 960, 160, 1, True), (8, 12, 160, 960, 160, 1, True),
    (8, 12, 160, 960, 320, 1, True),
]
ODD_SHAPES = [
    (15, 24, 32, 192, 32, 2, True), (7, 5, 6, 10, 6, 1, True), (7, 5, 6, 10, 7, 2, True),
    (5, 9, 5, 5, 3, 1, False), (7, 5, 64, 384, 640, 1, True),
]


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("shape", FLAGSHIP_BLOCKS + ODD_SHAPES,
                         ids=lambda s: "x".join(str(int(v)) for v in s))
def test_chosen_tile_covers_the_output_and_fits(shape, batch):
    h, w, cin, ch, cout, stride, expand = shape
    residual = stride == 1 and cin == cout
    for dw_grid in (False, True):
        th, tw = choose_mbconv_tile(batch, h, w, cin, ch, cout, stride, expand, dw_grid,
                                    residual)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert 1 <= th <= ho and 1 <= tw <= wo
        assert -(-ho // th) * th >= ho and -(-wo // tw) * tw >= wo  # the tiles cover it
        smem = mbconv_smem_bytes(th, tw, cin, cout, stride, expand, dw_grid, residual)
        assert smem <= MBCONV_SMEM_MAX == 232448
        grid = mbconv_warp_grid(th * tw, cout)
        assert grid is not None
        mi, ni, wm, wn, _ = grid
        assert wm * wn == 8
        assert wm * mi * 16 >= th * tw and wn * ni * 8 >= cout  # accumulators cover the tile


def test_no_tile_for_more_output_channels_than_the_accumulators_hold():
    assert mbconv_warp_grid(16, 640) is not None
    assert mbconv_warp_grid(16, 648) is None
    with pytest.raises(ValueError):
        choose_mbconv_tile(1, 8, 8, 32, 64, 648, 1)


def test_smem_bytes_of_a_known_tile():
    """Block 16 of the flagship on its whole 8x12 image: the input tile with
    halo (140 pixels x 176 bytes), two w1 chunks, the finished tile's int8
    staging rows (96 pixels x 320: here larger than the float32 hidden chunk
    they lie over, 142 pixels x 160 bytes with the two the depthwise may
    read past it), the bf16 depthwise chunk and two w3 chunks."""
    small = 2 * 13 * 32 * 4 + 320 * 8  # the small operands: two chunks', m3 and b3
    assert 96 * 320 > 142 * 40 * 4
    want = 140 * 176 + 2 * 32 * 176 + 96 * 320 + 96 * 80 + 2 * 320 * 80 + small
    assert mbconv_smem_bytes(8, 12, 160, 320, 1) == want
    # At Cout 160 the hidden chunk is the larger.  A residual block holds two
    # input tiles: the epilogue reads one while the next tile's arrives.
    assert mbconv_smem_bytes(8, 12, 160, 160, 1, residual=True) == (
        2 * 140 * 176 + 2 * 32 * 176 + 142 * 40 * 4 + 96 * 80 + 2 * 160 * 80
        + 2 * 13 * 32 * 4 + 160 * 8)
