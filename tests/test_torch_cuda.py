"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip where there is no CUDA device (the CPU
test run); on a GPU host run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels build from ``spef_tpu_torch/csrc`` with ``nvcc`` on first use.
K2 and K3 must agree with their plain versions bit for bit, int8, bf16 and
f32 outputs alike, and so must K1 with integer input and K4 wherever its
depthwise output is on a grid or its sums are exact: integer sums are exact
and no multiply-add whose product is inexact is fused.  K1 with bf16 input
and K4 with a real-valued depthwise output sum on the bf16 tensor cores, in
their own order: an int8 output may then differ by one step, only where the
value rounded last sits on a tie (``int8_matmul_requant_rounding_input``,
``fused_mbconv_rounding_input``, ``tie_mismatches``), and on at most 0.5% of
the outputs; a float32 output stays within the rule's ``eps``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import check_mm, random_mbconv_operands  # noqa: E402 - the repo root's smoke script
from spef_tpu_torch.ops.fused_block import (  # noqa: E402
    fused_mbconv,
    fused_mbconv_plain,
    fused_mbconv_rounding_input,
    fused_stem,
    fused_stem_plain,
    pack_mbconv_weights,
    pack_stem_weights,
    tie_mismatches,
)
from spef_tpu_torch.ops.int8_ops import (  # noqa: E402
    int8_depthwise3x3,
    int8_depthwise3x3_plain,
    int8_matmul_requant,
    pack_mm_weights,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype == torch.int8 else a,
                       b.view(torch.uint8) if b.dtype == torch.int8 else b)


MM_CASES = {
    "int8_relu": (torch.int8, dict(relu=True, out_inv_step=8.0, out_qmax=15.0)),
    "bits_in_bits_out": (torch.int8, dict(relu=True, out_inv_step=3.0, out_qmax=255.0,
                                          in_unsigned=True, out_bits=True)),
    "residual": (torch.int8, dict(relu=False, out_inv_step=4.0, out_qmax=7.0, out_qmin=-8.0,
                                  res_ratio=0.75)),
    "f32_out": (torch.int8, dict(relu=True, out_inv_step=None)),
    "bf16_in": (torch.bfloat16, dict(relu=False, out_inv_step=2.0, out_qmin=-128.0)),
    "bf16_in_residual": (torch.bfloat16, dict(relu=False, out_inv_step=4.0, out_qmax=7.0,
                                              out_qmin=-8.0, res_ratio=0.75)),
    "bf16_in_f32_out": (torch.bfloat16, dict(relu=True, out_inv_step=None)),
    # the int8 carry's conventions: requant by division, a shifted emit
    "carry_div_shifted_out": (torch.int8, dict(relu=True, out_inv_step=None, out_step=0.125,
                                               out_qmax=255.0, out_zp=128)),
    "carry_div_residual": (torch.int8, dict(relu=False, out_inv_step=None, out_step=0.25,
                                            out_qmax=127.0, out_qmin=-128.0, res_ratio=1.0,
                                            res_qmax=127.0, res_qmin=-128.0)),
    "carry_bf16_in_div": (torch.bfloat16, dict(relu=False, out_inv_step=None, out_step=0.5,
                                               out_qmin=-128.0)),
}


@pytest.mark.parametrize("case", sorted(MM_CASES))
@pytest.mark.parametrize("mnk", [
    (1000, 96, 16), (333, 160, 960), (64, 1280, 320),
    (1001, 16, 24), (777, 24, 16),  # K 24 and 16 padded to the mma depth, N 16 and 24
    (5000, 96, 16),                  # block 1's expand shape, many row tiles a block
    (130, 384, 576),                 # two column slices, weights resident
    (129, 24, 27),                   # K 27: byte copies of x
])
def test_k1_kernel_matches_plain(dev, case, mnk):
    """Integer input bit for bit; bf16 input under the tie rule (M is no
    multiple of any tile)."""
    m, n, k = mnk
    dtype, kw = MM_CASES[case]
    g = torch.Generator().manual_seed(m + n + k)
    if dtype == torch.bfloat16:
        x = (torch.rand(m, k, generator=g) * 6).to(torch.bfloat16)
    else:
        lo = -128 if kw.get("in_unsigned") else -16
        x = torch.randint(lo, 16 if lo == -16 else 128, (m, k), generator=g).to(torch.int8)
    w = torch.randint(-8, 8, (k, n), generator=g).to(torch.int8)
    mult = torch.rand(n, generator=g) * 1e-2
    bias = torch.randn(n, generator=g) * 0.1
    if "res_ratio" in kw:
        kw = dict(kw, residual=torch.randint(-7, 8, (m, n), generator=g).to(torch.int8).to(dev))
    args = [t.to(dev) for t in (x, w, mult, bias)]
    before = int8_matmul_requant.launches
    got = int8_matmul_requant(*args, **kw)
    torch.cuda.synchronize()
    assert int8_matmul_requant.launches == before + 1
    check_mm(got, args, kw)
    # Weights packed ahead, as a built forward holds them, give the same bits.
    _same(int8_matmul_requant(*args, packed=pack_mm_weights(args[1]), **kw), got)


DW_CASES = {
    "s1_int8": (1, torch.int8, dict(out_inv_step=6.0)),
    "s2_bits_in_bits_out": (2, torch.int8, dict(out_inv_step=2.0, out_qmax=255.0,
                                                in_unsigned=True, out_bits=True)),
    "s1_bf16_out": (1, torch.int8, dict(out_inv_step=None)),
    "s2_real_in_bf16_out": (2, torch.float32, dict(out_inv_step=None, in_step=1.0)),
    "s1_real_in_int8_out": (1, torch.float32, dict(out_inv_step=6.0, in_step=1.0)),
    # the int8 carry's conventions: a shifted input padded with -128, requant
    # by division, a shifted unsigned emit
    "s1_carry_halo_div_shifted_out": (1, torch.int8, dict(out_inv_step=None, out_step=0.1,
                                                          out_qmax=255.0, out_zp=128,
                                                          halo=-128)),
    "s2_carry_halo_div": (2, torch.int8, dict(out_inv_step=None, out_step=0.2, halo=-128)),
    "s2_carry_real_in_div_shifted_out": (2, torch.float32, dict(
        out_inv_step=None, out_step=0.1, in_step=1.0, out_qmax=255.0, out_zp=128)),
}


@pytest.mark.parametrize("case", sorted(DW_CASES))
@pytest.mark.parametrize("shape", [
    (2, 120, 192, 32), (3, 15, 24, 960), (1, 7, 5, 3),
    (2, 60, 96, 144),  # 16-byte loads of float32, 4 channels a thread
    (2, 9, 11, 24),    # int8: 8-byte access is possible, 16-byte is not
    (2, 6, 5, 32),     # narrower than a strip
    (3, 15, 23, 96),   # odd height and width (stride 2: 8 x 12 out)
    (2, 13, 20, 20),   # float32 by fours, int8 one channel a thread
])
def test_k2_kernel_matches_plain(dev, case, shape):
    stride, dtype, kw = DW_CASES[case]
    kw = {"in_step": 0.05, **kw}
    g = torch.Generator().manual_seed(sum(shape))
    if dtype == torch.float32:
        x = torch.rand(shape, generator=g) * 4
    else:
        x = torch.randint(-128, 128, shape, generator=g).to(torch.int8)
    c = shape[-1]
    w = torch.randint(-8, 8, (3, 3, c), generator=g).to(torch.int8)
    mult = torch.rand(c, generator=g) * 1e-2
    bias = torch.randn(c, generator=g) * 0.05
    args = [t.to(dev) for t in (x, w, mult, bias)]
    before = int8_depthwise3x3.launches
    got = int8_depthwise3x3(*args, stride=stride, **kw)
    torch.cuda.synchronize()
    assert int8_depthwise3x3.launches == before + 1
    _same(got, int8_depthwise3x3_plain(*args, stride=stride, **kw))


STEM_CASES = {
    # name: (frames shape, Cout, qmax)
    "flagship_bits": ((2, 240, 384, 3), 32, 255.0),
    "flagship_int8": ((2, 240, 384, 3), 32, 127.0),
    "odd_size_odd_channels": ((3, 9, 13, 3), 10, 255.0),
    "even_height_odd_width": ((2, 10, 13, 3), 32, 127.0),
    "odd_height_even_width": ((1, 11, 20, 3), 16, 255.0),
    # 60 bands x 40 images: several waves of blocks on 132 SMs
    "many_waves": ((40, 240, 384, 3), 32, 255.0),
}


@pytest.mark.parametrize("case", sorted(STEM_CASES))
def test_k3_kernel_matches_plain(dev, case):
    shape, cout, qmax = STEM_CASES[case]
    g = torch.Generator().manual_seed(cout + shape[1])
    frames = torch.randint(0, 256, shape, generator=g).to(torch.uint8)
    w = torch.randint(-8, 8, (3, 3, 3, cout), generator=g).to(torch.int8)
    mult = torch.rand(cout, generator=g) * 2e-2 / 255.0
    bias = torch.randn(cout, generator=g) * 0.05
    args = [t.to(dev) for t in (frames, w, mult, bias)]
    before = fused_stem.launches
    got = fused_stem(*args, inv_step=qmax / 0.3, qmax=qmax)
    torch.cuda.synchronize()
    assert fused_stem.launches == before + 1
    _same(got, fused_stem_plain(*args, inv_step=qmax / 0.3, qmax=qmax))
    assert got.unique().numel() > 16
    packed = pack_stem_weights(args[1])
    _same(fused_stem(*args, inv_step=qmax / 0.3, qmax=qmax, packed=packed), got)


K4_CASES = {
    # name: (x shape, Ch, Cout, stride, in_unsigned, random_mbconv_operands kwargs)
    # the flagship's blocks 0, 1, 2, 13, 15 and 16 under the boundary recipe
    "b0_no_expand_in_unsigned": ((2, 120, 192, 32), 32, 16, 1, True, dict(expand=False)),
    "b1_s2": ((2, 120, 192, 16), 96, 24, 2, False, dict()),
    "b2_s1_residual_ratio": ((2, 60, 96, 24), 144, 24, 1, False, dict(residual="ratio")),
    "b13_s2_odd_height": ((3, 15, 24, 96), 576, 160, 2, False, dict()),
    "b15_s1_residual_same_step": ((3, 8, 12, 160), 960, 160, 1, False, dict(residual="same")),
    "b16_s1": ((3, 8, 12, 160), 960, 320, 1, False, dict()),
    # interiors on grids, and each grid alone
    "grids_s1_residual_ratio": ((2, 30, 48, 64), 384, 64, 1, False,
                                dict(hidden_grid=True, dw_grid=True, residual="ratio")),
    "grids_s2_in_unsigned": ((2, 30, 48, 32), 192, 64, 2, True,
                             dict(hidden_grid=True, dw_grid=True)),
    "hidden_grid_only_s1": ((2, 15, 24, 64), 384, 96, 1, False, dict(hidden_grid=True)),
    "dw_grid_only_s2": ((2, 15, 24, 64), 384, 96, 2, False, dict(dw_grid=True)),
    "no_expand_dw_grid_s2": ((2, 16, 12, 32), 32, 24, 2, False,
                             dict(expand=False, dw_grid=True)),
    # Cin 24 padded to the mma depth (block 3), and a tile with a partial chunk (Ch 144)
    "b3_s2_cin24": ((2, 60, 96, 24), 144, 32, 2, False, dict()),
    # every product and partial sum exact: no summation order can show
    "exact_sums_s1_residual": ((2, 30, 48, 32), 64, 32, 1, False,
                               dict(exact=True, residual="ratio")),
    "exact_sums_s2": ((2, 15, 24, 32), 64, 32, 2, False, dict(exact=True)),
    # channel counts off a multiple of 4: the byte-wise loads and stores
    "odd_channels_s1_residual": ((2, 7, 5, 6), 10, 6, 1, False, dict(residual="ratio")),
    "odd_channels_s2_in_unsigned": ((2, 7, 5, 6), 10, 7, 2, True, dict(hidden_grid=True)),
    "odd_channels_no_expand": ((1, 5, 9, 5), 5, 3, 1, True, dict(expand=False)),
}


def _k4_same(got, x, wts, kw, exact=False):
    """K4's contract: bit for bit with a depthwise grid or exact sums, else
    only mismatches the tie rule admits, on at most 0.5% of the outputs."""
    want = fused_mbconv_plain(x, wts, **kw)
    if kw.get("inv_d") is not None or exact:
        _same(got, want)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    v, eps, step = fused_mbconv_rounding_input(x, wts, **kw)
    mismatches, refused = tie_mismatches(got, want, v, eps, step)
    assert refused == 0, (mismatches, refused)
    assert mismatches <= 0.005 * got.numel(), mismatches


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_kernel_matches_plain(dev, case):
    shape, ch, cout, stride, unsigned, kwargs = K4_CASES[case]
    g = torch.Generator().manual_seed(sum(shape) + ch)
    lo, hi = (-8, 8) if kwargs.get("exact") else ((-128, 128) if unsigned else (-64, 64))
    x = torch.randint(lo, hi, shape, generator=g).to(torch.int8).to(dev)
    wts, kw = random_mbconv_operands(g, shape[-1], ch, cout, **kwargs)
    wts = {k: v.to(dev) for k, v in wts.items()}
    kw.update(stride=stride, in_unsigned=unsigned)
    before = fused_mbconv.launches
    got = fused_mbconv(x, wts, **kw)
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    _k4_same(got, x, wts, kw, exact=bool(kwargs.get("exact")))
    assert got.unique().numel() > 16
    # Weights packed ahead, as a built forward holds them, give the same bits.
    packed = pack_mbconv_weights(wts, dw_grid=kw["inv_d"] is not None)
    _same(fused_mbconv(x, packed, **kw), got)
    with pytest.raises(ValueError):  # packed for the other projection
        fused_mbconv(x, pack_mbconv_weights(wts, dw_grid=kw["inv_d"] is None), **kw)


def test_k4_python_tile_model_mirrors_the_kernel_launcher(dev):
    """``mbconv_warp_grid`` and ``mbconv_smem_bytes`` repeat ``warp_grid`` and
    ``layout`` of ``csrc/fused_mbconv.cu``: for every candidate tile of the
    flagship's block shapes and some odd ones both sides agree on whether
    the tile runs, on the warp grid and on the shared memory, and the tile
    the cost model chooses is one the launcher takes."""
    import ctypes

    from spef_tpu_torch.ops import _build, fused_block

    lib = _build.load_library("fused_mbconv")
    fn = lib.spef_fused_mbconv_layout
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    shapes = [  # (Ho, Wo, Cin, Ch, Cout, stride, expand) as the tile choice sees them
        (120, 192, 32, 32, 16, 1, False), (60, 96, 16, 96, 24, 2, True),
        (60, 96, 24, 144, 24, 1, True), (30, 48, 24, 144, 32, 2, True),
        (30, 48, 32, 192, 32, 1, True), (15, 24, 32, 192, 64, 2, True),
        (15, 24, 64, 384, 64, 1, True), (15, 24, 64, 384, 96, 1, True),
        (15, 24, 96, 576, 96, 1, True), (8, 12, 96, 576, 160, 2, True),
        (8, 12, 160, 960, 160, 1, True), (8, 12, 160, 960, 320, 1, True),
        (7, 5, 6, 10, 7, 2, True), (5, 9, 5, 5, 3, 1, False), (7, 5, 64, 384, 640, 1, True),
    ]
    checked = 0
    for ho, wo, cin, ch, cout, stride, expand in shapes:
        residual = stride == 1 and cin == cout
        for dw_grid in (False, True):
            for th in sorted({min(s, ho) for s in fused_block._TILE_SIZES}):
                for tw in sorted({min(s, wo) for s in fused_block._TILE_SIZES}):
                    grid4 = (ctypes.c_int * 4)()
                    smem = fn(th, tw, cin, cout, stride, int(expand), int(dw_grid),
                              int(residual), grid4)
                    mirror = fused_block.mbconv_warp_grid(th * tw, cout)
                    if mirror is None:
                        assert smem == -1, (th, tw, cout)
                        continue
                    assert tuple(grid4) == mirror[:4], (th, tw, cout)
                    assert smem == fused_block.mbconv_smem_bytes(
                        th, tw, cin, cout, stride, expand, dw_grid, residual), (th, tw, cin, cout)
                    checked += 1
            h, w = (ho - 1) * stride + 1, (wo - 1) * stride + 1
            th, tw = fused_block.choose_mbconv_tile(256, h, w, cin, ch, cout, stride, expand,
                                                    dw_grid, residual)
            grid4 = (ctypes.c_int * 4)()
            smem = fn(th, tw, cin, cout, stride, int(expand), int(dw_grid), int(residual), grid4)
            assert 0 < smem <= fused_block.MBCONV_SMEM_MAX
    assert checked > 1000


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 8, dtype=torch.int8, device=dev)
    w = torch.zeros(8, 4, dtype=torch.int8, device=dev)
    v = torch.zeros(4, device=dev)
    with pytest.raises(ValueError):
        int8_matmul_requant(x.float(), w, v, v, out_inv_step=1.0)  # f32 x
    with pytest.raises(ValueError):
        int8_matmul_requant(x, w.t(), v, v, out_inv_step=1.0)  # shape mismatch
    with pytest.raises(ValueError):
        int8_matmul_requant(x, w, v.cpu(), v, out_inv_step=1.0)  # mixed devices
    with pytest.raises(ValueError):
        int8_depthwise3x3(torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=dev),
                          torch.zeros(3, 3, 8, dtype=torch.int8, device=dev),
                          torch.zeros(8, device=dev), torch.zeros(8, device=dev), stride=3)
    frames = torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device=dev)
    w = torch.zeros(3, 3, 3, 4, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fused_stem(frames.to(torch.int8), w, v, v)  # not uint8
    with pytest.raises(ValueError):
        fused_stem(frames, w, v.cpu(), v)  # mixed devices
    with pytest.raises(ValueError):
        fused_stem(frames, w, v, v, qmax=256.0)  # beyond 8 bits
    wts, kw = random_mbconv_operands(torch.Generator().manual_seed(0), 8, 16, 8)
    wts = {k: t.to(dev) for k, t in wts.items()}
    x8 = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fused_mbconv(x8, wts, **{**kw, "use_residual": True, "stride": 2})
    with pytest.raises(ValueError):
        fused_mbconv(x8, {**wts, "m3": wts["m3"].cpu()}, **kw)  # mixed devices


def test_flagship_int8_forward_kernels_match_plain(dev):
    """The boundary-recipe flagship graph, batch 4 at 240x384: 34 K1 and 17
    K2 launches a forward.  K1's bf16 projections may round a tie the other
    way (one int8 step of an activation), so the logits are held to the
    plain backend's within 0.3; each K1 call is held to its contract at the
    input the forward itself gave it (integer input and every K2 call bit
    for bit, the projections under the tie rule)."""
    import spef_tpu_torch.quant.int8_cuda as int8_cuda
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward, load_int8_graph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    graph = load_int8_graph(os.path.join(repo, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"))
    frames = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (4, 240, 384, 3), np.uint8)).to(dev)
    fwd = build_cuda_forward(graph, backend="cuda", device=dev)
    assert fwd.launches_per_call == {"int8_matmul_requant": 34, "int8_depthwise3x3": 17}
    before = (int8_matmul_requant.launches, int8_depthwise3x3.launches)
    got = fwd(frames)
    torch.cuda.synchronize()
    assert (int8_matmul_requant.launches - before[0],
            int8_depthwise3x3.launches - before[1]) == (34, 17)
    want = build_cuda_forward(graph, backend="plain", device=dev)(frames)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) < 0.3

    calls = []

    def recorder(fn):
        def rec(*args, **kw):
            calls.append((fn, args, kw))
            return fn(*args, **kw)
        return rec

    saved = (int8_cuda.int8_matmul_requant, int8_cuda.int8_depthwise3x3)
    int8_cuda.int8_matmul_requant, int8_cuda.int8_depthwise3x3 = map(recorder, saved)
    try:
        recorded = build_cuda_forward(graph, backend="cuda", device=dev)
    finally:
        int8_cuda.int8_matmul_requant, int8_cuda.int8_depthwise3x3 = saved
    recorded(frames)
    assert len(calls) == 51
    projections = 0
    for fn, args, kw in calls:
        out = fn(*args, **kw)
        if fn is int8_depthwise3x3:
            _same(out, int8_depthwise3x3_plain(*args, **kw))
        else:
            _, _, step = check_mm(out, args, kw)  # bit for bit with integer input
            projections += args[0].dtype == torch.bfloat16
            assert step <= 1  # no residual ratio of the flagship is above 1
    assert projections == 17


def test_flagship_fused_forward_kernels_match_plain(dev):
    """The boundary-recipe flagship graph through the fused executor, batch 4
    at 240x384: 1 K3, 17 K4 and 1 K1 launch a forward.  K4's projection may
    round a tie the other way (one int8 step of an activation), so the logits
    are held to the plain backend's within 0.3, the bound between the card
    and the CPU; each K4 call is held to the tie rule at the input the
    forward itself gave it."""
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    graph = load_int8_graph(os.path.join(repo, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"))
    frames = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (4, 240, 384, 3), np.uint8)).to(dev)
    fwd = build_fused_forward(graph, backend="cuda", device=dev)
    assert fwd.launches_per_call == {"fused_stem": 1, "fused_mbconv": 17,
                                     "int8_matmul_requant": 1}
    counters = (fused_stem, fused_mbconv, int8_matmul_requant)
    before = [f.launches for f in counters]
    got = fwd(frames)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 17, 1]
    want = build_fused_forward(graph, backend="plain", device=dev)(frames)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) < 0.3

    import spef_tpu_torch.quant.int8_fused as int8_fused
    calls = []

    def recorder(x, wts, **kw):
        calls.append((x, wts, kw))
        return fused_mbconv(x, wts, **kw)

    saved = int8_fused.fused_mbconv
    int8_fused.fused_mbconv = recorder
    try:
        recorded = build_fused_forward(graph, backend="cuda", device=dev)
    finally:
        int8_fused.fused_mbconv = saved
    recorded(frames)
    assert len(calls) == 17
    for x, wts, kw in calls:
        _k4_same(fused_mbconv(x, wts, **kw), x, wts, kw)


def test_flagship_carry_forward_kernels_match_plain(dev):
    """The int8-carry executor on the boundary-recipe flagship graph, batch 4
    at 240x384: 34 K1 and 17 K2 launches a forward, logits within 0.3 of
    the plain backend's (K1's ties at the bf16 projections), and each call
    held to its contract at the input the forward gave it."""
    import spef_tpu_torch.quant.int8_carry as int8_carry
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    graph = load_int8_graph(os.path.join(repo, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"))
    frames = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (4, 240, 384, 3), np.uint8)).to(dev)
    fwd = int8_carry.build_int8_carry_forward(graph, backend="cuda", device=dev)
    assert fwd.launches_per_call == {"int8_matmul_requant": 34, "int8_depthwise3x3": 17}
    before = (int8_matmul_requant.launches, int8_depthwise3x3.launches)
    got = fwd(frames)
    torch.cuda.synchronize()
    assert (int8_matmul_requant.launches - before[0],
            int8_depthwise3x3.launches - before[1]) == (34, 17)
    want = int8_carry.build_int8_carry_forward(graph, backend="plain", device=dev)(frames)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) < 0.3

    calls = []

    def recorder(fn):
        def rec(*args, **kw):
            calls.append((fn, args, kw))
            return fn(*args, **kw)
        return rec

    saved = (int8_carry.int8_matmul_requant, int8_carry.int8_depthwise3x3)
    int8_carry.int8_matmul_requant, int8_carry.int8_depthwise3x3 = map(recorder, saved)
    try:
        recorded = int8_carry.build_int8_carry_forward(graph, backend="cuda", device=dev)
    finally:
        int8_carry.int8_matmul_requant, int8_carry.int8_depthwise3x3 = saved
    recorded(frames)
    assert len(calls) == 51
    halos = 0
    for fn, args, kw in calls:
        out = fn(*args, **kw)
        if fn is int8_depthwise3x3:
            halos += kw["halo"] != 0
            _same(out, int8_depthwise3x3_plain(*args, **kw))
        else:
            _, _, step = check_mm(out, args, kw)  # bit for bit with integer input
            assert step <= 1
    assert halos == 1  # block 0 reads the stem's shifted unsigned grid


def test_carry_forward_bit_for_bit_on_an_integer_recipe(dev):
    """On a recipe whose every sum is an integer (w8a8: unsigned 8-bit grids
    carried shifted, padded with -128) the carry executor on the kernels
    gives the plain backend's logits bit for bit."""
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import default_bit_width
    from spef_tpu_torch.quant.convert import convert_qat_params
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward

    bw = default_bit_width(n_blocks=17, w=8, a=8, shared=8)
    bw["inverted_residual"][0] = [(8, 8), (8, 8), (8,)]
    model = import_model("mobilenet_v2_q", "ursonet_q", bit_width=bw, ori_mode="classification",
                         n_ori_bins=64, pos_mode="regression", device="cpu", seed=5)
    graph = convert_qat_params(model)
    frames = torch.from_numpy(
        np.random.RandomState(1).randint(0, 256, (2, 64, 96, 3), np.uint8)).to(dev)
    got = build_int8_carry_forward(graph, backend="cuda", device=dev)(frames)
    want = build_int8_carry_forward(graph, backend="plain", device=dev)(frames)
    for a, b in zip(got, want):
        _same(a, b)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def test_train_steps_on_the_card_match_the_cpu(dev):
    """Three SGD steps of ``small_mobile`` at 48x64, batch 4, float32 on
    both sides (TF32 off), no dropout: the losses within 1e-5 relative, the
    parameters and BN statistics within 1e-5 (as the CPU steps are held to
    JAX's in ``tests/test_torch_train_step.py``)."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import DSPEED_CAMERA
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state, make_train_step

    rs = np.random.RandomState(0)
    images = rs.rand(3, 4, 48, 64, 3).astype(np.float32)
    q = rs.randn(3, 4, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, (3, 4)), rs.uniform(-1, 1, (3, 4)),
                    rs.uniform(5, 30, (3, 4))], -1).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for where in (dev, torch.device("cpu")):
            utils = SPEUtils.create(DSPEED_CAMERA, ori_mode="classification",
                                    n_ori_bins_per_dim=4, pos_mode="regression", device=where)
            model = import_model("small_mobile", "ursonet", ori_mode="classification",
                                 n_ori_bins=utils.orientation.n_bins, pos_mode="regression",
                                 device=where, compute_dtype=torch.float32, seed=3)
            model.head.ori_dropout.rate = 0.0
            opt, _ = import_optimizer(model.parameters(), 0.01, "SGD", 0.9, 1e-4)
            state = create_train_state(model, opt)
            step = make_train_step(utils, SPELoss("classification", "regression"))
            gen = torch.Generator(device=where).manual_seed(0)
            losses = []
            for i in range(3):
                targets = utils.encode_targets(torch.from_numpy(q[i]).to(where),
                                               torch.from_numpy(pos[i]).to(where))
                _, m = step(state, torch.from_numpy(images[i]).to(where), targets, gen)
                losses.append(float(m["loss"]))
            runs[where.type] = (losses, {k: v.detach().cpu() for k, v in
                                         model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_device_resident_loader_matches_the_host_loader(dev, tmp_path):
    """``CachedBatchLoader(device_resident=True)`` on the card gives the
    streaming loader's batches: the images gathered on the card, padding
    rows zero, two shuffled epochs."""
    from spef_tpu_torch.data import dataset
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset

    still = create_synthetic_dataset(str(tmp_path), 7, 2, 2, img_size=(36, 60), seed=3)
    manifest = dataset.Manifest.from_json(os.path.join(still, "train", "pose.json"),
                                          os.path.join(still, "train", "images"))
    host = dataset.BatchLoader(manifest, 3, (36, 60), shuffle=True, seed=5, n_workers=2)
    card = dataset.CachedBatchLoader(manifest, 3, (36, 60), shuffle=True, seed=5, n_workers=2,
                                     device_resident=True, device=dev)
    for _ in range(2):
        for want, got in zip(list(host), list(card)):
            assert got["images"].device.type == "cuda"
            assert torch.equal(got["images"].cpu(), torch.from_numpy(want["images"]))
            for k in ("ori", "pos", "mask"):
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Deploy and serve on the card
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_GRAPH = os.path.join(REPO, "spef_tpu_torch", "assets",
                              "flagship_boundary_int8_graph.pkl")


def _flagship_fused_predict(dev):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    fwd = build_fused_forward(load_int8_graph(FLAGSHIP_GRAPH), backend="cuda", device=dev)
    return build_predict_fn(None, utils, forward_fn=fwd), utils


@pytest.mark.parametrize("depth", [2, 3])
def test_serve_stream_pinned_ring_equals_predict(dev, depth):
    """``serve_stream`` on the fused executor over 8 distinct batches of 16
    frames: each result, in order, is ``PoseServer.predict``'s on its own
    batch bit for bit (a pinned buffer overwritten while its copy was in
    flight would give another batch's frames), and the kernels launched 19
    times a forward."""
    from spef_tpu_torch.serving import PoseServer, serve_stream

    predict, _ = _flagship_fused_predict(dev)
    batches = [np.random.RandomState(100 + i).randint(0, 256, (16, 240, 384, 3), np.uint8)
               for i in range(8)]
    counters = (fused_stem, fused_mbconv, int8_matmul_requant)
    before = [f.launches for f in counters]
    outs = [{k: v.cpu().numpy() for k, v in out.items()}
            for out in serve_stream(predict, iter(batches), depth=depth, device=dev)]
    assert [f.launches - n for f, n in zip(counters, before)] == [8, 8 * 17, 8]
    server = PoseServer(predict, (240, 384, 3), max_batch=16, device=dev)
    assert len(outs) == len(batches)
    for i, (batch, out) in enumerate(zip(batches, outs)):
        want, _ = server.predict(batch)
        for k in want:
            np.testing.assert_array_equal(out[k], want[k], err_msg=f"batch {i} {k}")
    assert server._staging.is_pinned()


def test_pose_server_pinned_staging_pads_on_the_card(dev):
    """A request of 5 frames through the window of 16: the pinned buffer's
    tail is zeroed (a stale tail would move no output of these 5 frames,
    so a full request of other frames goes first), and the result is the
    unpadded call's."""
    from spef_tpu_torch.serving import PoseServer

    predict, _ = _flagship_fused_predict(dev)
    server = PoseServer(predict, (240, 384, 3), max_batch=16, device=dev)
    server.predict(np.full((16, 240, 384, 3), 255, np.uint8))
    frames = np.random.RandomState(7).randint(0, 256, (5, 240, 384, 3), np.uint8)
    got, ms = server.predict(frames)
    assert ms > 0 and got["ori"].shape == (5, 4)
    assert not server._staging.numpy()[5:].any()
    padded = np.concatenate([frames, np.zeros((11, 240, 384, 3), np.uint8)])
    want = predict(torch.from_numpy(padded).to(dev))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k][:5].cpu().numpy(), err_msg=k)


def _f32_predict(where):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import DSPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model

    utils = SPEUtils.create(DSPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                            pos_mode="classification", n_pos_bins_per_dim=4, device=where)
    model = import_model("small_mobile_q", "ursonet_q", quantization=False,
                         ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                         pos_mode="classification", n_pos_bins=utils.position.n_bins,
                         img_size=(48, 64), seed=3, device=where)
    return build_predict_fn(model, utils)


@pytest.mark.parametrize("exported_on,served_on", [("cuda", "cpu"), ("cpu", "cuda")])
def test_artifact_moves_between_the_card_and_the_cpu(dev, tmp_path, exported_on, served_on):
    """An artifact traced on one device served on the other
    (``move_to_device_pass``): the live float32 pipeline's soft-class PDFs
    and positions there within 1e-5 (float32 convolutions, TF32 off)."""
    from spef_tpu_torch.deploy import export_predict, load_exported
    from spef_tpu_torch.quant.int8_model import f32_convs

    path = str(tmp_path / "model.spef")
    meta = export_predict(_f32_predict(exported_on), 4, (48, 64), path, device=exported_on)
    assert meta["platforms"] == [exported_on]
    engine = load_exported(path, device=served_on)
    assert engine.device.type == served_on
    frames = np.random.RandomState(2).randint(0, 256, (3, 48, 64, 3), np.uint8)
    got, _ = engine.predict(frames)
    padded = torch.from_numpy(np.concatenate([frames, np.zeros((1, 48, 64, 3), np.uint8)]))
    with f32_convs():
        want = _f32_predict(served_on)(padded.to(served_on))
    for k in ("ori_soft", "pos_soft", "pos"):
        assert got[k].device.type == served_on
        torch.testing.assert_close(got[k], want[k][:3], rtol=1e-5, atol=1e-5)


def test_exported_engine_runs_without_tf32_and_restores_it(dev, tmp_path):
    """With TF32 on around it, the engine's float32 convolutions still give
    the TF32-off live result (within 1e-5; TF32 moves them by about 1e-3),
    and the caller's switches are as they were after the call."""
    from spef_tpu_torch.deploy import export_predict, load_exported
    from spef_tpu_torch.quant.int8_model import f32_convs

    predict = _f32_predict(dev)
    path = str(tmp_path / "model.spef")
    export_predict(predict, 4, (48, 64), path, device=dev)
    engine = load_exported(path)
    frames = torch.from_numpy(
        np.random.RandomState(3).randint(0, 256, (4, 48, 64, 3), np.uint8)).to(dev)
    with f32_convs():
        want = predict(frames)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = engine(frames)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for k in ("ori_soft", "pos_soft", "pos"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_export_refuses_a_forward_that_launches_hand_kernels(dev, tmp_path):
    """The fused executor's forward cannot be traced: ``export_predict``
    raises naming the ROADMAP item, writes no file and launches nothing."""
    from spef_tpu_torch.deploy import export_predict
    from spef_tpu_torch.ops._build import KernelTraceError

    predict, _ = _flagship_fused_predict(dev)
    counters = (fused_stem, fused_mbconv, int8_matmul_requant)
    before = [f.launches for f in counters]
    path = tmp_path / "fused.spef"
    with pytest.raises(KernelTraceError, match="ROADMAP §A, item 10"):
        export_predict(predict, 4, (240, 384), str(path), device=dev)
    assert not path.exists()
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# The autotuner's tiles and the backend plan
# ---------------------------------------------------------------------------

TUNED_SHAPES = {  # flagship blocks: (x shape, Ch, Cout, stride, random_mbconv_operands kwargs)
    "b1_s2_expand": ((2, 120, 192, 16), 96, 24, 2, dict()),
    "b2_s1_residual_ratio": ((2, 60, 96, 24), 144, 24, 1, dict(residual="ratio")),
    "b16_s1": ((2, 8, 12, 160), 960, 320, 1, dict()),
}


@pytest.mark.parametrize("case", sorted(TUNED_SHAPES))
def test_k4_at_every_tile_the_tuner_times(dev, case):
    """Each tile ``tune_graph`` would time at batch 256 for a flagship block:
    the tie rule against the plain version, and the same bits as the cost
    model's tile (the spatial tile does not change K4's order of sums)."""
    from spef_tpu_torch.quant.autotune import _candidates

    shape, ch, cout, stride, kwargs = TUNED_SHAPES[case]
    g = torch.Generator().manual_seed(sum(shape) + ch)
    x = torch.randint(-64, 64, shape, generator=g).to(torch.int8).to(dev)
    wts, kw = random_mbconv_operands(g, shape[-1], ch, cout, **kwargs)
    wts = {k: v.to(dev) for k, v in wts.items()}
    kw.update(stride=stride)
    tiles = _candidates(256, shape[1], shape[2], shape[3], ch, cout, stride, True,
                        kw["inv_d"] is not None, kw["use_residual"])
    assert len(tiles) >= 2
    default = fused_mbconv(x, wts, **kw, tile=tiles[0])
    _k4_same(default, x, wts, kw)
    for tile in tiles[1:]:
        _same(fused_mbconv(x, wts, **kw, tile=tile), default)
    with pytest.raises(ValueError):
        fused_mbconv(x, wts, **kw, tile=(64, 64))  # beyond the block's shared memory


def _w8a8_graph():
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import default_bit_width
    from spef_tpu_torch.quant.convert import convert_qat_params

    bw = default_bit_width(n_blocks=17, w=8, a=8, shared=8)
    bw["inverted_residual"][0] = [(8, 8), (8, 8), (8,)]
    model = import_model("mobilenet_v2_q", "ursonet_q", bit_width=bw, ori_mode="classification",
                         n_ori_bins=64, pos_mode="regression", device="cpu", seed=5)
    return convert_qat_params(model)


def test_library_nodes_on_the_card(dev):
    """The plan's library-op form of every node of a w8a8 flagship graph
    (every sum an integer): bit for bit the same on the card as on the CPU
    (where ``tests/test_torch_autotune.py`` holds it to JAX's XLA nodes), and
    against K3 / K4's plain versions at most one int8 step apart on at most
    1e-4 of the outputs (it divides by a step where the kernels multiply by
    its reciprocal, as the JAX package's XLA and Pallas nodes do)."""
    import spef_tpu_torch.quant.int8_fused as int8_fused

    graph = int8_fused.scalars(_w8a8_graph())
    frames = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 64, 96, 3),
                                                               np.uint8))

    def tensor_on(device):
        return lambda a, dtype: torch.tensor(np.asarray(a), dtype=dtype, device=device)

    (stem_args, stem_kw), nodes, _ = int8_fused.plan_nodes(graph, tensor_on(dev), pack=False)
    card = int8_fused.library_stem(frames.to(dev),
                                   int8_fused.library_stem_operands(graph["stem"], tensor_on(dev)))
    cpu = int8_fused.library_stem(frames, int8_fused.library_stem_operands(graph["stem"]))
    _same(card.cpu(), cpu)

    def within_a_step(a, b, bits=False):
        if bits:  # uint8 bits in an int8 container
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        d = (a.float() - b.float()).abs()
        assert float(d.max()) <= 1 and int((d > 0).sum()) <= 1e-4 * d.numel() + 1

    within_a_step(card, fused_stem_plain(frames.to(dev), *stem_args, **stem_kw),
                  bits=graph["stem"]["act_qmax"] > 127)
    y = card
    for nd in nodes:
        if "requant_in" in nd:
            from spef_tpu_torch.quant.int8_graph import requant_signed

            y = requant_signed(y, **nd["requant_in"])
        args = (nd["blk"], nd["in_step"], nd["out_grid"], nd["unsigned"])
        got = int8_fused.library_block(y, int8_fused.library_block_operands(*args, tensor_on(dev)))
        _same(got.cpu(), int8_fused.library_block(y.cpu(),
                                                  int8_fused.library_block_operands(*args)))
        want = fused_mbconv_plain(y, nd["wts"], **nd["kw"])
        within_a_step(got, want)
        y = want


def test_hybrid_plan_forward_on_the_card(dev):
    """The flagship boundary graph on a hybrid plan (the stem and every
    third block in library ops), batch 4 at 240x384: K3 none, K4 on the
    fused blocks only, K1 once; its logits within 0.3 of the plain backend
    on the same plan and of the CPU's."""
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    graph = load_int8_graph(os.path.join(repo, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"))
    plan = {"stem": "xla",
            "blocks": ["xla" if i % 3 == 0 else "fused" for i in range(len(graph["blocks"]))]}
    n_fused = plan["blocks"].count("fused")
    frames = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 240, 384, 3),
                                                               np.uint8))
    fwd = build_fused_forward(graph, backend="cuda", device=dev, plan=plan)
    assert fwd.launches_per_call == {"fused_stem": 0, "fused_mbconv": n_fused,
                                     "int8_matmul_requant": 1}
    counters = (fused_stem, fused_mbconv, int8_matmul_requant)
    before = [f.launches for f in counters]
    got = fwd(frames.to(dev))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [0, n_fused, 1]
    want = build_fused_forward(graph, backend="plain", device=dev, plan=plan)(frames.to(dev))
    cpu = build_fused_forward(graph, backend="plain", device="cpu", plan=plan)(frames)
    for a, b, c in zip(got, want, cpu):
        assert float((a - b).abs().max()) < 0.3
        assert float((a.cpu() - c).abs().max()) < 0.3
