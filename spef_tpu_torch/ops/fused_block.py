"""Fused block kernels of the int8 deployment path, with their plain twins.

Counterpart of ``spef_tpu.ops.pallas.fused_block``:

  * :func:`fused_stem` (K3, ``csrc/fused_stem.cu``) — uint8 frame -> 3x3
    stride-2 convolution -> ReLU -> requant to the stem activation grid.
  * :func:`fused_mbconv` (K4, ``csrc/fused_mbconv.cu``) — one whole
    inverted-residual block, ``expand 1x1 -> depthwise 3x3 -> project 1x1 ->
    residual -> requant``, in one launch: the activation crosses device
    memory once a block, as int8, and the hidden tensor never leaves the SM.

Tensors are plain NHWC.  The TPU package's padded ``(W2, C128)`` layout, its
width-packed layout and its tile pickers are Mosaic layout workarounds, not
part of what the kernels compute: its packed and plain paths give the same
bits, and one Hopper kernel is the counterpart of both.  Every shape runs on
the kernels: odd heights and widths at stride 2 and any width, which the TPU
package left to XLA.

Each wrapper launches its kernel for CUDA tensors (raising on a CUDA error,
never falling back) and runs the ``*_plain`` version for CPU tensors; each
counts its kernel launches in its ``launches`` attribute.

Numerics shared by kernel and plain version (and the JAX kernels):

  * integer operands (the stem's pixels, the expand's input, the projection
    of a depthwise output on a grid) sum exactly, on the int8 tensor cores
    in K4;
  * the hidden tensor stays float32 unless the expand has an activation
    grid; the depthwise sums its nine taps in (dy, dx) order in float32,
    each product rounded before it is added (it is inexact on a float32
    hidden tensor, so a fused multiply-add would change it): hidden tensor
    and depthwise output are bit for bit the same in kernel and plain
    version;
  * a real-valued depthwise output is rounded to bf16 and the projection
    sums its exact products in float32.  The plain version sums in k order
    0..K-1; K4 sums on the bf16 tensor cores, in their order, as the JAX
    kernel's ``jnp.dot(..., preferred_element_type=float32)`` does.  The two
    sums differ by rounding only, which can move an output by one int8 step
    where the value that is rounded last sits on a tie:
    :func:`fused_mbconv_rounding_input` returns that value and the bound on
    its error, :func:`tie_mismatches` (shared with K1, in ``int8_ops``)
    applies the rule and counts;
  * ``y = acc * mult + bias`` is a rounded multiply then a rounded add;
    rounding to a grid is half to even; every scalar is the host's double
    rounded once to float32.

K4 reads its two weight matrices in the layouts its tensor-core loads want
(:func:`pack_mbconv_weights`, once when a forward is built) and takes its
output tile from the caller (the fused executor passes the winners of a
tuning table that ``quant/autotune.py`` measured on the card, when it is
given one) or from :func:`choose_mbconv_tile`, a cost model in the kernel's
own units.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from spef_tpu_torch.ops import _build
from spef_tpu_torch.ops.int8_ops import _decode, _encode_bits, _f32, tie_mismatches

__all__ = [
    "fused_stem", "fused_stem_plain", "pack_stem_weights", "fused_mbconv", "fused_mbconv_plain",
    "pack_mbconv_weights", "unpack_mbconv_weights", "choose_mbconv_tile", "ranked_mbconv_tiles",
    "check_mbconv_tile", "mbconv_smem_bytes",
    "mbconv_warp_grid", "fused_mbconv_rounding_input", "tie_mismatches",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_STEM_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]
_MBCONV_ARGTYPES = ([_P, _I] + [_P] * 3 + [_I] * 8 + [_I, _F, _F] * 2 + [_I] + [_F] * 5
                    + [_I, _I, _P])

# Elements of the largest intermediate a plain version holds at once; above
# it the plain version goes image chunk by image chunk (block 1's hidden
# tensor at batch 256 alone is 566 M float32).
_PLAIN_CHUNK_ELEMS = 1 << 26


def _out_hw(h: int, w: int, stride: int):
    """Output size of a 3x3 convolution with one pixel of padding."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _by_image_chunks(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                     elems_per_image: int) -> torch.Tensor:
    n = max(1, _PLAIN_CHUNK_ELEMS // max(elems_per_image, 1))
    if x.shape[0] <= n:
        return fn(x)
    return torch.cat([fn(x[i:i + n]) for i in range(0, x.shape[0], n)])


def _taps(xp: torch.Tensor, ho: int, wo: int, stride: int):
    """The nine (dy, dx) tap views of a tensor padded by one pixel: output
    pixel (r, c) reads padded rows ``stride*r + dy``, columns ``stride*c + dx``."""
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                             dx:dx + (wo - 1) * stride + 1:stride]


# ---------------------------------------------------------------------------
# K3: fused stem
# ---------------------------------------------------------------------------


_STEM_K = 27  # taps x channels: k = (dy, dx, ci)
_STEM_K_DEPTH = 32  # padded to the depth of one int8 mma


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """K3's weights as the tensor cores' B operand reads them: ``w (3, 3, 3,
    Cout)`` int8 (HWIO) as ``(Cout padded to 8, 32)`` int8, row ``co`` the
    27 weights in k = (dy, dx, ci) order, zeros from k = 27 and past Cout.
    Plain PyTorch, any device; done once when a forward is built, or by
    :func:`fused_stem` for a caller that passes none."""
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"pack_stem_weights: w must be int8 (3, 3, 3, Cout), got {tuple(w.shape)}")
    cout = w.shape[-1]
    packed = torch.zeros(_round_up(cout, _N_TILE), _STEM_K_DEPTH, dtype=torch.int8,
                         device=w.device)
    packed[:cout, :_STEM_K] = w.reshape(_STEM_K, cout).t()
    return packed


def _stem_sums(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's integer sums, float64 ``(B, Ho, Wo, Cout)``: integer pixels times
    integer weights, exact in any order."""
    _, h, wd, _ = img.shape
    ho, wo = _out_hw(h, wd, 2)
    wdbl = w.double()
    xp = torch.nn.functional.pad(img.double(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(img.shape[0], ho, wo, w.shape[-1], dtype=torch.float64, device=img.device)
    for dy, dx, tap in _taps(xp, ho, wo, 2):
        acc += tap @ wdbl[dy, dx]
    return acc


def fused_stem_plain(
    images: torch.Tensor,  # (B, H, W, 3) uint8
    w: torch.Tensor,  # (3, 3, 3, Cout) int8, HWIO
    mult: torch.Tensor,  # (Cout,) f32, 1/255 folded in
    bias: torch.Tensor,  # (Cout,) f32
    inv_step: float = 1.0,  # 1 / stem activation step
    qmax: float = 127.0,  # > 127: the output is uint8 bits in int8
    packed: Optional[torch.Tensor] = None,  # the kernel's copy of w; not read here
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arithmetic, any device)."""
    _, h, wd, _ = images.shape
    ho, wo = _out_hw(h, wd, 2)
    cout = w.shape[-1]

    def run(img: torch.Tensor) -> torch.Tensor:
        y = _stem_sums(img, w).float() * mult
        y = torch.clamp_min(y + bias, 0.0)
        q = torch.clamp(torch.round(y * _f32(inv_step)), 0.0, qmax)
        return _encode_bits(q) if qmax > 127.0 else q.to(torch.int8)

    return _by_image_chunks(run, images, 4 * ho * wo * cout)


def fused_stem(
    images: torch.Tensor,
    w: torch.Tensor,
    mult: torch.Tensor,
    bias: torch.Tensor,
    inv_step: float = 1.0,
    qmax: float = 127.0,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``(B, H, W, 3)`` uint8 -> ``(B, Ho, Wo, Cout)`` int8 on the stem
    activation grid (uint8 bits when ``qmax > 127``).  ``packed`` is
    :func:`pack_stem_weights` of ``w``, made once by a built forward;
    without it the weights are packed here, on every call.
    """
    if images.device.type == "cpu":
        return fused_stem_plain(images, w, mult, bias, inv_step, qmax, packed)
    if images.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {images.device}")
    _build.refuse_tracing("fused_stem", images)
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"fused_stem: images must be uint8 (B, H, W, 3), got "
                         f"{images.dtype} {tuple(images.shape)}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"fused_stem: w must be int8 (3, 3, 3, Cout), got {tuple(w.shape)}")
    cout = w.shape[-1]
    for name, t in (("mult", mult), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (cout,):
            raise ValueError(f"fused_stem: {name} must be float32 ({cout},)")
    if not 0.0 <= qmax <= 255.0:
        raise ValueError(f"fused_stem: qmax {qmax} is outside [0, 255], which 8 bits hold")
    if packed is None:
        packed = pack_stem_weights(w)
    if packed.dtype != torch.int8 or packed.shape != (_round_up(cout, _N_TILE), _STEM_K_DEPTH):
        raise ValueError(f"fused_stem: packed weights {packed.dtype} {tuple(packed.shape)} do "
                         f"not fit Cout {cout} (pack_stem_weights)")
    for t in (images, w, mult, bias, packed):
        if t.device != images.device or not t.is_contiguous():
            raise ValueError("fused_stem: operands must be contiguous, on one device")
    b, h, wd, _ = images.shape
    ho, wo = _out_hw(h, wd, 2)
    out = torch.empty(b, ho, wo, cout, dtype=torch.int8, device=images.device)
    lib = _build.load_library("fused_stem")
    fn = lib.spef_fused_stem
    fn.argtypes, fn.restype = _STEM_ARGTYPES, _I
    code = fn(images.data_ptr(), packed.data_ptr(), mult.data_ptr(), bias.data_ptr(),
              out.data_ptr(),
              b, h, wd, cout, inv_step, qmax,
              torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(lib, code, "fused_stem")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


# ---------------------------------------------------------------------------
# K4: fused inverted-residual block
# ---------------------------------------------------------------------------

_MB_KEYS = ("stride", "in_unsigned", "inv_h", "qmax_h", "inv_d", "qmax_d", "use_residual",
            "inv_sh", "qmax_sh", "ratio_out", "qmin_o", "qmax_o")


def _mbconv_depthwise(xc: torch.Tensor, wts: Dict[str, torch.Tensor], stride: int,
                      in_unsigned: bool, inv_h: Optional[float], qmax_h: float,
                      inv_d: Optional[float], qmax_d: float) -> torch.Tensor:
    """Expand and depthwise of K4's plain version: the depthwise output as
    the projection reads it (rounded to bf16, exact on a grid), float32
    ``(pixels, Ch)``."""
    _, h, wd, _ = xc.shape
    ho, wo = _out_hw(h, wd, stride)
    ch = wts["w3"].shape[0]
    w2f = wts["w2"].float()
    xf = _decode(xc, in_unsigned)
    if "w1" in wts:
        # Integer operands: float64 sums are exact in any order.
        acc = (xf.double() @ wts["w1"].double()).float()
        hid = acc * wts["m1"]
        hid = torch.clamp_min(hid + wts["b1"], 0.0)
        if inv_h is not None:
            hid = torch.clamp(torch.round(hid * _f32(inv_h)), 0.0, qmax_h)
    else:
        hid = xf
    # The halo is zeros of the HIDDEN tensor (not of the input: the
    # expand's bias would make it nonzero).
    hp = torch.nn.functional.pad(hid, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(xc.shape[0], ho, wo, ch, dtype=torch.float32, device=xc.device)
    for dy, dx, tap in _taps(hp, ho, wo, stride):
        acc = acc + tap * w2f[dy, dx]
    y = acc * wts["m2"]
    y = torch.clamp_min(y + wts["b2"], 0.0)
    if inv_d is not None:
        y = torch.clamp(torch.round(y * _f32(inv_d)), 0.0, qmax_d)
    return y.to(torch.bfloat16).float().reshape(-1, ch)


def _mbconv_finish(p: torch.Tensor, xc: torch.Tensor, wts: Dict[str, torch.Tensor],
                   use_residual: bool, inv_sh: float, qmax_sh: float,
                   ratio_out: Optional[float], qmin_o: float, qmax_o: float) -> torch.Tensor:
    """K4's epilogue on the projection's float32 sums ``p (pixels, Cout)``."""
    cout = p.shape[1]
    pf = p * wts["m3"]
    pf = (pf + wts["b3"]).view(xc.shape[0], -1, cout)
    if not use_residual:
        out = torch.clamp(torch.round(pf * _f32(ratio_out)), qmin_o, qmax_o)
        return out.to(torch.int8)
    # Exact shared-grid sum; never clamped to int8 before the residual.
    q = torch.clamp(torch.round(pf * _f32(inv_sh)), -qmax_sh - 1.0, qmax_sh)
    s = q + xc.float().view(xc.shape[0], -1, cout)
    if ratio_out is None:
        return torch.clamp(s, -128.0, 127.0).to(torch.int8)
    return torch.clamp(torch.round(s * _f32(ratio_out)), qmin_o, qmax_o).to(torch.int8)


def fused_mbconv_plain(
    x: torch.Tensor,  # (B, H, W, Cin) int8 values, or uint8 bits (in_unsigned)
    wts: Dict[str, torch.Tensor],
    # wts: "w1" (Cin, Ch) int8, "m1", "b1" (Ch,) f32 when the block expands;
    #      "w2" (3, 3, Ch) int8, "m2", "b2" (Ch,) f32;
    #      "w3" (Ch, Cout) int8, "m3", "b3" (Cout,) f32;
    #      every multiplier with its input step folded in.
    stride: int = 1,
    in_unsigned: bool = False,
    inv_h: Optional[float] = None,  # 1 / hidden step; None: the hidden tensor stays f32
    qmax_h: float = 127.0,
    inv_d: Optional[float] = None,  # 1 / depthwise step; None: real values into the project
    qmax_d: float = 127.0,
    use_residual: bool = False,
    inv_sh: float = 1.0,  # 1 / shared step (residual blocks)
    qmax_sh: float = 127.0,
    # shared step / consumer step with a residual (None: same step, the sum
    # is only clipped to int8); 1 / consumer step without one.
    ratio_out: Optional[float] = 1.0,
    qmin_o: float = -128.0,
    qmax_o: float = 127.0,
) -> torch.Tensor:
    """Plain PyTorch version of K4 (same arithmetic, any device)."""
    _, h, wd, _ = x.shape
    ho, wo = _out_hw(h, wd, stride)
    ch, cout = wts["w3"].shape
    w3f = wts["w3"].float()

    def run(xc: torch.Tensor) -> torch.Tensor:
        yb = _mbconv_depthwise(xc, wts, stride, in_unsigned, inv_h, qmax_h, inv_d, qmax_d)
        # bf16 x int8 products are exact in f32, so this in-place chain sums
        # them in k order with one rounding a step, fused or not.
        yb = yb.t().contiguous()
        p = torch.zeros(yb.shape[1], cout, dtype=torch.float32, device=xc.device)
        for k in range(ch):
            p.addcmul_(yb[k].unsqueeze(1), w3f[k])
        out = _mbconv_finish(p, xc, wts, use_residual, inv_sh, qmax_sh, ratio_out, qmin_o, qmax_o)
        return out.view(xc.shape[0], ho, wo, cout)

    _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out)
    return _by_image_chunks(run, x, 2 * h * wd * ch)


def fused_mbconv_rounding_input(
    x: torch.Tensor, wts: Dict[str, torch.Tensor], stride: int = 1, in_unsigned: bool = False,
    inv_h: Optional[float] = None, qmax_h: float = 127.0, inv_d: Optional[float] = None,
    qmax_d: float = 127.0, use_residual: bool = False, inv_sh: float = 1.0,
    qmax_sh: float = 127.0, ratio_out: Optional[float] = 1.0, qmin_o: float = -128.0,
    qmax_o: float = 127.0,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The value K4 rounds last, and how far a projection summed in another
    order may be from it: ``(v, eps, step)``, ``v`` and ``eps`` float64
    ``(B, Ho, Wo, Cout)``.

    ``v`` is ``pf * ratio_out`` (``pf * inv_sh`` with a residual), with the
    projection's sum taken in float64 from the same bf16 depthwise output
    and rounded once to float32, then the epilogue in float32 as the kernel
    does it.  A float32 sum of ``Ch`` exact products in any order is within
    ``Ch * 2^-24 * sum_k |y_k * w3_k|`` of it; ``eps`` doubles that (a tensor
    core truncates where an adder rounds), scales it by ``|m3 * scale|``,
    and adds ``8 * 2^-24 * |v|`` for the three float32 roundings after the
    sum, which a changed sum may flip.

    A kernel output may differ from :func:`fused_mbconv_plain`'s only where
    ``|v - (floor(v) + 0.5)| <= eps`` (:func:`tie_mismatches`), and there by
    at most ``step`` int8 steps.  ``step`` is 1 in every case but one: with
    a residual, the value rounded at the tie is the projection on the shared
    grid, and the sum it joins is requantized by ``ratio_out`` afterwards,
    so one shared-grid step becomes up to ``ceil(ratio_out)`` output steps
    where ``ratio_out`` is above 1 (2 at a ratio of 1.25).  No block of the
    flagship graph has such a ratio.
    """
    _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out)
    _, h, wd, _ = x.shape
    ho, wo = _out_hw(h, wd, stride)
    ch, cout = wts["w3"].shape
    w3d = wts["w3"].double()
    scale = _f32(inv_sh if use_residual else ratio_out)
    unit = 2.0 ** -24

    def run(xc: torch.Tensor) -> torch.Tensor:
        yd = _mbconv_depthwise(xc, wts, stride, in_unsigned, inv_h, qmax_h, inv_d,
                               qmax_d).double()
        pf = (yd @ w3d).float() * wts["m3"]
        v = ((pf + wts["b3"]) * scale).double()
        eps = (2.0 * ch * unit * abs(scale)) * (yd.abs() @ w3d.abs()) * wts["m3"].double().abs()
        eps = eps + 8.0 * unit * v.abs()
        return torch.stack([v, eps]).view(2, xc.shape[0], ho, wo, cout)

    n = max(1, _PLAIN_CHUNK_ELEMS // max(2 * h * wd * ch, 1))
    both = torch.cat([run(x[i:i + n]) for i in range(0, x.shape[0], n)], dim=1)
    step = 1 if (not use_residual or ratio_out is None) else max(1, math.ceil(ratio_out))
    return both[0], both[1], step


def _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out) -> None:
    """Shapes, types and option combinations K4 takes; raises otherwise."""
    if x.dtype != torch.int8 or x.dim() != 4 or stride not in (1, 2):
        raise ValueError(f"fused_mbconv: x must be int8 (B, H, W, Cin), stride 1 or 2; got "
                         f"{x.dtype} {tuple(x.shape)}, stride {stride}")
    cin = x.shape[-1]
    w2, w3 = wts["w2"], wts["w3"]
    ch, cout = w3.shape
    if w2.dtype != torch.int8 or w2.shape != (3, 3, ch) or w3.dtype != torch.int8:
        raise ValueError(f"fused_mbconv: w2 must be int8 (3, 3, {ch}) and w3 int8 (Ch, Cout)")
    if "w1" in wts:
        if wts["w1"].dtype != torch.int8 or wts["w1"].shape != (cin, ch):
            raise ValueError(f"fused_mbconv: w1 must be int8 ({cin}, {ch})")
    elif ch != cin:
        raise ValueError(f"fused_mbconv: no expand needs Ch == Cin, got {ch} and {cin}")
    sizes = {"m1": ch, "b1": ch, "m2": ch, "b2": ch, "m3": cout, "b3": cout}
    for name, n in sizes.items():
        if name in ("m1", "b1") and "w1" not in wts:
            continue
        if wts[name].dtype != torch.float32 or wts[name].shape != (n,):
            raise ValueError(f"fused_mbconv: {name} must be float32 ({n},)")
    if use_residual and (stride != 1 or cin != cout or in_unsigned):
        # The residual is read back from the input as signed int8.
        raise ValueError("fused_mbconv: a residual needs stride 1, Cin == Cout and a signed input")
    if not use_residual and ratio_out is None:
        raise ValueError("fused_mbconv: ratio_out=None only with a residual")
    for t in (x, *wts.values()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_mbconv: operands must be contiguous, on one device")


# ---- K4's weight layouts -----------------------------------------------------

_CK = 32  # hidden channels a chunk of the kernel; the int8 mma depth
_K_DEPTH = 32  # Cin is padded with zeros to the int8 mma depth
_N_TILE = 8  # Cout is padded to the mma's 8 columns
_ROW_PAD = 16  # bytes added in shared memory to a row ldmatrix reads


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _mbconv_layouts(wts: Dict[str, torch.Tensor], dw_grid: bool) -> Dict[str, torch.Tensor]:
    """The pieces of the kernel's weight blob, before they are laid side by
    side.  ``w1p`` (with an expand): ``w1`` transposed to ``(Ch, Cin)`` int8,
    K = Cin innermost, Ch padded with zeros to the chunk (32) and Cin to the
    int8 mma depth (32).  ``w3p``: ``w3`` as ``(chunks, Cout, 32)``, the
    chunk's k innermost, Cout padded to 8 and Ch to the chunk; bf16 (int8
    values are exact in bf16) for a real-valued depthwise output, int8 where
    it is on a grid (``dw_grid``).  ``aux``: ``(chunks, 13, 32)`` float32, a
    chunk's ``m1``, ``b1``, ``m2``, ``b2`` and the nine taps of ``w2`` (as
    float32), zeros past Ch.  ``aux3``: ``(2, Cout padded to 8)`` float32,
    ``m3`` and ``b3``."""
    w3 = wts["w3"]
    ch, cout = w3.shape
    chp, coutp = _round_up(ch, _CK), _round_up(cout, _N_TILE)
    out = {}
    if "w1" in wts:
        cin = wts["w1"].shape[0]
        w1p = torch.zeros(chp, _round_up(cin, _K_DEPTH), dtype=torch.int8, device=w3.device)
        w1p[:ch, :cin] = wts["w1"].t()
        out["w1p"] = w1p
    w3z = torch.zeros(chp, coutp, dtype=torch.int8, device=w3.device)
    w3z[:ch, :cout] = w3
    w3p = w3z.view(chp // _CK, _CK, coutp).permute(0, 2, 1).contiguous()
    out["w3p"] = w3p if dw_grid else w3p.to(torch.bfloat16)
    aux = torch.zeros(13, chp, dtype=torch.float32, device=w3.device)
    if "w1" in wts:
        aux[0, :ch], aux[1, :ch] = wts["m1"], wts["b1"]
    aux[2, :ch], aux[3, :ch] = wts["m2"], wts["b2"]
    aux[4:, :ch] = wts["w2"].reshape(9, ch).float()
    out["aux"] = aux.view(13, chp // _CK, _CK).permute(1, 0, 2).contiguous()
    aux3 = torch.zeros(2, coutp, dtype=torch.float32, device=w3.device)
    aux3[0, :cout], aux3[1, :cout] = wts["m3"], wts["b3"]
    out["aux3"] = aux3
    return out


def _mbconv_blob_sizes(wts: Dict[str, torch.Tensor], dw_grid: bool) -> Tuple[int, int, int]:
    """Bytes a chunk of the weight blob gives to its ``w1`` rows, its ``w3``
    rows and its small operands."""
    kpad = _round_up(wts["w1"].shape[0], _K_DEPTH) if "w1" in wts else 0
    coutp = _round_up(wts["w3"].shape[1], _N_TILE)
    w3_row = (_CK if dw_grid else 2 * _CK) + _ROW_PAD
    return (_CK * (kpad + _ROW_PAD) if "w1" in wts else 0), coutp * w3_row, 13 * _CK * 4


def pack_mbconv_weights(wts: Dict[str, torch.Tensor], dw_grid: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """``wts`` plus the two tensors the kernel reads.

    ``wblob``: ``(chunks, bytes)`` uint8: a chunk's 32 rows of ``w1`` (K =
    Cin innermost, padded with zeros to the int8 mma depth), its Cout rows
    of ``w3`` (the chunk's 32 k innermost; bf16, or int8 with ``dw_grid``)
    and its small operands (:func:`_mbconv_layouts`), one after the other,
    every weight row followed by the 16 bytes of padding it has in shared
    memory, so that a chunk arrives as one run of 16-byte copies.
    ``aux3``: ``m3`` and ``b3``.  Plain PyTorch, any device; done once when
    a forward is built, or by :func:`fused_mbconv` for a caller that passes
    unpacked weights.
    """
    lay = _mbconv_layouts(wts, dw_grid)
    chunks = lay["aux"].shape[0]

    def padded_rows(t: torch.Tensor) -> torch.Tensor:
        width = t.shape[-1] * t.element_size()
        rows = t.contiguous().view(torch.uint8).reshape(chunks, -1, width)
        return torch.nn.functional.pad(rows, (0, _ROW_PAD)).flatten(1)

    parts = [padded_rows(lay["w1p"])] if "w1" in wts else []
    parts += [padded_rows(lay["w3p"]), lay["aux"].view(torch.uint8).flatten(1)]
    wblob = torch.cat(parts, dim=1).contiguous()
    assert wblob.shape[1] == sum(_mbconv_blob_sizes(wts, dw_grid))
    return dict(wts, wblob=wblob, aux3=lay["aux3"])


def unpack_mbconv_weights(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``w1`` / ``w3`` (int8) read back from ``wblob``: the inverse of
    :func:`pack_mbconv_weights` on those keys."""
    blob = packed["wblob"]
    ch, cout = packed["w3"].shape
    dw_grid = blob.shape[1] == sum(_mbconv_blob_sizes(packed, True))
    sizes = _mbconv_blob_sizes(packed, dw_grid)
    b1, b3, _ = blob.split(sizes, dim=1)
    row = (_CK if dw_grid else 2 * _CK)
    w3p = b3.reshape(blob.shape[0], -1, row + _ROW_PAD)[..., :row].contiguous()
    w3p = w3p.view(torch.int8 if dw_grid else torch.bfloat16)
    out = {"w3": w3p.permute(0, 2, 1).reshape(-1, w3p.shape[1])[:ch, :cout].to(torch.int8)}
    if "w1" in packed:
        cin = packed["w1"].shape[0]
        w1p = b1.reshape(blob.shape[0] * _CK, -1)[:, :-_ROW_PAD].view(torch.int8)
        out["w1"] = w1p[:ch, :cin].t().contiguous()
    return out


# ---- K4's tile choice ----------------------------------------------------------

MBCONV_SMEM_MAX = 232448  # 227 KB: the most a block may use
_SM_COUNT = 132
_SM_SMEM = 233472  # 228 KB an SM, 1 KB reserved a block
_WARPS = 8
_HS = _CK + 8  # floats a row of the hidden chunk
# (MI, NI) accumulator tiles a warp of each instantiation, and the blocks an
# SM that its registers allow.
_MB_VARIANTS = ((1, 4, 2), (2, 4, 2), (2, 6, 2), (3, 10, 1))
_TILE_SIZES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16, 20, 24, 30, 32)


def mbconv_warp_grid(pixels: int, cout: int) -> Optional[Tuple[int, int, int, int, int]]:
    """``(mi, ni, wm, wn, blocks an SM)`` of the projection for a tile of
    ``pixels`` outputs: the first instantiation whose ``wm x wn`` warps with
    ``mi x ni`` accumulator tiles each cover ``(pixels / 16, Cout / 8)``;
    None if no instantiation does.  Mirrors ``warp_grid`` in the source."""
    mtiles, ntiles = -(-pixels // 16), _round_up(cout, _N_TILE) // _N_TILE
    for mi, ni, resident in _MB_VARIANTS:
        wn = 1
        while wn * ni < ntiles:
            wn *= 2
        if wn <= _WARPS and mtiles <= (_WARPS // wn) * mi:
            return mi, ni, _WARPS // wn, wn, resident
    return None


def mbconv_smem_bytes(th: int, tw: int, cin: int, cout: int, stride: int, expand: bool = True,
                      dw_grid: bool = False, residual: bool = False) -> int:
    """Shared memory one block of K4 needs for a ``th x tw`` output tile (two
    input tiles with a residual: the epilogue reads one while the next
    arrives).  Mirrors ``layout`` in the source."""
    ph = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
    xs_stride = _round_up(cin, _K_DEPTH) + _ROW_PAD
    row = (_CK if dw_grid else 2 * _CK) + _ROW_PAD
    xs = _round_up(ph * xs_stride, 16) * (2 if residual else 1)
    w1s = 2 * _CK * xs_stride if expand else 0
    coutp = _round_up(cout, _N_TILE)
    # The depthwise may read two pixels past the hidden chunk; the finished
    # tile's int8 staging rows lie over it.
    hid = max(_round_up((ph + 2) * _HS * 4, 16), _round_up(th * tw * coutp, 16))
    dwo = -(-th * tw // 16) * 16 * row
    w3s = 2 * coutp * row
    aux = 2 * 13 * _CK * 4 + coutp * 8
    return xs + w1s + hid + dwo + w3s + aux


def _mbconv_tile_cost(batch, ho, wo, cin, ch, cout, stride, expand, dw_grid, residual, th, tw
                      ) -> Optional[float]:
    """Scheduler slots one launch spends with this tile, in the kernel's units:
    mma tiles of 16 pixels for the two products, the nine taps along the
    pieces of rows its warps walk, two barriers a chunk, and the blocks a
    wave on the SMs.  None if the tile does not fit.

    The weights below (slots an mma, an ldmatrix, a barrier, a depthwise
    column, a block's fixed cost, the share one block alone loses to
    latency) are fitted: to this kernel's timings over its candidate tiles
    at the flagship's 17 block shapes, batch 256, on an H100.  They rank
    tiles; they are no prediction of time, and a measured per-shape table
    is what should replace them."""
    grid = mbconv_warp_grid(th * tw, cout)
    smem = mbconv_smem_bytes(th, tw, cin, cout, stride, expand, dw_grid, residual)
    if grid is None or smem > MBCONV_SMEM_MAX:
        return None
    mi, ni, wm, wn, resident = grid
    mma, ldm, barrier = 6.0, 8.0, 60.0
    ph = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
    kpad, coutp = _round_up(cin, _K_DEPTH), _round_up(cout, _N_TILE)
    nchunks = -(-ch // _CK)
    if expand:
        rounds = -(-(-(-ph // 16)) // _WARPS)
        hidden = rounds * (kpad // 32 * (4 * mma + 3 * ldm) + 16 * 12.0)
    else:
        hidden = -(-ph // _WARPS) * 6.0
    # The depthwise walks groups of rows (four at stride 1 where every warp
    # still gets a piece and the accumulators leave registers for the larger
    # patch, else two) and two columns at a time.
    for rows in (4, 2):
        groups = -(-th // rows)
        nseg = 1 if groups >= _WARPS else min((tw + 1) // 2, -(-_WARPS // groups))
        seg = (-(-tw // nseg) + 1) // 2 * 2
        nseg = -(-tw // seg)
        if stride == 1 and mi * ni <= 8 and groups * nseg >= _WARPS:
            break
    per_column = 62.0 if stride == 2 else (56.0 if rows == 2 else 112.0)
    taps = -(-groups * nseg // _WARPS) * (seg * per_column + 30.0) + 15.0
    mi_used = -(-(-(-th * tw // 16)) // wm)
    ni_used = min(ni, -(-coutp // 8 // wn) if wn > 1 else coutp // 8)
    project = mi_used * (2 * ldm + ni_used * (ldm + 2 * mma))
    copies = (_CK * kpad * expand + coutp * 2 * _CK) / 16.0 / 256.0 * 6.0
    block = nchunks * (hidden + taps + project + copies + 2 * barrier)
    block += ph * kpad / 16.0 / 256.0 * 10.0 + mi_used * ni_used * 50.0 + 300.0
    resident = max(1, min(resident, _SM_SMEM // (smem + 1024)))
    blocks = batch * (-(-ho // th)) * (-(-wo // tw))
    waves = -(-blocks // (_SM_COUNT * resident))
    # Two blocks an SM share its scheduler slots but hide each other's latency;
    # one block alone loses about a third to it.
    return waves * block * resident / min(1.0, 0.5 + 0.5 * resident * _WARPS / 16.0)


@functools.lru_cache(maxsize=None)
def ranked_mbconv_tiles(batch: int, h: int, w: int, cin: int, ch: int, cout: int, stride: int,
                        expand: bool = True, dw_grid: bool = False, residual: bool = False
                        ) -> Tuple[Tuple[int, int], ...]:
    """Every output tile ``(th, tw)`` whose shared memory and accumulator
    registers fit, cheapest first by the cost model above (equal costs in
    the order the sizes are walked)."""
    ho, wo = _out_hw(h, w, stride)
    costs = []
    for th in sorted({min(s, ho) for s in _TILE_SIZES}):
        for tw in sorted({min(s, wo) for s in _TILE_SIZES}):
            cost = _mbconv_tile_cost(batch, ho, wo, cin, ch, cout, stride, expand, dw_grid,
                                     residual, th, tw)
            if cost is not None:
                costs.append((cost, th, tw))
    costs.sort(key=lambda c: c[0])
    return tuple((th, tw) for _, th, tw in costs)


def choose_mbconv_tile(batch: int, h: int, w: int, cin: int, ch: int, cout: int, stride: int,
                       expand: bool = True, dw_grid: bool = False, residual: bool = False
                       ) -> Tuple[int, int]:
    """The output tile ``(th, tw)`` K4 runs one block on when the caller
    names none: the cheapest by the cost model (:func:`ranked_mbconv_tiles`).
    Raises if no tile fits (Cout above 640)."""
    ranked = ranked_mbconv_tiles(batch, h, w, cin, ch, cout, stride, expand, dw_grid, residual)
    if not ranked:
        raise ValueError(f"fused_mbconv: no tile fits Cin {cin}, Ch {ch}, Cout {cout}")
    return ranked[0]


def check_mbconv_tile(tile: Tuple[int, int], h: int, w: int, cin: int, cout: int, stride: int,
                      expand: bool = True, dw_grid: bool = False, residual: bool = False) -> None:
    """Raise unless K4 can run this ``(th, tw)`` output tile: at most the
    output's size, an instantiation's accumulator registers
    (:func:`mbconv_warp_grid`) and the shared memory of a block
    (:func:`mbconv_smem_bytes`)."""
    th, tw = (int(t) for t in tile)
    ho, wo = _out_hw(h, w, stride)
    if not (1 <= th <= ho and 1 <= tw <= wo):
        raise ValueError(f"fused_mbconv: tile {th}x{tw} is outside the {ho}x{wo} output")
    if mbconv_warp_grid(th * tw, cout) is None:
        raise ValueError(f"fused_mbconv: tile {th}x{tw} with Cout {cout} needs more "
                         f"accumulator registers than a block has")
    smem = mbconv_smem_bytes(th, tw, cin, cout, stride, expand, dw_grid, residual)
    if smem > MBCONV_SMEM_MAX:
        raise ValueError(f"fused_mbconv: tile {th}x{tw} needs {smem} bytes of shared memory, "
                         f"above {MBCONV_SMEM_MAX}")


def fused_mbconv(
    x: torch.Tensor,
    wts: Dict[str, torch.Tensor],
    stride: int = 1,
    in_unsigned: bool = False,
    inv_h: Optional[float] = None,
    qmax_h: float = 127.0,
    inv_d: Optional[float] = None,
    qmax_d: float = 127.0,
    use_residual: bool = False,
    inv_sh: float = 1.0,
    qmax_sh: float = 127.0,
    ratio_out: Optional[float] = 1.0,
    qmin_o: float = -128.0,
    qmax_o: float = 127.0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """K4: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``(B, H, W, Cin)`` int8 -> ``(B, Ho, Wo, Cout)`` int8 on the consumer's
    grid.  Three output cases: no residual, ``clip(rint(pf * ratio_out))``;
    residual, the projection goes to the shared grid, the int8 input is
    added exactly, and the sum is requantized by ``ratio_out`` — or only
    clipped to int8 when ``ratio_out`` is None (same step).  ``wts`` may be
    packed already (:func:`pack_mbconv_weights`, with ``dw_grid`` set as
    ``inv_d`` is); unpacked weights are packed here, on every call.

    ``tile`` is the ``(th, tw)`` output tile of a block of the kernel; a
    tile that does not fit raises (:func:`check_mbconv_tile`).  None takes
    the cost model's choice (:func:`choose_mbconv_tile`).  The plain version
    has no tile: a CPU tensor ignores it.
    """
    kw = dict(stride=stride, in_unsigned=in_unsigned, inv_h=inv_h, qmax_h=qmax_h, inv_d=inv_d,
              qmax_d=qmax_d, use_residual=use_residual, inv_sh=inv_sh, qmax_sh=qmax_sh,
              ratio_out=ratio_out, qmin_o=qmin_o, qmax_o=qmax_o)
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, wts, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv: unsupported device {x.device}")
    _build.refuse_tracing("fused_mbconv", x)
    _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out)
    dw_grid = inv_d is not None
    if "wblob" not in wts:
        wts = pack_mbconv_weights(wts, dw_grid)
    if wts["wblob"].shape[1] != sum(_mbconv_blob_sizes(wts, dw_grid)):
        raise ValueError("fused_mbconv: the weights were packed for the other projection "
                         "(int8 w3 with a depthwise grid, bf16 without)")
    b, h, wd, cin = x.shape
    ch, cout = wts["w3"].shape
    ho, wo = _out_hw(h, wd, stride)
    expand = "w1" in wts
    if tile is None:
        th, tw = choose_mbconv_tile(b, h, wd, cin, ch, cout, stride, expand, dw_grid,
                                    use_residual)
    else:
        check_mbconv_tile(tile, h, wd, cin, cout, stride, expand, dw_grid, use_residual)
        th, tw = (int(t) for t in tile)
    out = torch.empty(b, ho, wo, cout, dtype=torch.int8, device=x.device)
    out_mode = 0 if not use_residual else (2 if ratio_out is None else 1)
    lib = _build.load_library("fused_mbconv")
    fn = lib.spef_fused_mbconv
    fn.argtypes, fn.restype = _MBCONV_ARGTYPES, _I
    code = fn(x.data_ptr(), int(in_unsigned), wts["wblob"].data_ptr(), wts["aux3"].data_ptr(),
              out.data_ptr(),
              b, h, wd, cin, ch, cout, stride, int(expand),
              int(inv_h is not None), 1.0 if inv_h is None else inv_h, qmax_h,
              int(dw_grid), 1.0 if inv_d is None else inv_d, qmax_d,
              out_mode, inv_sh, qmax_sh, 1.0 if ratio_out is None else ratio_out, qmin_o, qmax_o,
              th, tw, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "fused_mbconv")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
