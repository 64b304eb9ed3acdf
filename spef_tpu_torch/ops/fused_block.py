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

  * integer operands (the stem's pixels, the expand's input) sum exactly;
  * the hidden tensor stays float32 unless the expand has an activation
    grid; the depthwise sums its nine taps in (dy, dx) order in float32,
    each product rounded before it is added (it is inexact on a float32
    hidden tensor, so a fused multiply-add would change it);
  * the depthwise output is rounded to bf16 (exact on a grid) and the
    projection sums its exact products in float32 in k order 0..K-1;
  * ``y = acc * mult + bias`` is a rounded multiply then a rounded add;
    rounding to a grid is half to even; every scalar is the host's double
    rounded once to float32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from spef_tpu_torch.ops import _build
from spef_tpu_torch.ops.int8_ops import _decode, _encode_bits, _f32

__all__ = ["fused_stem", "fused_stem_plain", "fused_mbconv", "fused_mbconv_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_STEM_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]
_MBCONV_ARGTYPES = ([_P, _I] + [_P] * 10 + [_I] * 7 + [_I, _F, _F] * 2 + [_I] + [_F] * 5 + [_P])

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


def fused_stem_plain(
    images: torch.Tensor,  # (B, H, W, 3) uint8
    w: torch.Tensor,  # (3, 3, 3, Cout) int8, HWIO
    mult: torch.Tensor,  # (Cout,) f32, 1/255 folded in
    bias: torch.Tensor,  # (Cout,) f32
    inv_step: float = 1.0,  # 1 / stem activation step
    qmax: float = 127.0,  # > 127: the output is uint8 bits in int8
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arithmetic, any device)."""
    _, h, wd, _ = images.shape
    ho, wo = _out_hw(h, wd, 2)
    cout = w.shape[-1]
    wdbl = w.double()

    def run(img: torch.Tensor) -> torch.Tensor:
        # Integer pixels times integer weights: float64 sums are exact.
        xp = torch.nn.functional.pad(img.double(), (0, 0, 1, 1, 1, 1))
        acc = torch.zeros(img.shape[0], ho, wo, cout, dtype=torch.float64, device=img.device)
        for dy, dx, tap in _taps(xp, ho, wo, 2):
            acc += tap @ wdbl[dy, dx]
        y = acc.float() * mult
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
) -> torch.Tensor:
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``(B, H, W, 3)`` uint8 -> ``(B, Ho, Wo, Cout)`` int8 on the stem
    activation grid (uint8 bits when ``qmax > 127``).
    """
    if images.device.type == "cpu":
        return fused_stem_plain(images, w, mult, bias, inv_step, qmax)
    if images.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {images.device}")
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"fused_stem: images must be uint8 (B, H, W, 3), got "
                         f"{images.dtype} {tuple(images.shape)}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"fused_stem: w must be int8 (3, 3, 3, Cout), got {tuple(w.shape)}")
    cout = w.shape[-1]
    for name, t in (("mult", mult), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (cout,):
            raise ValueError(f"fused_stem: {name} must be float32 ({cout},)")
    for t in (images, w, mult, bias):
        if t.device != images.device or not t.is_contiguous():
            raise ValueError("fused_stem: operands must be contiguous, on one device")
    b, h, wd, _ = images.shape
    ho, wo = _out_hw(h, wd, 2)
    out = torch.empty(b, ho, wo, cout, dtype=torch.int8, device=images.device)
    lib = _build.load_library("fused_stem")
    fn = lib.spef_fused_stem
    fn.argtypes, fn.restype = _STEM_ARGTYPES, _I
    code = fn(images.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(), out.data_ptr(),
              b, h, wd, cout, inv_step, qmax,
              torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(lib, code, "fused_stem")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


# ---------------------------------------------------------------------------
# K4: fused inverted-residual block
# ---------------------------------------------------------------------------


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
    w2f, w3f = wts["w2"].float(), wts["w3"].float()

    def run(xc: torch.Tensor) -> torch.Tensor:
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
        # bf16 x int8 products are exact in f32, so this in-place chain sums
        # them in k order with one rounding a step, fused or not.
        yb = y.to(torch.bfloat16).float().reshape(-1, ch).t().contiguous()
        p = torch.zeros(yb.shape[1], cout, dtype=torch.float32, device=xc.device)
        for k in range(ch):
            p.addcmul_(yb[k].unsqueeze(1), w3f[k])
        pf = p * wts["m3"]
        pf = (pf + wts["b3"]).view(xc.shape[0], ho, wo, cout)
        if not use_residual:
            return torch.clamp(torch.round(pf * _f32(ratio_out)), qmin_o, qmax_o).to(torch.int8)
        # Exact shared-grid sum; never clamped to int8 before the residual.
        q = torch.clamp(torch.round(pf * _f32(inv_sh)), -qmax_sh - 1.0, qmax_sh)
        s = q + xc.float()
        if ratio_out is None:
            return torch.clamp(s, -128.0, 127.0).to(torch.int8)
        return torch.clamp(torch.round(s * _f32(ratio_out)), qmin_o, qmax_o).to(torch.int8)

    _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out)
    return _by_image_chunks(run, x, 2 * h * wd * ch)


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
) -> torch.Tensor:
    """K4: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``(B, H, W, Cin)`` int8 -> ``(B, Ho, Wo, Cout)`` int8 on the consumer's
    grid.  Three output cases: no residual, ``clip(rint(pf * ratio_out))``;
    residual, the projection goes to the shared grid, the int8 input is
    added exactly, and the sum is requantized by ``ratio_out`` — or only
    clipped to int8 when ``ratio_out`` is None (same step).
    """
    kw = dict(stride=stride, in_unsigned=in_unsigned, inv_h=inv_h, qmax_h=qmax_h, inv_d=inv_d,
              qmax_d=qmax_d, use_residual=use_residual, inv_sh=inv_sh, qmax_sh=qmax_sh,
              ratio_out=ratio_out, qmin_o=qmin_o, qmax_o=qmax_o)
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, wts, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv: unsupported device {x.device}")
    _check_mbconv(x, wts, stride, in_unsigned, use_residual, ratio_out)
    b, h, wd, cin = x.shape
    ch, cout = wts["w3"].shape
    ho, wo = _out_hw(h, wd, stride)
    out = torch.empty(b, ho, wo, cout, dtype=torch.int8, device=x.device)
    expand = "w1" in wts
    out_mode = 0 if not use_residual else (2 if ratio_out is None else 1)
    lib = _build.load_library("fused_mbconv")
    fn = lib.spef_fused_mbconv
    fn.argtypes, fn.restype = _MBCONV_ARGTYPES, _I
    ptr = lambda name: wts[name].data_ptr()  # noqa: E731
    code = fn(x.data_ptr(), int(in_unsigned),
              ptr("w1") if expand else None, ptr("m1") if expand else None,
              ptr("b1") if expand else None,
              ptr("w2"), ptr("m2"), ptr("b2"), ptr("w3"), ptr("m3"), ptr("b3"), out.data_ptr(),
              b, h, wd, cin, ch, cout, stride,
              int(inv_h is not None), 1.0 if inv_h is None else inv_h, qmax_h,
              int(inv_d is not None), 1.0 if inv_d is None else inv_d, qmax_d,
              out_mode, inv_sh, qmax_sh, 1.0 if ratio_out is None else ratio_out, qmin_o, qmax_o,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "fused_mbconv")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
