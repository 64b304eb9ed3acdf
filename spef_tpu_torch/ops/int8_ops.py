"""Hand-written CUDA kernels of the int8 inference path, with their plain twins.

Counterpart of ``spef_tpu.ops.pallas.int8_ops``:

  * :func:`int8_matmul_requant` (K1, ``csrc/int8_matmul_requant.cu``) —
    integer matmul with the whole requant epilogue fused: every 1x1
    convolution (expand / project / head conv).
  * :func:`int8_depthwise3x3` (K2, ``csrc/int8_depthwise3x3.cu``) — 3x3
    depthwise convolution, stride 1 or 2, int8 / bits / real input,
    int8 / bits / bf16 output.

Each wrapper launches its kernel for CUDA tensors (raising on a CUDA error,
never falling back) and runs the ``*_plain`` version for CPU tensors.  The
plain versions are the kernels' arithmetic written in PyTorch: the CPU tests
hold them against the JAX kernels, and ``chip_smoke.py`` holds the kernels
against them on the card.  Each wrapper counts its kernel launches in its
``launches`` attribute.

Numerics shared by both versions (and by the JAX kernels): integer sums are
exact; real-valued (bf16) operands give exact f32 products summed in f32 in a
fixed order (k = 0..K-1; taps in (dy, dx) order); ``y = acc * mult + bias``
is a rounded multiply then a rounded add, never a fused multiply-add;
rounding is half to even.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from spef_tpu_torch.ops import _build

__all__ = [
    "int8_matmul_requant", "int8_matmul_requant_plain",
    "int8_depthwise3x3", "int8_depthwise3x3_plain",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_MM_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P]
_DW_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P]


def _encode_bits(q: torch.Tensor) -> torch.Tensor:
    """Unsigned q in [0, 255] (f32) -> its uint8 bits in an int8 container."""
    return torch.where(q > 127.0, q - 256.0, q).to(torch.int8)


def _decode(x: torch.Tensor, in_unsigned: bool) -> torch.Tensor:
    """int8 values, or uint8 bits in int8 (``in_unsigned``), -> float32."""
    xf = x.float()
    return xf + 256.0 * (xf < 0) if in_unsigned else xf


def _f32(v: float) -> float:
    """A Python float rounded to float32 — what a kernel argument receives."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# K1: fused matmul + requant
# ---------------------------------------------------------------------------


def _mm_acc_plain(x: torch.Tensor, w: torch.Tensor, in_unsigned: bool) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        # Exact bf16 x int8 products summed in f32 in k order, the kernel's
        # order: an in-place addcmul chain (each product is exact, so fused
        # or not the add is the only rounding).
        xf, wf = x.float(), w.float()
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
        for k in range(x.shape[1]):
            acc.addcmul_(xf[:, k:k + 1], wf[k])
        return acc
    # Integer operands: float64 sums of integers below 2^53 are exact in any
    # order, so this equals the kernel's int32 sum.
    return (_decode(x, in_unsigned).double() @ w.double()).float()


def int8_matmul_requant_plain(
    x: torch.Tensor,  # (M, K) int8 (values or uint8 bits) or bf16 real values
    w: torch.Tensor,  # (K, N) int8
    mult: torch.Tensor,  # (N,) f32 = s_in * s_w * |g|
    bias: torch.Tensor,  # (N,) f32
    residual: Optional[torch.Tensor] = None,  # (M, N) int8 on the shared grid
    relu: bool = True,
    out_inv_step: Optional[float] = None,  # None -> f32 output (no requant)
    out_qmax: float = 127.0,
    out_qmin: float = 0.0,
    res_ratio: float = 1.0,
    res_qmax: float = 127.0,
    res_qmin: float = -128.0,
    in_unsigned: bool = False,
    out_bits: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arithmetic, any device)."""
    acc = _mm_acc_plain(x, w, in_unsigned)
    y = acc * mult
    y = y + bias
    if residual is not None and out_inv_step is not None:
        # Exact shared-grid sum, requantized straight to the consumer grid
        # (never clamped to int8 on the shared grid first).
        q = torch.clamp(torch.round(y * _f32(out_inv_step)), out_qmin, out_qmax)
        s = q + residual.float()
        return torch.clamp(torch.round(s * _f32(res_ratio)), res_qmin, res_qmax).to(torch.int8)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_inv_step is None:
        return y
    q = torch.clamp(torch.round(y * _f32(out_inv_step)), out_qmin, out_qmax)
    return _encode_bits(q) if out_bits else q.to(torch.int8)


def int8_matmul_requant(
    x: torch.Tensor,
    w: torch.Tensor,
    mult: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
    out_inv_step: Optional[float] = None,
    out_qmax: float = 127.0,
    out_qmin: float = 0.0,
    res_ratio: float = 1.0,
    res_qmax: float = 127.0,
    res_qmin: float = -128.0,
    in_unsigned: bool = False,
    out_bits: bool = False,
) -> torch.Tensor:
    """K1: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Output: (M, N) int8 (bits when ``out_bits``), or f32 when
    ``out_inv_step`` is None.  ``residual`` (int8 on the shared grid) selects
    the projection + residual variant; it ignores ``relu``, like the JAX one.
    """
    kw = dict(residual=residual, relu=relu, out_inv_step=out_inv_step, out_qmax=out_qmax,
              out_qmin=out_qmin, res_ratio=res_ratio, res_qmax=res_qmax, res_qmin=res_qmin,
              in_unsigned=in_unsigned, out_bits=out_bits)
    if x.device.type == "cpu":
        return int8_matmul_requant_plain(x, w, mult, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_requant: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul_requant: shapes {tuple(x.shape)} x {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype == torch.int8:
        x_mode = 1 if in_unsigned else 0
    elif x.dtype == torch.bfloat16 and not in_unsigned:
        x_mode = 2
    else:
        raise ValueError(f"int8_matmul_requant: x dtype {x.dtype} (in_unsigned={in_unsigned})")
    if w.dtype != torch.int8:
        raise ValueError(f"int8_matmul_requant: w dtype {w.dtype}")
    for name, t in (("mult", mult), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"int8_matmul_requant: {name} must be float32 ({n},)")
    tensors = [x, w, mult, bias]
    if out_inv_step is None:
        out_mode, out = 2, torch.empty(m, n, dtype=torch.float32, device=x.device)
    else:
        out = torch.empty(m, n, dtype=torch.int8, device=x.device)
        if residual is not None:
            if residual.dtype != torch.int8 or residual.shape != (m, n):
                raise ValueError("int8_matmul_requant: residual must be int8 (M, N)")
            out_mode = 3
            tensors.append(residual)
        else:
            out_mode = 1 if out_bits else 0
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_matmul_requant: operands must be contiguous, on one device")
    lib = _build.load_library("int8_matmul_requant")
    fn = lib.spef_int8_matmul_requant
    fn.argtypes, fn.restype = _MM_ARGTYPES, _I
    code = fn(x.data_ptr(), x_mode, w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
              residual.data_ptr() if out_mode == 3 else None, out.data_ptr(), out_mode,
              m, n, k, int(relu), 0.0 if out_inv_step is None else out_inv_step,
              out_qmin, out_qmax, res_ratio, res_qmin, res_qmax,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "int8_matmul_requant")
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0


# ---------------------------------------------------------------------------
# K2: 3x3 depthwise + requant
# ---------------------------------------------------------------------------


def int8_depthwise3x3_plain(
    x: torch.Tensor,  # (B, H, W, C) int8 (values or uint8 bits) or f32 real values
    w: torch.Tensor,  # (3, 3, C) int8
    mult: torch.Tensor,  # (C,) f32 = s_w * |g|  (input step passed separately)
    bias: torch.Tensor,  # (C,) f32
    stride: int = 1,
    in_step: float = 1.0,
    out_inv_step: Optional[float] = 1.0,  # None -> bf16 real-valued output
    out_qmax: float = 127.0,
    in_unsigned: bool = False,
    out_bits: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arithmetic, any device)."""
    if x.dtype.is_floating_point:
        xf = x.to(torch.bfloat16).float()  # the bf16 operand cast of xla_depthwise3x3
    else:
        xf = _decode(x, in_unsigned)
    b, h, wd, c = xf.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(b, ho, wo, c, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            acc = acc + tap * wf[dy, dx]
    y = acc * (mult * _f32(in_step))
    y = torch.clamp_min(y + bias, 0.0)
    if out_inv_step is None:
        return y.to(torch.bfloat16)
    q = torch.clamp(torch.round(y * _f32(out_inv_step)), 0.0, out_qmax)
    return _encode_bits(q) if out_bits else q.to(torch.int8)


def int8_depthwise3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    mult: torch.Tensor,
    bias: torch.Tensor,
    stride: int = 1,
    in_step: float = 1.0,
    out_inv_step: Optional[float] = 1.0,
    out_qmax: float = 127.0,
    in_unsigned: bool = False,
    out_bits: bool = False,
) -> torch.Tensor:
    """K2: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Output (B, Ho, Wo, C): int8 (bits when ``out_bits``), or bf16 when
    ``out_inv_step`` is None.
    """
    kw = dict(stride=stride, in_step=in_step, out_inv_step=out_inv_step, out_qmax=out_qmax,
              in_unsigned=in_unsigned, out_bits=out_bits)
    if x.device.type == "cpu":
        return int8_depthwise3x3_plain(x, w, mult, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_depthwise3x3: unsupported device {x.device}")
    if x.dim() != 4 or stride not in (1, 2):
        raise ValueError(f"int8_depthwise3x3: x {tuple(x.shape)}, stride {stride}")
    b, h, wd, c = x.shape
    if x.dtype == torch.int8:
        x_mode = 1 if in_unsigned else 0
    elif x.dtype == torch.float32 and not in_unsigned:
        x_mode = 2
    else:
        raise ValueError(f"int8_depthwise3x3: x dtype {x.dtype} (in_unsigned={in_unsigned})")
    if w.dtype != torch.int8 or w.shape != (3, 3, c):
        raise ValueError(f"int8_depthwise3x3: w must be int8 (3, 3, {c})")
    for name, t in (("mult", mult), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError(f"int8_depthwise3x3: {name} must be float32 ({c},)")
    for t in (x, w, mult, bias):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_depthwise3x3: operands must be contiguous, on one device")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    if out_inv_step is None:
        out_mode, dtype = 2, torch.bfloat16
    else:
        out_mode, dtype = (1 if out_bits else 0), torch.int8
    out = torch.empty(b, ho, wo, c, dtype=dtype, device=x.device)
    lib = _build.load_library("int8_depthwise3x3")
    fn = lib.spef_int8_depthwise3x3
    fn.argtypes, fn.restype = _DW_ARGTYPES, _I
    code = fn(x.data_ptr(), x_mode, w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
              out.data_ptr(), out_mode, b, h, wd, c, stride, in_step,
              1.0 if out_inv_step is None else out_inv_step, out_qmax,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "int8_depthwise3x3")
    int8_depthwise3x3.launches += 1
    return out


int8_depthwise3x3.launches = 0
