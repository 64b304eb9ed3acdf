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
``launches`` attribute, and each card's in ``launches_by_card`` (by the
card's index).

Numerics shared by both versions (and by the JAX kernels): integer sums are
exact (K1 sums them on the int8 tensor cores); ``y = acc * mult + bias`` is
a rounded multiply then a rounded add, never a fused multiply-add; rounding
is half to even.  Real-valued operands give exact f32 products: K2 sums its
taps in (dy, dx) order in both versions, bit for bit.  K1's bf16 input runs
on the bf16 tensor cores, which sum in their own order, as the JAX kernel's
``jnp.dot(..., preferred_element_type=float32)`` does; the plain version
sums in k order 0..K-1.  The two sums differ by rounding only, which can move
an int8 output by one step where the value rounded last sits on a tie:
:func:`int8_matmul_requant_rounding_input` returns that value and the bound
on its error, :func:`tie_mismatches` applies the rule and counts.

K1 reads its weights as the tensor cores' B operand wants them,
``(N, K padded to 32)``, packed once when a forward is built
(:func:`pack_mm_weights`).

The int8-carry executor (``quant/int8_carry.py``) follows other conventions
than ``int8_pallas``, and both kernels take them as options:

  * ``out_step``: requantize by an IEEE division, ``round(y / out_step)``,
    in place of the multiply by ``out_inv_step`` (the two differ by an ulp,
    and so by a step at a tie);
  * ``out_zp``: emit an unsigned grid shifted into int8, ``q - out_zp``
    (``out_zp`` 128 for a grid of qmax 255; its consumer folds
    ``128 * colsum(w)`` into its bias);
  * ``halo`` (K2): the value the taps outside the image read, ``-zp`` for a
    shifted input (the shifted form of a real 0).

The defaults keep the ``int8_pallas`` behaviour.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.ops import _build

__all__ = [
    "int8_matmul_requant", "int8_matmul_requant_plain", "pack_mm_weights",
    "int8_matmul_requant_rounding_input", "tie_mismatches",
    "int8_depthwise3x3", "int8_depthwise3x3_plain",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_MM_ARGTYPES = [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I,
                _I, _P]
# K1's weights are padded along K to the depth of one int8 mma (32).
_MM_K_DEPTH = 32
# Rows of x the rounding-input helper takes at once (float64 copies).
_ROUNDING_CHUNK_ELEMS = 1 << 25
_DW_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P]


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


def _scaled(y: torch.Tensor, out_inv_step: Optional[float], out_step: Optional[float]
            ) -> torch.Tensor:
    """The value the requant rounds: ``y * out_inv_step``, or ``y / out_step``
    as an IEEE division (a 0-d tensor: a CUDA tensor divided by a Python
    scalar is multiplied by the reciprocal)."""
    if out_step is not None:
        return y / torch.tensor(_f32(out_step), dtype=torch.float32, device=y.device)
    return y * _f32(out_inv_step)


def _emit(q: torch.Tensor, out_bits: bool, out_zp: int) -> torch.Tensor:
    """A requantized grid index ``q`` (float) as int8: its uint8 bits, or
    ``q - out_zp``."""
    return _encode_bits(q) if out_bits else (q - out_zp).to(torch.int8)


def _check_carry_options(name: str, out_inv_step, out_step, out_zp: int, out_bits: bool) -> None:
    if out_step is not None and out_inv_step is not None:
        raise ValueError(f"{name}: give out_inv_step or out_step, not both")
    if out_zp not in (0, 128) or (out_zp and out_bits):
        raise ValueError(f"{name}: out_zp must be 0 or 128, and 0 with out_bits")


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
    packed: Optional[Dict[str, torch.Tensor]] = None,  # the kernel's copy; not read here
    out_step: Optional[float] = None,  # requant by an IEEE division (the carry's)
    out_zp: int = 0,  # emit q - out_zp (the carry's shifted unsigned grid)
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arithmetic, any device; bf16 input
    summed in k order)."""
    _check_carry_options("int8_matmul_requant", out_inv_step, out_step, out_zp, out_bits)
    return _mm_epilogue(_mm_acc_plain(x, w, in_unsigned), mult, bias, residual, relu,
                        out_inv_step, out_qmax, out_qmin, res_ratio, res_qmax, res_qmin, out_bits,
                        out_step, out_zp)


def _mm_epilogue(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor], relu: bool, out_inv_step: Optional[float],
                 out_qmax: float, out_qmin: float, res_ratio: float, res_qmax: float,
                 res_qmin: float, out_bits: bool, out_step: Optional[float] = None,
                 out_zp: int = 0) -> torch.Tensor:
    """K1's epilogue on the float32 sums ``acc (M, N)``."""
    y = acc * mult
    y = y + bias
    requant = out_inv_step is not None or out_step is not None
    if residual is not None and requant:
        # Exact shared-grid sum, requantized straight to the consumer grid
        # (never clamped to int8 on the shared grid first).
        q = torch.clamp(torch.round(_scaled(y, out_inv_step, out_step)), out_qmin, out_qmax)
        s = q + residual.float()
        return torch.clamp(torch.round(s * _f32(res_ratio)), res_qmin, res_qmax).to(torch.int8)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if not requant:
        return y
    q = torch.clamp(torch.round(_scaled(y, out_inv_step, out_step)), out_qmin, out_qmax)
    return _emit(q, out_bits, out_zp)


def pack_mm_weights(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K1's weights as the tensor cores' B operand reads them: ``w (K, N)``
    int8 transposed to ``(N, K padded to 32)``, zeros past K, as ``"int8"``
    and as ``"bf16"`` (int8 values are exact in bf16) for bf16 input.  Plain
    PyTorch, any device; done once when a forward is built, or by
    :func:`int8_matmul_requant` for a caller that passes none."""
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"pack_mm_weights: w must be int8 (K, N), got {w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    w8 = torch.zeros(n, -(-k // _MM_K_DEPTH) * _MM_K_DEPTH, dtype=torch.int8, device=w.device)
    w8[:, :k] = w.t()
    return {"int8": w8, "bf16": w8.to(torch.bfloat16)}


def int8_matmul_requant_rounding_input(
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
    packed: Optional[Dict[str, torch.Tensor]] = None,
    out_step: Optional[float] = None,
    out_zp: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The value K1 rounds last, and how far a sum taken in another order may
    be from it: ``(v, eps, step)``, ``v`` and ``eps`` float64 ``(M, N)``.

    ``v`` is ``y * out_inv_step``, or ``y / out_step`` (``relu(y)`` first
    without a residual),
    where ``y = acc * mult + bias`` with the sum ``acc`` taken in float64 and
    rounded once to float32, then the epilogue in float32 as the kernel does
    it.  A float32 sum of K exact products in any order is within
    ``K * 2^-24 * sum_k |x_k w_k|`` of it; ``eps`` doubles that (a tensor
    core truncates where an adder rounds), scales it by
    ``|mult * out_inv_step|``, and adds ``8 * 2^-24 * |v|`` for the float32
    roundings after the sum, which a changed sum may flip.

    An int8 output may differ from :func:`int8_matmul_requant_plain`'s only
    where ``|v - (floor(v) + 0.5)| <= eps`` (:func:`tie_mismatches`), and
    there by at most ``step`` steps: 1, but ``ceil(res_ratio)`` where a
    residual sum is requantized by a ratio above 1 (the value rounded at the
    tie is then the projection on the shared grid).  With a float32 output
    (``out_inv_step`` None) ``v`` is the output, the kernel's may be up to
    ``eps`` from the plain version's, and ``step`` is 0.  Integer inputs
    sum exactly: every output then equals the plain version's.
    """
    requant = out_inv_step is not None or out_step is not None
    if out_step is not None:
        scale = 1.0 / _f32(out_step)
    else:
        scale = _f32(out_inv_step) if requant else 1.0
    unit = 2.0 ** -24
    k = x.shape[1]
    wd = w.double()
    wa = wd.abs()
    mabs = mult.double().abs()
    rows = max(1, _ROUNDING_CHUNK_ELEMS // max(k, w.shape[1]))
    vs, es = [], []
    for i in range(0, x.shape[0], rows):
        xc = x[i:i + rows]
        xd = xc.double() if xc.dtype == torch.bfloat16 else _decode(xc, in_unsigned).double()
        y = (xd @ wd).float() * mult
        y = y + bias
        if relu and not (residual is not None and requant):
            y = torch.clamp_min(y, 0.0)
        v = (_scaled(y, out_inv_step, out_step) if requant else y).double()
        vs.append(v)
        es.append((2.0 * k * unit * abs(scale)) * (xd.abs() @ wa) * mabs + 8.0 * unit * v.abs())
    if not requant:
        step = 0
    elif residual is not None:
        step = max(1, math.ceil(res_ratio))
    else:
        step = 1
    return torch.cat(vs), torch.cat(es), step


def tie_mismatches(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor, eps: torch.Tensor,
                   step: int = 1) -> Tuple[int, int]:
    """``(mismatches, refused)`` between a kernel output and the plain
    version's under the tie rule: a mismatch is admitted where it is at most
    ``step`` and ``v`` is within ``eps`` of a tie; every other is refused."""
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    mis = d > 0
    at_tie = (v - (torch.floor(v) + 0.5)).abs() <= eps
    refused = mis & ((d > step) | ~at_tie)
    return int(mis.sum()), int(refused.sum())


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
    packed: Optional[Dict[str, torch.Tensor]] = None,
    out_step: Optional[float] = None,
    out_zp: int = 0,
) -> torch.Tensor:
    """K1: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Output: (M, N) int8 (bits when ``out_bits``, ``q - out_zp`` else), or
    f32 when neither ``out_inv_step`` nor ``out_step`` is given.
    ``residual`` (int8 on the shared grid) selects the projection + residual
    variant; it ignores ``relu``, like the JAX one.  ``packed`` is
    :func:`pack_mm_weights` of ``w``, made once by a built forward; without
    it the weights are packed here, on every call.
    """
    kw = dict(residual=residual, relu=relu, out_inv_step=out_inv_step, out_qmax=out_qmax,
              out_qmin=out_qmin, res_ratio=res_ratio, res_qmax=res_qmax, res_qmin=res_qmin,
              in_unsigned=in_unsigned, out_bits=out_bits, out_step=out_step, out_zp=out_zp)
    _check_carry_options("int8_matmul_requant", out_inv_step, out_step, out_zp, out_bits)
    if x.device.type == "cpu":
        return int8_matmul_requant_plain(x, w, mult, bias, packed=packed, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_requant: unsupported device {x.device}")
    _build.refuse_tracing("int8_matmul_requant", x)
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
    divide = out_step is not None
    if out_inv_step is None and not divide:
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
    if packed is None:
        packed = pack_mm_weights(w)
    wp = packed["bf16" if x_mode == 2 else "int8"]
    kpad = wp.shape[-1]
    if (wp.dim() != 2 or wp.shape[0] != n or kpad < k or kpad % _MM_K_DEPTH
            or wp.dtype != (torch.bfloat16 if x_mode == 2 else torch.int8)):
        raise ValueError(f"int8_matmul_requant: packed weights {wp.dtype} {tuple(wp.shape)} "
                         f"do not fit w {tuple(w.shape)} (pack_mm_weights)")
    tensors.append(wp)
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_matmul_requant: operands must be contiguous, on one device")
    lib = _build.load_library("int8_matmul_requant")
    fn = lib.spef_int8_matmul_requant
    fn.argtypes, fn.restype = _MM_ARGTYPES, _I
    # The launcher sets the kernel's shared memory and reads the SM count and
    # occupancy of the current device: make it the operands' card.
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), x_mode, wp.data_ptr(), kpad, mult.data_ptr(), bias.data_ptr(),
                  residual.data_ptr() if out_mode == 3 else None, out.data_ptr(), out_mode,
                  m, n, k, int(relu),
                  out_step if divide else (0.0 if out_inv_step is None else out_inv_step),
                  out_qmin, out_qmax, res_ratio, res_qmin, res_qmax, int(divide), out_zp,
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "int8_matmul_requant")
    _build.count_launch(int8_matmul_requant, x.device)
    return out


int8_matmul_requant.launches = 0
int8_matmul_requant.launches_by_card = {}


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
    out_step: Optional[float] = None,  # requant by an IEEE division (the carry's)
    out_zp: int = 0,  # emit q - out_zp (the carry's shifted unsigned grid)
    halo: int = 0,  # what the taps outside the image read (int8 input only)
) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arithmetic, any device)."""
    _check_dw_options(x, out_inv_step, out_step, out_zp, out_bits, in_unsigned, halo)
    if x.dtype.is_floating_point:
        xf = x.to(torch.bfloat16).float()  # the bf16 operand cast of xla_depthwise3x3
    else:
        xf = _decode(x, in_unsigned)
    b, h, wd, c = xf.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1), value=float(halo))
    wf = w.float()
    acc = torch.zeros(b, ho, wo, c, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            acc = acc + tap * wf[dy, dx]
    y = acc * (mult * _f32(in_step))
    y = torch.clamp_min(y + bias, 0.0)
    if out_inv_step is None and out_step is None:
        return y.to(torch.bfloat16)
    q = torch.clamp(torch.round(_scaled(y, out_inv_step, out_step)), 0.0, out_qmax)
    return _emit(q, out_bits, out_zp)


def _check_dw_options(x, out_inv_step, out_step, out_zp, out_bits, in_unsigned, halo) -> None:
    _check_carry_options("int8_depthwise3x3", out_inv_step, out_step, out_zp, out_bits)
    if halo and (x.dtype != torch.int8 or in_unsigned or not -128 <= halo <= 127):
        raise ValueError("int8_depthwise3x3: a halo needs int8 values in, in [-128, 127]")


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
    out_step: Optional[float] = None,
    out_zp: int = 0,
    halo: int = 0,
) -> torch.Tensor:
    """K2: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Output (B, Ho, Wo, C): int8 (bits when ``out_bits``, ``q - out_zp``
    else), or bf16 when neither ``out_inv_step`` nor ``out_step`` is given.
    """
    kw = dict(stride=stride, in_step=in_step, out_inv_step=out_inv_step, out_qmax=out_qmax,
              in_unsigned=in_unsigned, out_bits=out_bits, out_step=out_step, out_zp=out_zp,
              halo=halo)
    _check_dw_options(x, out_inv_step, out_step, out_zp, out_bits, in_unsigned, halo)
    if x.device.type == "cpu":
        return int8_depthwise3x3_plain(x, w, mult, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_depthwise3x3: unsupported device {x.device}")
    _build.refuse_tracing("int8_depthwise3x3", x)
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
    divide = out_step is not None
    if out_inv_step is None and not divide:
        out_mode, dtype = 2, torch.bfloat16
    else:
        out_mode, dtype = (1 if out_bits else 0), torch.int8
    out = torch.empty(b, ho, wo, c, dtype=dtype, device=x.device)
    lib = _build.load_library("int8_depthwise3x3")
    fn = lib.spef_int8_depthwise3x3
    fn.argtypes, fn.restype = _DW_ARGTYPES, _I
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), x_mode, w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), out_mode, b, h, wd, c, stride, in_step,
                  out_step if divide else (1.0 if out_inv_step is None else out_inv_step),
                  out_qmax, int(divide), out_zp, halo,
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "int8_depthwise3x3")
    _build.count_launch(int8_depthwise3x3, x.device)
    return out


int8_depthwise3x3.launches = 0
int8_depthwise3x3.launches_by_card = {}
