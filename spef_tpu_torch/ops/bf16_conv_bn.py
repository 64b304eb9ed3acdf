"""Hand-written CUDA kernels of the float forward's eval-mode convs, with their
plain twins.

Each conv of an eval-mode ``ConvBnAct`` on the card (``models/layers.py``)
is one kernel with the BatchNorm, the ReLU and a projection's residual add
in its epilogue, so a conv's output goes to device memory once, normalized:

  * :func:`bf16_conv1x1_bn` (``csrc/bf16_conv1x1_bn.cu``) — every 1x1 conv
    (expand, project, head conv) on the bf16 tensor cores;
  * :func:`bf16_depthwise3x3_bn` (``csrc/bf16_depthwise3x3_bn.cu``) — every
    3x3 depthwise conv, stride 1 or 2, pad 1.

The epilogue does the unfused path's roundings in its order: the f32 sum
rounded to bf16 (the conv's bf16 output), then in f32 ``c * scale + shift``
as a rounded multiply and a rounded add (never a fused multiply-add),
rounded to bf16, the ReLU, and for a projection with an identity skip the
block input added in f32 and rounded to bf16.  ``scale`` and ``shift`` are
the BatchNorm's running statistics folded per channel in float32
(:func:`bn_terms`); the conv weights stay the module's, rounded to bf16, so
no BatchNorm scale is ever rounded into them.

Each wrapper launches its kernel for CUDA tensors (raising on a CUDA error,
never falling back) and runs the ``*_plain`` twin for CPU tensors; the
kernels take channel counts that are multiples of 8 and operands on 16-byte
boundaries, as every MobileNetV2 layer has them (``_kernel_kind`` sends any
other conv down the unfused path, and a wrapper refuses it); each
counts its launches in ``launches`` and, by card, ``launches_by_card``.  The
depthwise twin sums the taps in the kernel's order and agrees with it bit
for bit; the 1x1 kernel sums on the tensor cores in their own order, as
cuDNN's conv does in another, so the two agree bit for bit where every
order gives the same sum (integer-valued operands, say) and otherwise by
the conv's rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spef_tpu_torch.ops import _build

__all__ = ["bn_terms", "pack_conv1x1_weights", "pack_depthwise_weights", "bf16_conv1x1_bn",
           "bf16_conv1x1_bn_plain", "bf16_depthwise3x3_bn", "bf16_depthwise3x3_bn_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_CONV1X1_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_DW_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# The 1x1 kernel's weights are padded along K to a multiple of 32 (K1's packing).
_K_DEPTH = 32


def bn_terms(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``y = c * scale + shift`` per channel, in float32:
    ``scale = weight / sqrt(var + eps)``, ``shift = bias - mean * scale``,
    each step rounded to float32."""
    scale = weight.float() / torch.sqrt(var.float() + eps)
    return scale, bias.float() - mean.float() * scale


def pack_conv1x1_weights(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv's weights ``(N, K, 1, 1)`` as the kernel reads them: bf16
    ``(N, K padded to 32)``, zeros past K (the mma's B operand)."""
    if w.dim() != 4 or w.shape[2:] != (1, 1):
        raise ValueError(f"pack_conv1x1_weights: w must be (N, K, 1, 1), got {tuple(w.shape)}")
    n, k = w.shape[:2]
    out = torch.zeros(n, -(-k // _K_DEPTH) * _K_DEPTH, dtype=torch.bfloat16, device=w.device)
    out[:, :k] = w[:, :, 0, 0]
    return out


def pack_depthwise_weights(w: torch.Tensor) -> torch.Tensor:
    """A depthwise conv's weights ``(C, 1, 3, 3)`` as bf16 ``(3, 3, C)``."""
    if w.dim() != 4 or w.shape[1:] != (1, 3, 3):
        raise ValueError(f"pack_depthwise_weights: w must be (C, 1, 3, 3), got {tuple(w.shape)}")
    return w[:, 0].permute(1, 2, 0).to(torch.bfloat16).contiguous()


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' epilogue on f32 sums ``acc (..., N)``: bf16 conv output,
    BatchNorm in f32 (a rounded multiply, then a rounded add), bf16, ReLU,
    then ``residual + y`` in bf16 (f32 sum, rounded)."""
    y = acc.to(torch.bfloat16).float() * scale
    y = (y + shift).to(torch.bfloat16)
    if relu:
        y = torch.relu(y)
    return y if residual is None else residual + y


def bf16_conv1x1_bn_plain(
    x: torch.Tensor,  # (M, K) bf16
    w: torch.Tensor,  # (N, kpad) bf16, pack_conv1x1_weights
    scale: torch.Tensor,  # (N,) f32
    shift: torch.Tensor,  # (N,) f32
    relu: bool = True,
    residual: Optional[torch.Tensor] = None,  # (M, N) bf16
) -> torch.Tensor:
    """Plain PyTorch twin of the 1x1 kernel (f32 sums in the matmul's order)."""
    acc = x.float() @ w[:, :x.shape[1]].float().t()
    return _epilogue(acc, scale, shift, relu, residual)


def bf16_depthwise3x3_bn_plain(
    x: torch.Tensor,  # (B, H, W, C) bf16
    w: torch.Tensor,  # (3, 3, C) bf16
    scale: torch.Tensor,  # (C,) f32
    shift: torch.Tensor,  # (C,) f32
    stride: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch twin of the depthwise kernel: the taps summed in
    (dy, dx) order in f32, then the same epilogue; bit for bit."""
    b, h, wd, c = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(b, ho, wo, c, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            acc = acc + tap * wf[dy, dx]
    return _epilogue(acc, scale, shift, relu, None)


def _check_terms(name: str, n: int, device: torch.device, scale, shift) -> None:
    for what, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or t.shape != (n,) or t.device != device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 ({n},) on {device}")


def _check_grid(name: str, widths, device: torch.device, tensors) -> None:
    """Every channel count a multiple of 8 and every operand contiguous, on
    ``device``, at a 16-byte boundary: the kernels move 16 bytes a copy."""
    if any(c % 8 for c in widths):
        raise ValueError(f"{name}: channel counts {tuple(widths)} must be multiples of 8")
    for t in tensors:
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous, on one device, at 16-byte "
                             f"boundaries")


def bf16_conv1x1_bn(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    relu: bool = True, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 1x1 kernel for CUDA tensors, the plain twin for CPU tensors.

    ``x`` (M, K) bf16, ``w`` (N, K padded to 32) bf16
    (:func:`pack_conv1x1_weights`), ``scale`` / ``shift`` (N,) f32
    (:func:`bn_terms`), ``residual`` (M, N) bf16 or None; returns (M, N)
    bf16."""
    if x.device.type == "cpu":
        return bf16_conv1x1_bn_plain(x, w, scale, shift, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_conv1x1_bn: unsupported device {x.device}")
    _build.refuse_tracing("bf16_conv1x1_bn", x)
    if x.dim() != 2 or w.dim() != 2 or x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"bf16_conv1x1_bn: x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}: both bf16 and 2-d")
    m, k = x.shape
    n, kpad = w.shape
    if kpad < k or kpad % _K_DEPTH:
        raise ValueError(f"bf16_conv1x1_bn: packed weights {tuple(w.shape)} do not fit K={k} "
                         f"(pack_conv1x1_weights)")
    _check_terms("bf16_conv1x1_bn", n, x.device, scale, shift)
    tensors = [x, w]
    if residual is not None:
        if residual.dtype != torch.bfloat16 or residual.shape != (m, n):
            raise ValueError(f"bf16_conv1x1_bn: residual must be bf16 ({m}, {n})")
        tensors.append(residual)
    _check_grid("bf16_conv1x1_bn", (k, n), x.device, tensors)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library("bf16_conv1x1_bn")
    fn = lib.spef_bf16_conv1x1_bn
    fn.argtypes, fn.restype = _CONV1X1_ARGTYPES, _I
    # The launcher sets the kernel's shared memory and reads the SM count and
    # occupancy of the current device: make it the operands' card.
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), kpad, scale.data_ptr(), shift.data_ptr(),
                  None if residual is None else residual.data_ptr(), out.data_ptr(), m, n, k,
                  int(relu), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "bf16_conv1x1_bn")
    _build.count_launch(bf16_conv1x1_bn, x.device)
    return out


bf16_conv1x1_bn.launches = 0
bf16_conv1x1_bn.launches_by_card = {}


def bf16_depthwise3x3_bn(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """The depthwise kernel for CUDA tensors, the plain twin for CPU tensors.

    ``x`` (B, H, W, C) bf16, ``w`` (3, 3, C) bf16
    (:func:`pack_depthwise_weights`), ``scale`` / ``shift`` (C,) f32;
    returns (B, Ho, Wo, C) bf16."""
    if x.device.type == "cpu":
        return bf16_depthwise3x3_bn_plain(x, w, scale, shift, stride, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_depthwise3x3_bn: unsupported device {x.device}")
    _build.refuse_tracing("bf16_depthwise3x3_bn", x)
    if x.dim() != 4 or stride not in (1, 2) or x.dtype != torch.bfloat16:
        raise ValueError(f"bf16_depthwise3x3_bn: x {x.dtype} {tuple(x.shape)}, stride {stride}")
    b, h, wd, c = x.shape
    if w.dtype != torch.bfloat16 or w.shape != (3, 3, c):
        raise ValueError(f"bf16_depthwise3x3_bn: w must be bf16 (3, 3, {c})")
    _check_terms("bf16_depthwise3x3_bn", c, x.device, scale, shift)
    _check_grid("bf16_depthwise3x3_bn", (c,), x.device, (x, w))
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    out = torch.empty(b, ho, wo, c, dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library("bf16_depthwise3x3_bn")
    fn = lib.spef_bf16_depthwise3x3_bn
    fn.argtypes, fn.restype = _DW_ARGTYPES, _I
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                  b, h, wd, c, stride, int(relu), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "bf16_depthwise3x3_bn")
    _build.count_launch(bf16_depthwise3x3_bn, x.device)
    return out


bf16_depthwise3x3_bn.launches = 0
bf16_depthwise3x3_bn.launches_by_card = {}
