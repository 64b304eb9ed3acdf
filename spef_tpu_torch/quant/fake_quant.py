"""Fake-quantization (QAT) primitives — straight-through estimators.

Counterpart of ``spef_tpu.quant.fake_quant`` (the reference's Brevitas
quantizers):

  * weights: symmetric signed integers with per-output-channel absmax
    scales, narrow range [-(2^(b-1)-1), 2^(b-1)-1]; 1-bit: sign(w) times the
    per-channel mean |w|; 2-bit: {-s, 0, s} with a 0.5 * mean |w| threshold;
  * activations: unsigned (post-ReLU) or signed per-tensor grids with a
    learned scale stored as ``log2_scale`` (an ``nn.Parameter``);
  * input image: 8-bit unsigned with the fixed scale 1/255.

Weights are in flax layout here (HWIO, or (in, out) for a dense kernel):
the output channel is the last axis.  Every straight-through round is
``x + (round(x) - x).detach()``.  Divisions by a Python number divide by a
0-d tensor, an IEEE division on every device (a CUDA tensor divided by a
Python scalar is multiplied by the reciprocal instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["ste_round", "quantize_weight", "weight_scale", "FakeQuantAct",
           "quantize_input_image"]

_EPS = 2e-16  # scaling_min_val of the reference quantizers


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _reduce_dims(w: torch.Tensor, per_channel: bool):
    return tuple(range(w.dim() - 1)) if per_channel else tuple(range(w.dim()))


def quantize_weight(w: torch.Tensor, bits: Optional[int], per_channel: bool = True
                    ) -> torch.Tensor:
    """Fake-quantize a conv (HWIO) or dense (IO) weight tensor.

    bits=None -> identity; 1 -> sign(w) * mean|w|; 2 -> ternary with a
    0.5 * mean|w| threshold; else symmetric narrow-range integers with a
    per-output-channel scale.
    """
    if bits is None:
        return w
    dims = _reduce_dims(w, per_channel)
    if bits == 1:
        scale = torch.clamp_min(w.abs().mean(dim=dims, keepdim=True), _EPS)
        sign = torch.where(w >= 0, 1.0, -1.0)
        return w + (sign * scale - w).detach()
    if bits == 2:
        scale = torch.clamp_min(w.abs().mean(dim=dims, keepdim=True), _EPS)
        thr = 0.5 * scale
        tern = torch.where(w > thr, scale, torch.where(w < -thr, -scale, 0.0))
        return w + (tern - w).detach()
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = _div(torch.clamp_min(w.abs().amax(dim=dims, keepdim=True), _EPS), qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax) * scale
    return w + (q - w).detach()


def weight_scale(w: torch.Tensor, bits: int, per_channel: bool = True) -> torch.Tensor:
    """The integer-domain scale :func:`quantize_weight` uses (for export)."""
    dims = _reduce_dims(w, per_channel)
    if bits <= 2:
        return torch.clamp_min(w.abs().mean(dim=dims, keepdim=True), _EPS)
    qmax = 2.0 ** (bits - 1) - 1.0
    return _div(torch.clamp_min(w.abs().amax(dim=dims, keepdim=True), _EPS), qmax)


class FakeQuantAct(nn.Module):
    """Learned-scale activation fake-quantizer (per tensor).

    The scale lives in the log2 domain (``log2_scale``); ``signed`` selects
    the integer range.  1- and 2-bit widths use binary / ternary levels.
    """

    def __init__(self, bits: int, signed: bool = False, init_scale: float = 6.0):
        super().__init__()
        if bits is None:
            raise ValueError("FakeQuantAct: bits=None has no quantizer (build none)")
        self.bits = bits
        self.signed = signed
        self.log2_scale = nn.Parameter(torch.tensor(math.log2(init_scale), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.exp2(self.log2_scale)
        if self.bits == 1:
            sign = torch.where(x >= 0, 1.0, -1.0) * scale
            return x + (sign - x).detach()
        if self.bits == 2:
            thr = 0.5 * scale
            tern = torch.where(x > thr, scale, torch.where(x < -thr, -scale, 0.0))
            return x + (tern - x).detach()
        if self.signed:
            qmax = 2.0 ** (self.bits - 1) - 1.0
            qmin = -(2.0 ** (self.bits - 1))
        else:
            qmax = 2.0 ** self.bits - 1.0
            qmin = 0.0
        step = _div(scale, qmax)
        # STE with respect to x; the scale learns through the clip boundaries.
        return torch.clamp(ste_round(x / step), qmin, qmax) * step

    def scale_value(self) -> float:
        return float(2.0 ** self.log2_scale.item())


def quantize_input_image(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """8-bit unsigned image quantization with the fixed scale 1/255: for
    float input in [0, 1] a straight round to the unsigned grid."""
    levels = 2.0 ** bits - 1.0
    return _div(ste_round(torch.clamp(x, 0.0, 1.0) * levels), levels)
