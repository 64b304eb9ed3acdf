"""QAT layer library — counterparts of ``spef_tpu.quant.qlayers``.

  * :class:`QConv` — a convolution with per-output-channel fake-quantized
    weights;
  * :class:`QConvBnAct` — ``QConv`` + BatchNorm + ReLU + a learned-scale
    unsigned activation quantizer (``act_quant``);
  * :class:`QInvertedResidual` — expand / depthwise / project with per-conv
    bit widths from the block's triple, and the shared signed quantizer
    (``shared_quant``) applied to the block input and to the projection
    output before the residual add, so that both addends share one scale.

The math runs in float32 (fake-quant grids do not survive bf16), NCHW
tensors in ``channels_last`` memory as in ``models/layers.py``.  Parameters
sit where the flax tree has them: ``conv.weight`` (the flax ``conv/kernel``,
OIHW here), ``bn.*`` and ``*_quant.log2_scale``.  BatchNorm is
``models.layers.BatchNorm`` (flax's train mode); in eval mode it is written
out as flax computes it, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spef_tpu_torch.models.layers import BatchNorm, kaiming_normal_fan_out_
from spef_tpu_torch.quant.fake_quant import FakeQuantAct, quantize_weight

__all__ = ["QConv", "QConvBnAct", "QInvertedResidual"]


class QConv(nn.Module):
    """Conv2d with fake-quantized weights (per-output-channel scales)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 weight_bits: Optional[int] = 8, quantization: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - 1) // 2 if padding is None else padding
        self.groups = groups
        self.weight_bits = weight_bits
        self.quantization = quantization
        self.weight = nn.Parameter(torch.empty(features, in_channels // groups, kernel_size,
                                               kernel_size))
        kaiming_normal_fan_out_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.quantization:
            # Per-channel scales over the flax layout (HWIO: output channel last).
            w = quantize_weight(w.permute(2, 3, 1, 0), self.weight_bits).permute(3, 2, 0, 1)
        return torch.nn.functional.conv2d(x, w, None, self.stride, self.padding, 1, self.groups)


class QConvBnAct(nn.Module):
    """Quantized conv + BN + quantized ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1, batchnorm: bool = True,
                 activation: bool = True, weight_bits: Optional[int] = 8,
                 act_bits: Optional[int] = 8, quantization: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = QConv(in_channels, features, kernel_size, stride, padding, groups,
                          weight_bits=weight_bits, quantization=quantization,
                          generator=generator)
        self.bn = BatchNorm(features) if batchnorm else None
        self.activation = activation
        self.act_quant = (FakeQuantAct(act_bits, signed=False)
                          if activation and quantization and act_bits is not None else None)

    def _bn(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        if self.training:
            return bn(x)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return (x - bn.running_mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self._bn(x)
        if self.activation:
            x = torch.relu(x)
            if self.act_quant is not None:
                x = self.act_quant(x)
        return x


class QInvertedResidual(nn.Module):
    """Quantized inverted residual with a shared-scale residual add.

    ``bit_width`` is the block triple ``[(c1_w, c1_a), (c2_w, c2_a), (c3_w,)]``.
    ``input_quant`` applies the shared quantizer to the block input;
    ``use_residual`` applies it to the projection output too.
    """

    def __init__(self, in_channels: int, features: int, stride: int, expand_ratio: int,
                 bit_width: Tuple, shared_act_bits: int = 4, batchnorm: bool = True,
                 quantization: bool = True, use_residual: bool = False,
                 input_quant: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        (c1_w, c1_a), (c2_w, c2_a), (c3_w,) = bit_width
        hidden = int(round(in_channels * expand_ratio))
        kw = dict(batchnorm=batchnorm, quantization=quantization, generator=generator)
        self.use_residual = use_residual
        self.shared_quant = (FakeQuantAct(shared_act_bits, signed=True)
                             if quantization and (input_quant or use_residual) else None)
        self.expand = (QConvBnAct(in_channels, hidden, kernel_size=1, weight_bits=c1_w,
                                  act_bits=c1_a, **kw) if expand_ratio != 1 else None)
        self.depthwise = QConvBnAct(hidden, hidden, kernel_size=3, stride=stride, groups=hidden,
                                    weight_bits=c2_w, act_bits=c2_a, **kw)
        self.project = QConvBnAct(hidden, features, kernel_size=1, activation=False,
                                  weight_bits=c3_w, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shared_quant is not None:
            x = self.shared_quant(x)
        residual = x
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        if self.use_residual:
            if self.shared_quant is not None:
                y = self.shared_quant(y)  # the same module: the same learned scale
            y = y + residual
        return y
