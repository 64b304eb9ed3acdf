"""Quantized model family — counterparts of ``spef_tpu.quant.qmodels``.

``QMobileNetV2``, ``QSmallMobile``, ``QSmallBackbone`` and ``QURSONetHead``,
with the same child names as the flax modules (so flax checkpoints map onto
them by path) and the same rules:

  * the input-quant placement rule per block: with residual connections, a
    block's input is quantized iff it uses a residual, the previous block
    used one, or it is block 1;
  * the final shared quantizer after the last (activation-less)
    inverted-residual block, before the last 1x1 conv;
  * the bit-width dict schema of :mod:`spef_tpu_torch.quant.bitwidth`.

Backbones take NHWC float images in [0, 1] and return NHWC feature maps, in
float32: their convolutions run with TF32 off (cuDNN's default would round
the operands to 10-bit mantissas and move activations across grid steps).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from spef_tpu_torch.models.layers import Dropout
from spef_tpu_torch.models.mobilenet_v2 import MOBILENET_V2_SETTINGS, SMALL_MOBILE_SETTINGS
from spef_tpu_torch.quant.bitwidth import default_bit_width
from spef_tpu_torch.quant.fake_quant import FakeQuantAct, quantize_input_image, quantize_weight
from spef_tpu_torch.quant.int8_model import f32_convs
from spef_tpu_torch.quant.qlayers import QConvBnAct, QInvertedResidual

__all__ = ["QMobileNetV2", "QSmallMobile", "QSmallBackbone", "QURSONetHead",
           "build_quant_backbone", "build_quant_head"]


class _QBackbone(nn.Module):
    """What the quantized backbones share: the image quantizer on the way
    in, NHWC <-> channels_last at the edges, the final shared quantizer."""

    def _image(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.quantization:
            x = quantize_input_image(x, self.bit_width["image"])
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def _final_shared(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_shared_quant(x) if self.quantization else x


class QMobileNetV2(_QBackbone):
    """Quantized MobileNet-V2 feature extractor."""

    def __init__(self, out_features: int = 1280, batchnorm: bool = True, residual: bool = True,
                 quantization: bool = True, bit_width: Optional[dict] = None,
                 settings: Sequence[Tuple[int, int, int, int]] = MOBILENET_V2_SETTINGS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_blocks = sum(n for _, _, n, _ in settings)
        bw = bit_width or default_bit_width(n_blocks)
        self.settings = tuple(settings)
        self.out_features = out_features
        self.bit_width = bw
        self.quantization = quantization
        kw = dict(batchnorm=batchnorm, quantization=quantization, generator=generator)
        self.stem = QConvBnAct(3, 32, kernel_size=3, stride=2, padding=1,
                               weight_bits=bw["first_conv"][0], act_bits=bw["first_conv"][1],
                               **kw)
        in_ch = 32
        prev_used_residual = False
        block = 0
        for t, c, n, s in settings:
            for i in range(n):
                stride = s if i == 0 else 1
                use_residual = stride == 1 and in_ch == c and residual
                if residual:
                    input_quant = use_residual or prev_used_residual or (block == 1 and i == 0)
                else:
                    input_quant = not (block == 0 and i == 0)
                self.add_module(f"block_{block}", QInvertedResidual(
                    in_ch, c, stride=stride, expand_ratio=t,
                    bit_width=tuple(map(tuple, bw["inverted_residual"][block])),
                    shared_act_bits=bw["shared_act"], use_residual=use_residual,
                    input_quant=input_quant, **kw))
                in_ch = c
                prev_used_residual = use_residual
                block += 1
        self.n_blocks = block
        self.final_shared_quant = (FakeQuantAct(bw["shared_act"], signed=True)
                                   if quantization else None)
        self.head_conv = QConvBnAct(in_ch, out_features, kernel_size=1,
                                    weight_bits=bw["last_conv"][0], act_bits=bw["last_conv"][1],
                                    **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with f32_convs():
            x = self.stem(self._image(x))
            for i in range(self.n_blocks):
                x = getattr(self, f"block_{i}")(x)
            return self.head_conv(self._final_shared(x)).permute(0, 2, 3, 1)


class QSmallMobile(QMobileNetV2):
    """Two-block quantized MobileNet."""

    def __init__(self, out_features: int = 64, **kw):
        super().__init__(out_features=out_features, settings=SMALL_MOBILE_SETTINGS, **kw)


class QSmallBackbone(_QBackbone):
    """Tiny quantized debug backbone: conv, one inverted residual, conv."""

    def __init__(self, out_features: int = 32, batchnorm: bool = True, residual: bool = True,
                 quantization: bool = True, bit_width: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bw = bit_width or default_bit_width(1)
        self.out_features = out_features
        self.bit_width = bw
        self.quantization = quantization
        kw = dict(batchnorm=batchnorm, quantization=quantization, generator=generator)
        self.conv0 = QConvBnAct(3, 16, kernel_size=3, stride=2, weight_bits=bw["first_conv"][0],
                                act_bits=bw["first_conv"][1], **kw)
        self.block_0 = QInvertedResidual(
            16, 16, stride=1, expand_ratio=2,
            bit_width=tuple(map(tuple, bw["inverted_residual"][0])),
            shared_act_bits=bw["shared_act"], use_residual=residual, input_quant=True, **kw)
        self.final_shared_quant = (FakeQuantAct(bw["shared_act"], signed=True)
                                   if quantization else None)
        self.conv1 = QConvBnAct(16, out_features, kernel_size=1, weight_bits=bw["last_conv"][0],
                                act_bits=bw["last_conv"][1], **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with f32_convs():
            x = self.block_0(self.conv0(self._image(x)))
            return self.conv1(self._final_shared(x)).permute(0, 2, 3, 1)


class QURSONetHead(nn.Module):
    """Quantized URSONet head: mean pool, a signed 8-bit pool quantizer, and
    two fake-quantized dense branches with fake-quantized biases.  The
    kernels are ``ori_fc_kernel`` / ``pos_fc_kernel`` in flax layout
    (in, out), as the flax head declares them."""

    def __init__(self, in_features: int = 1280, n_ori_outputs: int = 4, n_pos_outputs: int = 3,
                 dropout_rate: float = 0.2, use_bias: bool = True, quantization: bool = True,
                 bit_width: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        bw = bit_width or {}
        self.fc_w_bits, self.fc_b_bits = bw.get("fully_connected", (8, 8))
        self.quantization = quantization
        self.use_bias = use_bias
        self.pool_quant = (FakeQuantAct(bw.get("pooling", 8), signed=True)
                           if quantization else None)
        self.ori_dropout = Dropout(dropout_rate)
        for name, n_out in (("ori_fc", n_ori_outputs), ("pos_fc", n_pos_outputs)):
            kernel = torch.empty(in_features, n_out)
            nn.init.normal_(kernel, 0.0, 0.01, generator=generator)  # reference dense init
            self.register_parameter(f"{name}_kernel", nn.Parameter(kernel))
            if use_bias:
                self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(n_out)))

    def _dense(self, h: torch.Tensor, name: str) -> torch.Tensor:
        kernel = getattr(self, f"{name}_kernel")
        if self.quantization:
            kernel = quantize_weight(kernel, self.fc_w_bits, per_channel=True)
        y = h @ kernel
        if self.use_bias:
            bias = getattr(self, f"{name}_bias")
            if self.quantization:
                bias = quantize_weight(bias, self.fc_b_bits, per_channel=False)
            y = y + bias
        return y

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.mean(dim=(1, 2)).float()
        if self.pool_quant is not None:
            x = self.pool_quant(x)
        return self._dense(self.ori_dropout(x), "ori_fc"), self._dense(x, "pos_fc")


def build_quant_backbone(name: str, cfg: dict, bit_width: Optional[dict], quantization: bool,
                         generator: Optional[torch.Generator] = None) -> nn.Module:
    """Factory for the ``*_q`` backbone names."""
    common = dict(batchnorm=cfg["batchnorm"], residual=cfg["residual"],
                  quantization=quantization, bit_width=bit_width, generator=generator)
    if name == "mobilenet_v2_q":
        return QMobileNetV2(out_features=1280, **common)
    if name == "small_mobile_q":
        return QSmallMobile(**common)
    if name == "small_q":
        return QSmallBackbone(**common)
    raise ValueError(f"Quantized backbone {name} does not exist")


def build_quant_head(name: str, in_features: int, n_ori: int, n_pos: int,
                     bit_width: Optional[dict], quantization: bool,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    if name == "ursonet_q":
        return QURSONetHead(in_features, n_ori_outputs=n_ori, n_pos_outputs=n_pos,
                            quantization=quantization, bit_width=bit_width,
                            generator=generator)
    raise ValueError(f"Quantized head {name} does not exist")
