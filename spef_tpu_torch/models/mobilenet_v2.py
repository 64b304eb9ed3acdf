"""MobileNet-V2 backbone — PyTorch, NHWC at its edge, channels_last inside.

Counterpart of ``spef_tpu.models.mobilenet_v2.MobileNetV2``: the same
(t, c, n, s) inverted-residual table, a 3x3 stride-2 stem to 32 channels, a
1x1 head conv to ``out_features`` (1280), ReLU activations and the same
child names (``stem``, ``block_{i}``, ``head_conv``), so flax checkpoints map
onto it by path.  ``SmallMobile`` (two blocks, 64 features) and
``SmallBackbone`` (conv, one inverted residual, conv) are the JAX package's
small debug backbones, which the CPU tests train.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from spef_tpu_torch.models.layers import ConvBnAct, InvertedResidual

__all__ = ["MobileNetV2", "SmallMobile", "SmallBackbone", "MOBILENET_V2_SETTINGS",
           "SMALL_MOBILE_SETTINGS"]

# (expand_ratio t, out_channels c, repeats n, first-stride s)
MOBILENET_V2_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

SMALL_MOBILE_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (6, 32, 1, 1),
    (6, 32, 1, 2),
)


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC images -> NCHW in channels_last memory (a view), in ``dtype``."""
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class MobileNetV2(nn.Module):
    """Feature extractor: NHWC float images -> NHWC feature map."""

    def __init__(
        self,
        out_features: int = 1280,
        batchnorm: bool = True,
        residual: bool = True,
        settings: Sequence[Tuple[int, int, int, int]] = MOBILENET_V2_SETTINGS,
        width_mult: float = 1.0,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_features = out_features
        kw = dict(batchnorm=batchnorm, compute_dtype=compute_dtype, generator=generator)
        in_ch = int(32 * width_mult)
        self.stem = ConvBnAct(3, in_ch, kernel_size=3, stride=2, padding=1, **kw)
        self.n_blocks = 0
        for t, c, n, s in settings:
            c = int(c * width_mult)
            for i in range(n):
                self.add_module(f"block_{self.n_blocks}", InvertedResidual(
                    in_ch, c, stride=s if i == 0 else 1, expand_ratio=t,
                    residual=residual, **kw))
                in_ch = c
                self.n_blocks += 1
        self.head_conv = ConvBnAct(in_ch, out_features, kernel_size=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(_nchw(x, self.compute_dtype))
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.head_conv(x).permute(0, 2, 3, 1)


class SmallMobile(MobileNetV2):
    """Two-block MobileNet, 64 features."""

    def __init__(self, out_features: int = 64, **kw):
        super().__init__(out_features=out_features, settings=SMALL_MOBILE_SETTINGS, **kw)


class SmallBackbone(nn.Module):
    """Tiny debug net: a 3x3 stride-2 conv to 16 channels, one inverted
    residual (expand 2), a 1x1 conv to ``out_features``."""

    def __init__(
        self,
        out_features: int = 32,
        batchnorm: bool = True,
        residual: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_features = out_features
        kw = dict(batchnorm=batchnorm, compute_dtype=compute_dtype, generator=generator)
        self.conv0 = ConvBnAct(3, 16, kernel_size=3, stride=2, **kw)
        self.block_0 = InvertedResidual(16, 16, stride=1, expand_ratio=2, residual=residual,
                                        **kw)
        self.conv1 = ConvBnAct(16, out_features, kernel_size=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block_0(self.conv0(_nchw(x, self.compute_dtype)))
        return self.conv1(x).permute(0, 2, 3, 1)
