"""MobileNet-V2 backbone — PyTorch, NHWC at its edge, channels_last inside.

Counterpart of ``spef_tpu.models.mobilenet_v2.MobileNetV2``: the same
(t, c, n, s) inverted-residual table, a 3x3 stride-2 stem to 32 channels, a
1x1 head conv to ``out_features`` (1280), ReLU activations and the same
child names (``stem``, ``block_{i}``, ``head_conv``), so flax checkpoints map
onto it by path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from spef_tpu_torch.models.layers import ConvBnAct, InvertedResidual

__all__ = ["MobileNetV2", "MOBILENET_V2_SETTINGS"]

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
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC memory = channels_last
        x = self.stem(x.contiguous(memory_format=torch.channels_last))
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.head_conv(x).permute(0, 2, 3, 1)
