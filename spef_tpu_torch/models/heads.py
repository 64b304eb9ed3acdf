"""Pose-estimation heads — PyTorch.

Counterpart of ``spef_tpu.models.heads.URSONetHead``: global average pool
over the NHWC feature map, then two fully connected branches (orientation,
with flax's dropout 0.2 when training, its mask drawn from an explicit
generator, and position), in float32.  The keypoint heads come with the
keypoints slice (ROADMAP §A, keypoints family).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spef_tpu_torch.models.layers import Dropout

__all__ = ["URSONetHead"]


class URSONetHead(nn.Module):
    """Two-branch (orientation, position) head over pooled features."""

    def __init__(
        self,
        in_features: int = 1280,
        n_ori_outputs: int = 4,
        n_pos_outputs: int = 3,
        dropout_rate: float = 0.2,
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ori_dropout = Dropout(dropout_rate)
        self.ori_fc = nn.Linear(in_features, n_ori_outputs, bias=use_bias)
        self.pos_fc = nn.Linear(in_features, n_pos_outputs, bias=use_bias)
        for fc in (self.ori_fc, self.pos_fc):  # reference init: N(0, 0.01), zero bias
            nn.init.normal_(fc.weight, 0.0, 0.01, generator=generator)
            if fc.bias is not None:
                nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # Mean over H, W in the feature dtype (f32 accumulation), then the
        # head math in float32 for stable logits.
        x = x.mean(dim=(1, 2)).float()
        return self.ori_fc(self.ori_dropout(x)), self.pos_fc(x)
