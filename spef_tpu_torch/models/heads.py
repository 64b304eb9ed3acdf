"""Pose-estimation heads — PyTorch.

Counterparts of ``spef_tpu.models.heads``, each over the backbone's NHWC
feature map:

  * ``URSONetHead``: global average pool, then two fully connected branches
    (orientation, with flax's dropout 0.2 when training, and position), in
    float32;
  * ``KeypointRegressionHead``: the NHWC map flattened in (H, W, C) order
    (8 x 12 x 1280 = 122,880 inputs at 240x384), dropout 0.2, one fully
    connected layer to the 24 normalized keypoint coordinates;
  * ``KeypointHeatmapHead``: a 1x1 squeeze to 128 channels, two stages of
    nearest 2x upsampling and a 3x3 conv (bf16 convs, float32 BatchNorm,
    ReLU), a float32 1x1 conv to one heatmap a keypoint, a spatial softmax
    and the expected pixel-centre coordinates, returned as logits.

Dropout masks come from an explicit generator
(``models.layers.set_dropout_generator``).  Attribute names are the flax
module names, so flax checkpoints map onto the heads by path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spef_tpu_torch.codec.epnp import exact_f32
from spef_tpu_torch.models.layers import BatchNorm, Dropout
from spef_tpu_torch.utils import profiling

__all__ = ["URSONetHead", "KeypointRegressionHead", "KeypointHeatmapHead", "HRNetHeatmapHead"]


def _dense_init_(fc: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Reference dense init: N(0, 0.01), zero bias."""
    nn.init.normal_(fc.weight, 0.0, 0.01, generator=generator)
    if fc.bias is not None:
        nn.init.zeros_(fc.bias)


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default conv init: variance 1 / fan_in, normal truncated at
    two standard deviations."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def soft_argmax_logits(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """(B, K, H, W) float32 heatmaps -> (B, 2K) logits of the expected
    normalized (x, y) of each over pixel-centre grids, after a spatial
    softmax (the span ``spef.heatmap.softargmax``)."""
    with profiling.span("heatmap.softargmax"):
        b, k, h, w = heatmaps.shape
        p = torch.softmax(heatmaps.reshape(b, k, h * w) / temperature, dim=-1)
        p = p.reshape(b, k, h, w)
        ys = (torch.arange(h, dtype=torch.float32, device=heatmaps.device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=heatmaps.device) + 0.5) / w
        ex = torch.einsum("bkhw,w->bk", p, xs)
        ey = torch.einsum("bkhw,h->bk", p, ys)
        coords = torch.stack([ex, ey], dim=-1).reshape(b, 2 * k)
        eps = 1e-6
        coords = torch.clamp(coords, eps, 1.0 - eps)
        return torch.log(coords / (1.0 - coords))


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
        for fc in (self.ori_fc, self.pos_fc):
            _dense_init_(fc, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # Mean over H, W in the feature dtype (f32 accumulation), then the
        # head math in float32 for stable logits.
        x = x.mean(dim=(1, 2)).float()
        return self.ori_fc(self.ori_dropout(x)), self.pos_fc(x)


class KeypointRegressionHead(nn.Module):
    """One linear layer over the flattened NHWC feature map."""

    def __init__(self, in_features: int, n_outputs: int = 24, dropout_rate: float = 0.2,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(in_features, n_outputs, bias=use_bias)
        _dense_init_(self.fc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.dropout(x.reshape(x.shape[0], -1).float()))


class KeypointHeatmapHead(nn.Module):
    """Integral (soft-argmax) keypoint head: heatmaps, a spatial softmax and
    the expected (x, y) over pixel-centre grids, returned as the logits of
    the normalized coordinates (the pipeline's sigmoid inverts them)."""

    def __init__(self, in_features: int, n_outputs: int = 24, temperature: float = 1.0,
                 upsample: int = 2, refine_ch: int = 128,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_outputs % 2:
            raise ValueError(f"n_outputs must be even, got {n_outputs}")
        self.n_outputs = n_outputs
        self.temperature = temperature
        self.upsample = upsample
        self.compute_dtype = compute_dtype
        self.squeeze_conv = nn.Conv2d(in_features, refine_ch, 1, bias=False)
        self.squeeze_bn = BatchNorm(refine_ch)
        for i in range(upsample):
            self.add_module(f"up{i}_conv", nn.Conv2d(refine_ch, refine_ch, 3, padding=1,
                                                     bias=False))
            self.add_module(f"up{i}_bn", BatchNorm(refine_ch))
        self.heatmap_conv = nn.Conv2d(refine_ch, n_outputs // 2, 1, bias=True)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def _conv_bn_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        cd = self.compute_dtype
        x = F.conv2d(x.to(cd), conv.weight.to(cd), None, conv.stride, conv.padding)
        return torch.relu(bn(x.float()).to(cd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        exact_f32()  # the heatmap conv and the expectations in true float32
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view of channels_last memory)
        x = self._conv_bn_relu(x, "squeeze")
        for i in range(self.upsample):
            x = self._conv_bn_relu(F.interpolate(x, scale_factor=2, mode="nearest"), f"up{i}")
        return soft_argmax_logits(self.heatmap_conv(x.float()), self.temperature)


class HRNetHeatmapHead(nn.Module):
    """HRNet's 1x1 final layer (with bias, float32) to one heatmap a
    keypoint over the backbone's 1/4-resolution NHWC map, then the
    soft-argmax logits of :class:`KeypointHeatmapHead`."""

    def __init__(self, in_features: int = 32, n_outputs: int = 24,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_outputs % 2:
            raise ValueError(f"n_outputs must be even, got {n_outputs}")
        self.final_layer = nn.Conv2d(in_features, n_outputs // 2, 1, bias=True)
        _lecun_normal_(self.final_layer.weight, generator)
        nn.init.zeros_(self.final_layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        exact_f32()  # the heatmap conv and the expectations in true float32
        heatmaps = self.final_layer(x.permute(0, 3, 1, 2).float())  # (B, K, H, W)
        return soft_argmax_logits(heatmaps)
