"""HRNet-W32 backbone — PyTorch, NHWC at its edge, channels_last inside.

The pose network of Sun et al., *Deep High-Resolution Representation
Learning for Human Pose Estimation* (arXiv:1902.09212), at the published
``w32`` widths of its pose configuration (``w32_256x192``): 28.5 M
parameters with its 1x1 heatmap layer; at 256x192 the paper gives 7.1 G
multiply-adds, a count of its convolutions 7.645 G.

  * stem: two 3x3 stride-2 convs, 3 -> 64 -> 64, each with BatchNorm and
    ReLU (1/4 resolution);
  * stage 1: four Bottlenecks (1x1 to 64, 3x3, 1x1 to 256), the first with
    a 1x1 projection of its identity;
  * transitions: a 3x3 conv to each new branch's width (32 at 1/4 from the
    stage-1 output; then stride 2 from the lowest branch to 64, 128, 256);
  * stages 2-4: 1, 4 and 3 modules over 2, 3 and 4 branches (widths 32,
    64, 128, 256), each branch four BasicBlocks, then the exchange: output
    ``i`` is the ReLU of the sum over inputs ``j`` of the input itself
    (``j = i``), a 1x1 conv with BatchNorm and nearest upsampling by
    ``2^(j-i)`` (``j > i``), or ``i - j`` stride-2 3x3 convs (``j < i``; the
    first ``i - j - 1`` keep the width, with BatchNorm and ReLU, the last
    goes to the output's width with BatchNorm alone);
  * the last module outputs branch 1 alone (``multi_scale_output=False``):
    32 channels at 1/4 resolution.

Every conv is a :class:`ConvBnAct` (bias-free, BatchNorm, Kaiming fan-out
init): the 1x1s take the fused bf16 kernel on the card in eval mode, the
dense 3x3s the unfused path.  The residual blocks apply their ReLU after the
add, so their last conv is ``ConvBnAct(activation=False)`` given the
identity as ``residual``, then a ReLU.  While a profiler runs, the stem and
each stage are spans ``spef.hrnet.{stem,stage1,...,stage4}`` (a stage's span
holds the transition that opens its new branch) and each exchange
``spef.hrnet.fuse``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spef_tpu_torch.models.layers import ConvBnAct
from spef_tpu_torch.models.mobilenet_v2 import _nchw
from spef_tpu_torch.utils import profiling

__all__ = ["HRNetW32"]

HRNET_W32_BRANCHES = (32, 64, 128, 256)  # branch widths, 1/4 to 1/32
HRNET_W32_MODULES = (1, 4, 3)  # modules of stages 2, 3 and 4
STEM_CHANNELS = 64
BLOCKS = 4  # Bottlenecks of stage 1, BasicBlocks a branch of a module
EXPANSION = 4  # the Bottleneck's 1x1 expansion


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 (x4 width), the identity (projected where the width
    changes) added before the last ReLU."""

    def __init__(self, cin: int, width: int, **kw):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = ConvBnAct(cin, width, kernel_size=1, **kw)
        self.conv2 = ConvBnAct(width, width, kernel_size=3, **kw)
        self.conv3 = ConvBnAct(width, cout, kernel_size=1, activation=False, **kw)
        self.downsample = (ConvBnAct(cin, cout, kernel_size=1, activation=False, **kw)
                           if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv3(self.conv2(self.conv1(x)), residual=identity))


class BasicBlock(nn.Module):
    """3x3, 3x3, the identity added before the last ReLU."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv1 = ConvBnAct(channels, channels, kernel_size=3, **kw)
        self.conv2 = ConvBnAct(channels, channels, kernel_size=3, activation=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv2(self.conv1(x), residual=x))


def _downsample(cin: int, cout: int, steps: int, **kw) -> nn.Sequential:
    """``steps`` stride-2 3x3 convs: the first ``steps - 1`` keep ``cin``
    (BatchNorm, ReLU), the last goes to ``cout`` (BatchNorm alone)."""
    return nn.Sequential(*[
        ConvBnAct(cin, cout if k == steps - 1 else cin, kernel_size=3, stride=2,
                  activation=k != steps - 1, **kw) for k in range(steps)])


class HRModule(nn.Module):
    """One module of a stage: ``BLOCKS`` BasicBlocks a branch, then the
    exchange into every branch (branch 1 alone with ``multi_scale_output``
    false)."""

    def __init__(self, widths: Sequence[int], multi_scale_output: bool = True, **kw):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, **kw) for _ in range(BLOCKS)]) for c in widths)
        self.fuse = nn.ModuleList()
        for i in range(n if multi_scale_output else 1):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(ConvBnAct(widths[j], widths[i], kernel_size=1, activation=False,
                                         **kw))
                elif j < i:
                    row.append(_downsample(widths[j], widths[i], i - j, **kw))
                else:
                    row.append(None)
            self.fuse.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        with profiling.span("hrnet.fuse"):
            out = []
            for i, row in enumerate(self.fuse):
                y = None
                for j, (layer, x) in enumerate(zip(row, xs)):
                    if j > i:
                        x = F.interpolate(layer(x), scale_factor=2 ** (j - i), mode="nearest")
                    elif j < i:
                        x = layer(x)
                    y = x if y is None else y + x
                out.append(torch.relu(y))
            return out


class HRNetW32(nn.Module):
    """Feature extractor: NHWC float images (height and width multiples of
    32) -> the NHWC 1/4-resolution map of ``out_features`` (32) channels."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_features = HRNET_W32_BRANCHES[0]
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        c = STEM_CHANNELS
        self.conv1 = ConvBnAct(3, c, kernel_size=3, stride=2, **kw)
        self.conv2 = ConvBnAct(c, c, kernel_size=3, stride=2, **kw)
        self.layer1 = nn.Sequential(*[Bottleneck(c if b == 0 else c * EXPANSION, c, **kw)
                                      for b in range(BLOCKS)])
        widths = HRNET_W32_BRANCHES
        self.transition1 = nn.ModuleList([
            ConvBnAct(c * EXPANSION, widths[0], kernel_size=3, **kw),
            ConvBnAct(c * EXPANSION, widths[1], kernel_size=3, stride=2, **kw)])
        for s, n_modules in enumerate(HRNET_W32_MODULES, start=2):
            if s > 2:  # the stride-2 3x3 conv that opens branch s from branch s - 1
                self.add_module(f"transition{s - 1}", ConvBnAct(
                    widths[s - 2], widths[s - 1], kernel_size=3, stride=2, **kw))
            last = s == 1 + len(HRNET_W32_MODULES)
            self.add_module(f"stage{s}", nn.Sequential(*[
                HRModule(widths[:s], multi_scale_output=not (last and m == n_modules - 1), **kw)
                for m in range(n_modules)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 32 or w % 32:
            raise ValueError(f"HRNet's four branches need a height and width divisible by 32, "
                             f"got {h}x{w}")
        with profiling.span("hrnet.stem"):
            x = self.conv2(self.conv1(_nchw(x, self.compute_dtype)))
        with profiling.span("hrnet.stage1"):
            x = self.layer1(x)
        with profiling.span("hrnet.stage2"):
            xs = self.stage2([t(x) for t in self.transition1])
        for s in range(3, 2 + len(HRNET_W32_MODULES)):
            with profiling.span(f"hrnet.stage{s}"):
                opened = getattr(self, f"transition{s - 1}")(xs[-1])
                xs = getattr(self, f"stage{s}")(xs + [opened])
        return xs[0].permute(0, 2, 3, 1)
