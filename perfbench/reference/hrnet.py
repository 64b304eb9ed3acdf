"""HRNet-W32 (Sun et al., arXiv:1902.09212; the pose configuration
``w32_256x192``) with a 1x1 heatmap layer and the integral soft-argmax,
plain PyTorch in float32 with TF32 off: seeded leaves drawn from the
configuration's sizes, a functional forward over them, the BatchNorm
calibration that sets their running statistics, and a strict load of them
into a module named alike.

The leaves are named and laid out as ``torch.nn`` keeps a module tree of
that shape (``backbone.stage3.1.fuse.2.0.1.conv.weight`` OIHW,
``*.bn.running_mean``, ``head.final_layer.bias``): every convolution that
``roofline_hrnet.convs`` lists, under its name; the sizes come from the
configuration file (``stage1_blocks``, ``stage_modules``, ``branch_blocks``,
``bn_eps``, ``heatmap_logit_std``; the widths are the leaves' own).  The
program under test takes these leaves (``load``) and none of its own: its
init and its parameter layout are then held to the reference's, not taken
from them.

Departures from the paper, as the configuration states them: the heatmaps
are decoded by a spatial softmax and the expected pixel-centre coordinates
(Sun et al., arXiv:1711.08229), returned as the logits of the normalized
(x, y), where HRNet takes each heatmap's arg-max with a quarter-pixel
shift; 12 heatmaps (the origin and the 11 Tango keypoints).

``lowp="fp8"`` is the control: every convolution's two operands rounded to
float8 e4m3 with a per-tensor scale (``reference.model.fp8``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import exact_f32, fp8
from perfbench.roofline_hrnet import convs

Leaves = Dict[str, torch.Tensor]
Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

__all__ = ["exact_f32", "init_leaves", "load", "forward", "backbone", "calibrate",
           "heatmaps_to_logits"]

# The seeded BatchNorm affine: scale 1 + AFFINE_STD * N(0, 1), shift
# AFFINE_STD * N(0, 1), so that a scale and a shift that trade places, or
# either one dropped, changes every layer's output.
AFFINE_STD = 0.1


def init_leaves(cfg: Dict, seed: int) -> Leaves:
    """Float32 leaves on the CPU from ``seed``, in ``roofline_hrnet.convs``'
    order: each conv's OIHW weight He-normal (fan-out, as HRNet's
    repository draws its convs), its BatchNorm's affine as ``AFFINE_STD``
    says and running statistics 0 and 1 (``calibrate`` sets them); the
    final layer LeCun-normal (variance 1 / fan-in), its bias
    ``AFFINE_STD * N(0, 1)``."""
    gen = torch.Generator().manual_seed(seed)
    leaves: Leaves = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for c in convs(cfg):
        name, cin, cout, taps = c["name"], c["cin"], c["cout"], c["k"] ** 2
        shape = (cout, cin, c["k"], c["k"])
        if name.startswith("head."):
            leaves[f"{name}.weight"] = normal(shape, math.sqrt(1.0 / (cin * taps)))
            leaves[f"{name}.bias"] = normal(cout, AFFINE_STD)
            continue
        leaves[f"{name}.conv.weight"] = normal(shape, math.sqrt(2.0 / (cout * taps)))
        leaves[f"{name}.bn.weight"] = 1.0 + normal(cout, AFFINE_STD)
        leaves[f"{name}.bn.bias"] = normal(cout, AFFINE_STD)
        leaves[f"{name}.bn.running_mean"] = torch.zeros(cout)
        leaves[f"{name}.bn.running_var"] = torch.ones(cout)
    return leaves


def load(module: torch.nn.Module, leaves: Leaves) -> torch.nn.Module:
    """``module`` with every parameter and buffer copied from ``leaves``,
    strictly: a leaf with no twin, a twin with no leaf or a shape that
    differs raises.  Only BatchNorm's ``num_batches_tracked``, which no
    forward in eval mode reads, keeps the module's own."""
    state = dict(leaves)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state.setdefault(k, v)
    module.load_state_dict(state, strict=True)
    return module


def _stages(cfg: Dict) -> Iterator[Tuple[int, int, int, bool]]:
    """(stage, module, branches, multi_scale_output) of every module of
    stages 2-4; the last module of all outputs branch 1 alone."""
    mods = cfg["stage_modules"]
    for s, n in enumerate(mods, start=2):
        for m in range(n):
            yield s, m, s, not (s == 1 + len(mods) and m == n - 1)


def forward(leaves: Leaves, images: torch.Tensor, cfg: Dict, lowp: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC float images in [0, 1] -> (the heatmaps' log-probabilities
    (B, K, H*W), the keypoint logits (B, 2K))."""
    q = fp8 if lowp == "fp8" else (lambda t: t)
    w, bias = leaves["head.final_layer.weight"], leaves["head.final_layer.bias"]
    heatmaps = F.conv2d(q(backbone(leaves, images, cfg, q)), q(w)) + bias[:, None, None]
    return heatmaps_to_logits(heatmaps)


def backbone(leaves: Leaves, images: torch.Tensor, cfg: Dict, q=lambda t: t,
             batch_stats: Optional[Stats] = None) -> torch.Tensor:
    """NHWC float images in [0, 1] -> the NCHW 1/4-resolution features,
    every convolution's operands passed through ``q``.  With
    ``batch_stats`` (a dict) every BatchNorm takes its batch's mean and
    biased variance, put there under the conv's name; else its running
    statistics."""
    eps = cfg["bn_eps"]

    def cbn(name: str, x: torch.Tensor, stride: int = 1, relu: bool = True,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = leaves[f"{name}.conv.weight"]
        y = F.conv2d(q(x), q(w), stride=stride, padding=(w.shape[-1] - 1) // 2)
        if batch_stats is not None:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            batch_stats[name] = (mean, var)
        else:
            mean, var = leaves[f"{name}.bn.running_mean"], leaves[f"{name}.bn.running_var"]
        y = (y - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
        y = y * leaves[f"{name}.bn.weight"][:, None, None] \
            + leaves[f"{name}.bn.bias"][:, None, None]
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu or residual is not None else y

    x = images.permute(0, 3, 1, 2).to(leaves["backbone.conv1.conv.weight"].dtype)
    x = cbn("backbone.conv2", cbn("backbone.conv1", x, 2), 2)
    for b in range(cfg["stage1_blocks"]):
        p = f"backbone.layer1.{b}"
        identity = cbn(f"{p}.downsample", x, relu=False) if f"{p}.downsample.conv.weight" in \
            leaves else x
        x = cbn(f"{p}.conv3", cbn(f"{p}.conv2", cbn(f"{p}.conv1", x)), residual=identity)
    xs = [cbn("backbone.transition1.0", x), cbn("backbone.transition1.1", x, 2)]
    for s, m, n, multi in _stages(cfg):
        if m == 0 and s > 2:
            xs = xs + [cbn(f"backbone.transition{s - 1}", xs[-1], 2)]
        p = f"backbone.stage{s}.{m}"
        for i in range(n):
            for b in range(cfg["branch_blocks"]):
                pb = f"{p}.branches.{i}.{b}"
                xs[i] = cbn(f"{pb}.conv2", cbn(f"{pb}.conv1", xs[i]), residual=xs[i])
        fused: List[torch.Tensor] = []
        for i in range(n if multi else 1):
            y = None
            for j in range(n):
                t = xs[j]
                if j > i:
                    up = 2 ** (j - i)
                    t = cbn(f"{p}.fuse.{i}.{j}", t, relu=False)
                    t = t.repeat_interleave(up, dim=2).repeat_interleave(up, dim=3)
                for k in range(i - j):
                    t = cbn(f"{p}.fuse.{i}.{j}.{k}", t, 2, relu=k != i - j - 1)
                y = t if y is None else y + t
            fused.append(torch.relu(y))
        xs = fused
    return xs[0]


def heatmaps_to_logits(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, H, W) heatmaps -> (log-probabilities (B, K, H*W), the logits
    (B, 2K) of each expected normalized (x, y), pixel centres at
    ``(i + 0.5) / size``, clipped to [1e-6, 1 - 1e-6])."""
    b, k, h, w = heatmaps.shape
    logp = torch.log_softmax(heatmaps.reshape(b, k, h * w), dim=-1)
    p = logp.exp().reshape(b, k, h, w)
    ys = (torch.arange(h, dtype=p.dtype, device=p.device) + 0.5) / h
    xs = (torch.arange(w, dtype=p.dtype, device=p.device) + 0.5) / w
    coords = torch.stack([(p.sum(2) * xs).sum(-1), (p.sum(3) * ys).sum(-1)], -1)
    coords = coords.reshape(b, 2 * k).clamp(1e-6, 1.0 - 1e-6)
    return logp, torch.log(coords / (1.0 - coords))


def calibrate(leaves: Leaves, images: torch.Tensor, cfg: Dict) -> Leaves:
    """The leaves with every BatchNorm's running mean and variance set to
    the (biased) statistics of its input batch over ``images`` (NHWC in
    [0, 1]) in one float32 pass, each layer normalized by its own as it
    goes, and each heatmap's weights of the final layer scaled so that its
    output has the standard deviation ``cfg["heatmap_logit_std"]`` over
    those frames (a data-dependent init of the one layer no BatchNorm
    follows).

    Seeded weights then keep every layer at unit scale, as a trained net's
    are, and the heatmaps broad.  Without the BatchNorm statistics the
    residual and exchange sums grow the features without bound; without the
    final layer's scale the heatmaps of seeded weights put most of a map's
    mass on a few pixels, whose soft-argmax then jumps between far-apart
    near-equal peaks on a rounding."""
    stats: Stats = {}
    with torch.no_grad(), exact_f32():
        feats = backbone(leaves, images, cfg, batch_stats=stats)
        w = leaves["head.final_layer.weight"]
        sd = F.conv2d(feats, w).std(dim=(0, 2, 3))
    out = dict(leaves)
    for name, (mean, var) in stats.items():
        out[f"{name}.bn.running_mean"], out[f"{name}.bn.running_var"] = mean, var
    out["head.final_layer.weight"] = w * (cfg["heatmap_logit_std"] / sd)[:, None, None, None]
    return out
