"""The recipe's training step, plain PyTorch in float32 with TF32 off:
the device augmentation with ``OTHER_AUGMENT`` (one Gaussian blur sigma a
batch, then a torchvision-style colour jitter a frame), the soft-class
targets, the train-mode forward with dropout on the orientation branch,
the two soft cross-entropies, autograd, and Adam (optax's update:
``m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)``).

The random values are drawn from a ``torch.Generator`` in the order the
program draws them from the one it is handed (the blur's sigma, the
jitter's brightness, contrast, saturation and hue, then the dropout's
uniforms), so the same seed gives the same augmentation and masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import model
from perfbench.reference.softclass import Codec


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _blur(x: torch.Tensor, sigma: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images, zero padding."""
    half = k // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k1 = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    k1 = k1 / k1.sum()
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k1.view(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, half), groups=c)
    y = F.conv2d(y, k1.view(1, 1, k, 1).expand(c, 1, k, 1), padding=(half, 0), groups=c)
    return y.permute(0, 2, 3, 1)


def _hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    h = torch.where(maxc == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    return torch.stack([torch.where(delta == 0, zero, h), s, maxc], -1)


def _rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i.to(torch.int32) % 6

    def pick(*c):
        out = c[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, c[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def augment(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Blur with one sigma in [0.1, 2], then brightness, contrast and
    saturation factors in [0.8, 1.2] and a hue shift in [-0.2, 0.2] a frame."""
    b = x.shape[0]
    x = _blur(x, _uniform(gen, (), 0.1, 2.0))
    bright = _uniform(gen, (b, 1, 1, 1), 0.8, 1.2)
    contrast = _uniform(gen, (b, 1, 1, 1), 0.8, 1.2)
    sat = _uniform(gen, (b, 1, 1, 1), 0.8, 1.2)
    hue = _uniform(gen, (b, 1, 1), -0.2, 0.2)
    x = torch.clamp(x * bright, 0.0, 1.0)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = torch.clamp((x - mean) * contrast + mean, 0.0, 1.0)
    hsv = _hsv(x)
    hsv = torch.stack([torch.remainder(hsv[..., 0] + hue, 1.0),
                       torch.clamp(hsv[..., 1] * sat[..., 0], 0.0, 1.0), hsv[..., 2]], -1)
    return torch.clamp(_rgb(hsv), 0.0, 1.0)


def run_steps(cfg: Dict, leaves: model.Leaves, batches: List[Tuple[torch.Tensor, ...]],
              gen: torch.Generator, lowp=None, stats: Optional[model.Leaves] = None,
              adam: Optional[Dict] = None) -> Dict[str, object]:
    """Adam steps from the trainable ``leaves``, BatchNorm's running
    statistics ``stats`` (none kept where None) and Adam's state ``adam``
    (``m``, ``v`` and the steps taken, ``t``; zero where None) on
    ``batches`` of (uint8 frames, ori, pos): the loss of each step, the
    first step's activated outputs, each leaf's first gradient, each leaf's
    change after the last step, and the running statistics (flax's decay:
    ``momentum * running + (1 - momentum) * batch``) and Adam's state after
    it."""
    tr = cfg["train"]
    b1, b2 = tr["betas"]
    decay = cfg["bn_momentum"]
    codec = Codec(cfg, leaves[next(iter(leaves))].device)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    m = {k: adam["m"][k].clone() if adam else torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: adam["v"][k].clone() if adam else torch.zeros_like(v) for k, v in params.items()}
    t0 = adam["t"] if adam else 0
    stats = {k: v.clone() for k, v in stats.items()} if stats is not None else None
    losses, first_grad, first_pdfs = [], {}, {}
    with model.exact_f32():
        for t, (u8, ori, pos) in enumerate(batches, start=t0 + 1):
            x = u8.float() / torch.full((), 255.0, device=u8.device)
            x = augment(gen, x)
            t_ori, t_pos = codec.encode(ori, pos)
            keep = torch.rand((x.shape[0], cfg["head_conv_channels"]), generator=gen,
                              device=gen.device) < 1.0 - cfg["ori_dropout"]
            seen: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
            lo, lp = model.forward(params, x, cfg, train=True, ori_keep=keep, lowp=lowp,
                                   batch_stats=seen)
            if t == t0 + 1:
                first_pdfs = {"ori_soft": torch.softmax(lo, -1).detach(),
                              "pos_soft": torch.softmax(lp, -1).detach()}
            loss = torch.mean(torch.sum(-(t_ori * torch.log(torch.softmax(lo, -1))), -1)) \
                + torch.mean(torch.sum(-(t_pos * torch.log(torch.softmax(lp, -1))), -1))
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(loss.item())
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    if t == t0 + 1:
                        first_grad[k] = g.clone()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(tr["eps"])
                    p.addcdiv_(m[k], denom, value=-tr["lr"] / (1 - b1 ** t))
                for name, (mean, var) in seen.items() if stats is not None else ():
                    stats[f"{name}.bn.running_mean"].mul_(decay).add_(mean, alpha=1 - decay)
                    stats[f"{name}.bn.running_var"].mul_(decay).add_(var, alpha=1 - decay)
    change = {k: (p.detach() - leaves[k]) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "first_pdfs": first_pdfs, "params": {k: p.detach() for k, p in params.items()},
            "stats": stats, "m": m, "v": v2, "t": t0 + len(batches)}
