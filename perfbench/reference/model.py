"""MobileNetV2 width 1.0 (Sandler et al., arXiv:1801.04381) with the URSONet
soft-classification heads (Proenca and Gao, arXiv:1907.04298), plain
PyTorch in float32 with TF32 off: a functional forward over a dict of
leaves, for serving (BatchNorm on running statistics) and training
(BatchNorm on the batch's mean and biased variance, dropout 0.2 on the
orientation branch with a mask the caller draws).

The leaves are named and laid out as ``torch.nn`` keeps them
(``backbone.block_3.expand.conv.weight`` OIHW, ``head.ori_fc.weight``
(out, in)).  Departures from the paper's MobileNetV2, as the recipe has
them: ReLU rather than ReLU6, BatchNorm epsilon 1e-5, a mean pool and two
dense heads in place of the classifier.

``lowp="fp8"`` is the control, the usual float8 recipe: every
convolution's and dense layer's two operands rounded to e4m3 and, in
training, the gradient of its output to e5m2, each with a per-tensor scale
(the largest magnitude to the format's largest).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaves = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 convolutions and products without TF32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8_round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / torch.clamp(t.abs().amax(), min=1e-30)
    return (t * scale).to(dtype).float().to(t.dtype) / scale


class _Fp8Operand(torch.autograd.Function):
    """A product's operand in float8 e4m3 (per-tensor scale); the gradient
    passes through."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient of a product's output in float8 e5m2
    (per-tensor scale), as the backward products read it."""

    @staticmethod
    def forward(ctx, t):
        return t

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Operand.apply(t)


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Grad.apply(t)


def conv_specs(cfg: Dict) -> List[Tuple[str, int, int, int, int, bool]]:
    """(name, cin, cout, kernel, stride, relu) of every convolution; groups
    are ``cin`` for the depthwise ones (cin == cout, kernel 3, name
    ``*.depthwise``)."""
    c = cfg["stem_channels"]
    specs = [("backbone.stem", cfg["channels"], c, 3, 2, True)]
    i = 0
    for t, cout, n, s in cfg["settings"]:
        for r in range(n):
            ch = c * t
            if t != 1:
                specs.append((f"backbone.block_{i}.expand", c, ch, 1, 1, True))
            specs.append((f"backbone.block_{i}.depthwise", ch, ch, 3, s if r == 0 else 1, True))
            specs.append((f"backbone.block_{i}.project", ch, cout, 1, 1, False))
            c = cout
            i += 1
    specs.append(("backbone.head_conv", c, cfg["head_conv_channels"], 1, 1, True))
    return specs


def leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every trainable leaf's shape, in ``named_parameters`` order."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, cin, cout, k, _, _ in conv_specs(cfg):
        groups = cin if name.endswith("depthwise") else 1
        shapes[f"{name}.conv.weight"] = (cout, cin // groups, k, k)
        shapes[f"{name}.bn.weight"] = (cout,)
        shapes[f"{name}.bn.bias"] = (cout,)
    feat = cfg["head_conv_channels"]
    for head, n in (("ori_fc", cfg["n_ori_bins"]), ("pos_fc", cfg["n_pos_bins"])):
        shapes[f"head.{head}.weight"] = (n, feat)
        shapes[f"head.{head}.bias"] = (n,)
    return shapes


def trainable(cfg: Dict, leaves: Leaves) -> Leaves:
    """The trainable leaves of a checkpoint's, in ``named_parameters`` order."""
    return {k: leaves[k] for k in leaf_shapes(cfg)}


def from_flax(tree: Dict, device) -> Leaves:
    """Leaves and BatchNorm running statistics of a flax variable tree."""
    out: Leaves = {}

    def walk(node, path, collection):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k], collection)
                continue
            name = ".".join(path)
            if k == "kernel":
                t = torch.from_numpy(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
                k = "weight"
            else:
                t = torch.from_numpy(v)
                k = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(k, k)
            out[f"{name}.{k}"] = t.to(device=device, dtype=torch.float32).contiguous()

    walk(tree["params"], [], "params")
    walk(tree.get("batch_stats", {}), [], "batch_stats")
    return out


def forward(leaves: Leaves, images: torch.Tensor, cfg: Dict, train: bool = False,
            ori_keep: Optional[torch.Tensor] = None, lowp: Optional[str] = None,
            batch_stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC float images in [0, 1] -> (orientation, position) logits, in the
    leaves' precision.
    ``train``: BatchNorm on batch statistics (each convolution's mean and
    biased variance put in ``batch_stats`` under its name, where given)
    and, where ``ori_keep`` (the dropout's keep mask of the pooled
    features) is given, dropout."""
    q = fp8 if lowp == "fp8" else (lambda t: t)
    g = fp8_grad if lowp == "fp8" else (lambda t: t)
    eps = cfg["bn_eps"]
    x = images.to(leaves["head.ori_fc.weight"].dtype).permute(0, 3, 1, 2)
    block, block_in = None, None
    for name, cin, _, k, stride, relu in conv_specs(cfg):
        parts = name.split(".")
        if parts[1] != block:  # a new block (or the stem, the head conv): its input
            block, block_in = parts[1], x
        w = leaves[f"{name}.conv.weight"]
        y = g(F.conv2d(q(x), q(w), stride=stride, padding=(k - 1) // 2,
                       groups=cin if parts[-1] == "depthwise" else 1))
        if train:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            if batch_stats is not None:
                batch_stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = leaves[f"{name}.bn.running_mean"], leaves[f"{name}.bn.running_var"]
        y = (y - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None]
        y = y * leaves[f"{name}.bn.weight"][None, :, None, None] \
            + leaves[f"{name}.bn.bias"][None, :, None, None]
        if relu:
            y = torch.relu(y)
        if parts[-1] == "project" and cfg["residual"] and y.shape == block_in.shape:
            y = y + block_in  # stride 1 and the same width
        x = y
    feat = x.mean(dim=(2, 3))
    ori_in = feat if ori_keep is None else torch.where(
        ori_keep, feat / (1.0 - cfg["ori_dropout"]), torch.zeros_like(feat))
    ori = g(q(ori_in) @ q(leaves["head.ori_fc.weight"]).T) + leaves["head.ori_fc.bias"]
    pos = g(q(feat) @ q(leaves["head.pos_fc.weight"]).T) + leaves["head.pos_fc.bias"]
    return ori, pos

