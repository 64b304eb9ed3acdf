"""Core NN layers — PyTorch, channels_last inside, NHWC at the model's edge.

Counterparts of ``spef_tpu.models.layers``: ``ConvBnAct`` and
``InvertedResidual`` with ReLU (not ReLU6), BatchNorm eps 1e-5 and running
statistics decayed by 0.9 a step (flax's ``momentum=0.9``, which is
PyTorch's ``momentum=0.1``), Kaiming-normal fan-out conv init drawn from an
explicit ``torch.Generator``.

``compute_dtype`` (default bfloat16, as in JAX) is the dtype of the conv
math; parameters stay float32 and BatchNorm runs in float32, then casts
back, as flax's ``BatchNorm(dtype=float32)`` does.  Modules take and return
NCHW tensors; the backbone keeps them in ``channels_last`` memory, so the
NHWC <-> NCHW permutes at its edge are free views.

:class:`BatchNorm` is flax's in train mode too: it normalizes by the biased
batch variance and decays the running statistics toward the *biased* one
(``torch.nn.BatchNorm2d`` decays toward the unbiased variance, n/(n-1)
larger).  :class:`Dropout` is flax's, its mask drawn from an explicit
``torch.Generator`` (:func:`set_dropout_generator`).

Data parallel (``parallel/mesh.py``): with a ``mesh`` of more than one rank
(:func:`set_data_parallel`), train-mode BatchNorm takes the statistics of
the global batch, its moments summed over the ranks, and Dropout draws the
global batch's mask and keeps the rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["BatchNorm", "ConvBnAct", "Dropout", "InvertedResidual", "kaiming_normal_fan_out_",
           "set_dropout_generator", "set_data_parallel"]

BN_EPS = 1e-5
BN_DECAY = 0.9  # flax momentum: running = 0.9 * running + 0.1 * batch


def kaiming_normal_fan_out_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """Reference conv init: normal with std sqrt(2 / fan_out)."""
    nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu", generator=generator)


class BatchNorm(nn.BatchNorm2d):
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW float32.

    Eval mode normalizes by the running statistics.  Train mode normalizes
    by the batch's mean and biased variance and moves the running
    statistics to ``0.9 * running + 0.1 * batch``, the variance term being
    the biased one, as flax's.  The batch statistics are the two-pass
    (Welford) ones of ``F.batch_norm`` and ``torch.var_mean``, where flax
    takes E[x^2] - E[x]^2 clipped at 0: the two differ by the one-pass
    form's rounding, about 2^-24 * (var + mean^2), which for a BN input (a
    mean within a few standard deviations of 0) is float32 noise, a few
    1e-7 of the variance.  The parameter and buffer names are
    ``BatchNorm2d``'s, which the flax weight carry maps.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - BN_DECAY)
        self.mesh = None  # set_data_parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.size > 1:
            return self._global_batch_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_DECAY).add_(mean, alpha=1.0 - BN_DECAY)
            self.running_var.mul_(BN_DECAY).add_(var, alpha=1.0 - BN_DECAY)
        return torch.nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                              self.eps)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the mesh's global batch: the sums of x and x^2
        all-reduced (differentiably), flax's one-pass mean and clipped
        variance, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
        from spef_tpu_torch.parallel.mesh import all_reduce_sum

        n = x.numel() // x.shape[1] * self.mesh.size
        sums = all_reduce_sum(self.mesh, torch.stack([x.sum(dim=(0, 2, 3)),
                                                      (x * x).sum(dim=(0, 2, 3))]))
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_DECAY).add_(mean, alpha=1.0 - BN_DECAY)
            self.running_var.mul_(BN_DECAY).add_(var, alpha=1.0 - BN_DECAY)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


class Dropout(nn.Module):
    """flax's ``Dropout``: in train mode each value is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The mask is drawn from
    ``self.generator`` (on the input's device), which the caller sets
    (:func:`set_dropout_generator`); a train-mode call without one raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.mesh = None  # set_data_parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout draws its mask from an explicit torch.Generator: "
                               "set_dropout_generator(model, generator) first")
        keep_prob = 1.0 - self.rate
        if self.mesh is not None and self.mesh.size > 1:  # the global batch's mask, our rows
            shape = (x.shape[0] * self.mesh.size,) + tuple(x.shape[1:])
            keep = torch.rand(shape, generator=self.generator, device=x.device)[
                self.mesh.rows(shape[0])] < keep_prob
        else:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Draw every :class:`Dropout` mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_data_parallel(model: nn.Module, mesh) -> None:
    """Give every :class:`BatchNorm` and :class:`Dropout` of ``model`` the
    data-parallel ``mesh`` (``parallel/mesh.py``; None to undo)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh


class ConvBnAct(nn.Module):
    """Conv2d + optional BatchNorm + optional ReLU (padding (k-1)//2 by default)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        groups: int = 1,
        use_bias: bool = False,
        batchnorm: bool = True,
        activation: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride, padding=pad,
                              groups=groups, bias=use_bias and not batchnorm)
        kaiming_normal_fan_out_(self.conv.weight, generator)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)
        self.bn = BatchNorm(features) if batchnorm else None
        self.activation = activation
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.conv.bias is None else self.conv.bias.to(cd)
        x = torch.nn.functional.conv2d(
            x.to(cd), self.conv.weight.to(cd), bias, self.conv.stride, self.conv.padding,
            self.conv.dilation, self.conv.groups)
        if self.bn is not None:
            x = self.bn(x.float()).to(cd)
        if self.activation:
            x = torch.relu(x)
        return x


class InvertedResidual(nn.Module):
    """MobileNet-V2 block: expand 1x1 (if t != 1) -> depthwise 3x3 (stride)
    -> project 1x1 (linear), identity skip when stride 1 and widths match."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        stride: int,
        expand_ratio: int,
        batchnorm: bool = True,
        residual: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        self.use_residual = stride == 1 and in_channels == features and residual
        hidden = int(round(in_channels * expand_ratio))
        kw = dict(batchnorm=batchnorm, compute_dtype=compute_dtype, generator=generator)
        self.expand = (ConvBnAct(in_channels, hidden, kernel_size=1, **kw)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBnAct(hidden, hidden, kernel_size=3, stride=stride, groups=hidden,
                                   **kw)
        self.project = ConvBnAct(hidden, features, kernel_size=1, activation=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        return x + y if self.use_residual else y
