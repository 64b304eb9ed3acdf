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

On the card, an eval-mode ``ConvBnAct`` whose gradient is not needed, in
bf16 with BatchNorm, runs its 1x1 or 3x3 depthwise conv as one hand-written
kernel with the BatchNorm, the ReLU and a projection's residual add in its
epilogue (``ops/bf16_conv_bn.py``), in the same roundings; every other call
(train mode, grad enabled, the CPU, float32, the stem's geometry, channel
counts off multiples of 8, a trace) runs the conv and its epilogue as
separate PyTorch operations.  The
kernels' packed weights and BatchNorm terms are cached on the module and
packed again when a parameter or running statistic changes (its
``_version`` or ``data_ptr``).

Data parallel (``parallel/mesh.py``): with a ``mesh`` of more than one rank
(:func:`set_data_parallel`), train-mode BatchNorm takes the statistics of
the global batch, its moments summed over the ranks, and Dropout draws the
global batch's mask and keeps the rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spef_tpu_torch.ops import _build
from spef_tpu_torch.ops.bf16_conv_bn import (bf16_conv1x1_bn, bf16_depthwise3x3_bn, bn_terms,
                                             pack_conv1x1_weights, pack_depthwise_weights)
from spef_tpu_torch.utils import profiling

__all__ = ["BatchNorm", "ConvBnAct", "Dropout", "InvertedResidual", "kaiming_normal_fan_out_",
           "set_dropout_generator", "set_data_parallel"]

BN_EPS = 1e-5
BN_DECAY = 0.9  # flax momentum: running = 0.9 * running + 0.1 * batch
# Devices whose eval-mode convs run the fused kernels.  A test hook, not a
# setting: tests add the CPU (the wrappers then run the kernels' plain twins),
# and chip_smoke.py empties it for the unfused yardstick on the card.
_KERNEL_DEVICES = ("cuda",)


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
        self._kernel_cache = None  # (key, packed operands) of the fused kernels

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``residual`` (a projection's identity skip) is added last, ``residual + y``."""
        kind = self._kernel_kind(x, residual)
        if not self.training:
            profiling.count("forward.conv_plain" if kind is None else "forward.conv_fused")
        if kind is not None:
            return self._forward_kernel(kind, x, residual)
        cd = self.compute_dtype
        bias = None if self.conv.bias is None else self.conv.bias.to(cd)
        x = torch.nn.functional.conv2d(
            x.to(cd), self.conv.weight.to(cd), bias, self.conv.stride, self.conv.padding,
            self.conv.dilation, self.conv.groups)
        if self.bn is not None:
            x = self.bn(x.float()).to(cd)
        if self.activation:
            x = torch.relu(x)
        return x if residual is None else residual + x

    def _kernel_kind(self, x: torch.Tensor, residual: Optional[torch.Tensor]) -> Optional[str]:
        """``"1x1"`` or ``"dw3x3"`` where this call runs a fused kernel, else None.
        The kernels move 16 bytes a copy: channel counts multiples of 8,
        activations at 16-byte boundaries (as every MobileNetV2 layer's)."""
        conv = self.conv
        if (self.training or torch.is_grad_enabled() or x.device.type not in _KERNEL_DEVICES
                or self.compute_dtype != torch.bfloat16 or self.bn is None
                or conv.bias is not None or conv.dilation != (1, 1) or _build.traced(x)
                or conv.in_channels % 8 or conv.out_channels % 8 or x.data_ptr() % 16
                or (residual is not None and residual.data_ptr() % 16)):
            return None
        if (conv.kernel_size == (1, 1) and conv.groups == 1 and conv.stride == (1, 1)
                and conv.padding == (0, 0)):
            return "1x1"
        if (conv.kernel_size == (3, 3) and conv.groups == conv.in_channels == conv.out_channels
                and conv.stride in ((1, 1), (2, 2)) and conv.padding == (1, 1)):
            return "dw3x3"
        return None

    def _kernel_operands(self) -> dict:
        """The fused kernels' bf16 weights and f32 BatchNorm terms, packed
        once and again whenever a parameter or running statistic changed."""
        bn = self.bn
        sources = (self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        key = tuple((t._version, t.data_ptr()) for t in sources)
        cached = self._kernel_cache
        if cached is None or cached[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                scale, shift = bn_terms(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                        bn.eps)
                w = self.conv.weight
                w = pack_conv1x1_weights(w) if w.shape[2:] == (1, 1) else \
                    pack_depthwise_weights(w)
            cached = self._kernel_cache = (key, {"w": w, "scale": scale, "shift": shift})
        return cached[1]

    def _forward_kernel(self, kind: str, x: torch.Tensor,
                        residual: Optional[torch.Tensor]) -> torch.Tensor:
        """The conv, BatchNorm, ReLU (and a 1x1's residual add) as one kernel,
        on NHWC views of the channels_last tensors."""
        ops = self._kernel_operands()
        xh = x.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
        if kind == "dw3x3":
            y = bf16_depthwise3x3_bn(xh, ops["w"], ops["scale"], ops["shift"],
                                     self.conv.stride[0], self.activation)
            y = y.permute(0, 3, 1, 2)
            return y if residual is None else residual + y
        b, h, w, c = xh.shape
        res = None
        if residual is not None:
            res = residual.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous().view(b * h * w, -1)
        y = bf16_conv1x1_bn(xh.view(b * h * w, c), ops["w"], ops["scale"], ops["shift"],
                            self.activation, res)
        return y.view(b, h, w, -1).permute(0, 3, 1, 2)


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
        return self.project(self.depthwise(y), residual=x if self.use_residual else None)
