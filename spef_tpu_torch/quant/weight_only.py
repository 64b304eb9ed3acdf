"""Weight-only int8 for any model of the port — PyTorch.

Counterpart of ``spef_tpu.quant.weight_only``: every conv and linear kernel
(the parameters flax names ``kernel``, rank 2 or more) is snapped to a
symmetric per-output-channel grid (``quant.fake_quant.quantize_weight``),
and the model runs its normal forward on the snapped weights.  This is the
quantization mode of the models outside the int8 graph's schema, the
keypoint heads among them (the engine's ``crop-refine-w8`` variant).

The grid is computed in flax's layout (the output channel last), so it is
JAX's bit for bit: a torch conv weight ``(O, I, kh, kw)`` is moved to HWIO,
snapped and moved back; a linear weight ``(out, in)`` is transposed.
BatchNorm parameters and biases stay as they are.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch
from torch import nn

from spef_tpu_torch.quant.fake_quant import quantize_weight

__all__ = ["quantize_model_weights"]


def _snap(w: torch.Tensor, bits: int, per_channel: bool) -> torch.Tensor:
    if w.dim() == 4:
        flax = w.permute(2, 3, 1, 0)  # OIHW -> HWIO
        return quantize_weight(flax, bits, per_channel).permute(3, 2, 0, 1).contiguous()
    if w.dim() == 2:
        return quantize_weight(w.t(), bits, per_channel).t().contiguous()
    return quantize_weight(w, bits, per_channel)


@torch.no_grad()
def quantize_model_weights(model: nn.Module, bits: int = 8, per_channel: bool = True,
                           min_size: int = 0) -> Tuple[nn.Module, Dict[str, int]]:
    """A copy of ``model`` with every conv / linear kernel on its int{bits}
    grid, and JAX's stats: ``n_quantized``, ``params_quantized`` (kernels
    snapped, their values) and ``params_kept`` (the other parameters'
    values).  ``min_size`` leaves smaller kernels as they are.  ``model``
    itself is not changed."""
    new = copy.deepcopy(model)
    stats = {"n_quantized": 0, "params_quantized": 0, "params_kept": 0}
    for module in new.modules():
        is_norm = isinstance(module, nn.modules.batchnorm._BatchNorm)
        for name, p in module.named_parameters(recurse=False):
            if name == "weight" and not is_norm and p.dim() >= 2 and p.numel() >= min_size:
                p.copy_(_snap(p, bits, per_channel))
                stats["n_quantized"] += 1
                stats["params_quantized"] += p.numel()
            else:
                stats["params_kept"] += p.numel()
    return new, stats
