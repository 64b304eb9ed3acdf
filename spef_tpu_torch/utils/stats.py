"""Per-layer model statistics: shapes, parameters, MACs.

Counterpart of ``spef_tpu.utils.stats`` (the reference's
``nn_stats.py::detailed_model_summary``): one row per parametric layer with
its kernel shape, output shape, parameter count and MACs, and per-type and
total summaries.  The output shapes come from forward hooks on one frame
(batch 1) through the model on its own device (the CPU in
``apps.nn_stats``).  The rows use JAX's layouts so that the two packages'
tables compare directly: kernels in HWIO order
(a ``Conv2d`` weight ``(O, I/g, kh, kw)`` is reported ``(kh, kw, I/g, O)``,
a ``Linear`` weight ``(out, in)`` as ``(in, out)``), outputs in NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["detailed_model_summary", "print_model_summary"]


def _conv_macs(kernel_shape, out_shape) -> int:
    """kh*kw*cin_per_group*cout * out_h*out_w (a sample)."""
    kh, kw, cin_g, cout = kernel_shape
    _, oh, ow, _ = out_shape
    return int(kh * kw * cin_g * cout * oh * ow)


def _out_shapes(model: nn.Module, img_size: Tuple[int, int]) -> Dict[str, Tuple[int, ...]]:
    """{module name: output shape} of every module whose output is one
    tensor, on one zero frame (4-D outputs as the module gives them, NCHW)."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def hook(name):
        def record(module, inputs, out):
            if torch.is_tensor(out):
                shapes.setdefault(name, tuple(out.shape))
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
    param = next(model.parameters())
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros((1, img_size[0], img_size[1], 3), device=param.device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return shapes


def detailed_model_summary(model: nn.Module, img_size: Tuple[int, int]) -> List[Dict[str, Any]]:
    """One row per parametric layer: {name, type, kernel_shape, out_shape,
    params, macs}, from the parameters as JAX's rows come from its
    ``params`` tree: a 4-D ``weight`` (OIHW) or flax-layout ``*_kernel``
    (HWIO) is a ``Conv2D``, a 2-D one a ``Dense``; BatchNorm's weight and
    bias are ``BatchNorm`` rows, other biases ``Bias`` rows; other
    parameters (quantizer scales) have no row, as in JAX.  A convolution
    its module calls functionally has the output shape of the module around
    it (conv + BN + activation), JAX's fallback to the enclosing module."""
    out_shapes = _out_shapes(model, img_size)
    modules = dict(model.named_modules())
    rows: List[Dict[str, Any]] = []
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        module = modules[mod_name]
        shape = tuple(p.shape)
        if isinstance(module, nn.BatchNorm2d):
            layer_type, kernel = "BatchNorm", None
        elif leaf == "bias" or leaf.endswith("_bias"):
            layer_type, kernel = "Bias", None
        elif leaf == "weight" or leaf.endswith("_kernel"):
            kernel = shape
            if leaf == "weight":  # torch layout: OIHW, (out, in)
                kernel = (shape[2], shape[3], shape[1], shape[0]) if p.dim() == 4 else shape[::-1]
            layer_type = "Conv2D" if p.dim() == 4 else "Dense"
        else:
            continue
        if kernel is None:
            rows.append({"name": name, "type": layer_type, "kernel_shape": shape,
                         "out_shape": None, "params": p.numel(), "macs": 0})
            continue
        out_shape = out_shapes.get(mod_name) or out_shapes.get(mod_name.rpartition(".")[0])
        if layer_type == "Conv2D":
            if out_shape is not None:
                n, c, h, w = out_shape
                out_shape = (n, h, w, c)
            macs = _conv_macs(kernel, out_shape) if out_shape else 0
        else:
            macs = int(np.prod(kernel))
        rows.append({"name": name if leaf.endswith("_kernel") else mod_name,
                     "type": layer_type, "kernel_shape": kernel, "out_shape": out_shape,
                     "params": p.numel(), "macs": macs})
    return rows


def print_model_summary(model: nn.Module, img_size: Tuple[int, int]) -> Dict[str, Any]:
    """Print the per-layer table and the per-type and total summary (JAX's
    format); returns {rows, by_type, total_params, total_macs}."""
    rows = detailed_model_summary(model, img_size)
    by_type: Dict[str, Dict[str, int]] = {}
    print(f"{'layer':60s} {'type':10s} {'params':>10s} {'MACs':>14s}  out_shape")
    for r in rows:
        if r["type"] in ("Conv2D", "Dense"):
            print(
                f"{r['name']:60s} {r['type']:10s} {r['params']:>10,d} {r['macs']:>14,d}  "
                f"{r['out_shape']}"
            )
        agg = by_type.setdefault(r["type"], {"params": 0, "macs": 0, "count": 0})
        agg["params"] += r["params"]
        agg["macs"] += r["macs"]
        agg["count"] += 1

    total_params = sum(v["params"] for v in by_type.values())
    total_macs = sum(v["macs"] for v in by_type.values())
    print("-" * 110)
    for t, agg in sorted(by_type.items()):
        print(f"{t:20s} x{agg['count']:<4d} params={agg['params']:>12,d} MACs={agg['macs']:>16,d}")
    print(f"{'TOTAL':20s}       params={total_params:>12,d} MACs={total_macs:>16,d}")
    return {"rows": rows, "by_type": by_type, "total_params": total_params,
            "total_macs": total_macs}
