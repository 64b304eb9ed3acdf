"""Readable int8 executor and the weight-only mode — counterpart of
``spef_tpu.quant.int8_model``.

Executes the layer graph of :mod:`spef_tpu_torch.quant.convert` in plain
PyTorch (the JAX functions run outside any Pallas kernel too):

  * 1x1 convolutions as exact integer products: the input is re-derived as
    integers (``round(x / step)``) and summed in float64, which is exact for
    these sizes (CUDA has no int32 matmul);
  * depthwise 3x3 and the stem as float32 convolutions on the integer
    weights, with the per-channel multiplier in the epilogue (TF32 off);
  * activations travel as floats on their grids (``clip(round(y / step)) *
    step``), the divisions IEEE divisions.

:func:`build_weight_only_forward` runs the integer weights with bf16
activations and no activation requant but the learned ranges' clips.  Its
JAX twin sums bf16 x bf16 products in float32 (``preferred_element_type``);
a bf16 ``F.conv2d`` rounds that sum to bf16 before the epilogue, so the port
keeps the float32 sum another way.  The 1x1 convolutions, most of the
MACs, are bf16 x bf16 products with a float32 output
(``torch.mm(..., out_dtype=torch.float32)`` on the card; on the CPU, which
has no such kernel, the same bf16 operands multiplied in float32); the 3x3
stem and depthwise layers convolve the bf16-rounded operands in float32
with TF32 off.  Either way the products are exact and only the order of
the float32 sums can differ from JAX's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.quant.int8_graph import scalars, true_div

__all__ = ["int8_forward", "build_int8_forward", "build_weight_only_forward"]

Forward = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@contextlib.contextmanager
def f32_convs():
    """float32 convolutions and matmuls in float32 (cuDNN defaults to TF32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _plan(graph: Dict[str, Any], device: torch.device, conv_dtype: torch.dtype):
    """Device tensors of every layer: ``w`` (OIHW, ``conv_dtype``) and
    ``w2d`` (K, N) for 1x1 layers (float64 for the exact integer executor,
    else ``conv_dtype``), ``mult`` and ``bias`` float32."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def layer(entry):
        w = np.asarray(entry["w_int"])
        out = dict(entry)
        out["w"] = t(np.transpose(w.astype(np.float32), (3, 2, 0, 1)), conv_dtype)
        if w.shape[0] == 1:
            out["w2d"] = t(w.reshape(w.shape[-2], w.shape[-1]),
                           torch.float64 if conv_dtype == torch.float32 else conv_dtype)
        out["mult"] = t(np.asarray(entry["mult_core"], np.float32), torch.float32)
        out["bias_t"] = t(np.asarray(entry["bias"], np.float32), torch.float32)
        return out

    g = dict(graph)
    g["stem"] = layer(graph["stem"])
    g["blocks"] = [{**b, **{k: layer(b[k]) for k in ("expand", "depthwise", "project")
                            if k in b}} for b in graph["blocks"]]
    g["head_conv"] = layer(graph["head_conv"])
    head = graph["head"]
    g["head"] = dict(head, **{f"{n}_{k}_t": t(head[f"{n}_{k}"], dt)
                              for n in ("ori", "pos")
                              for k, dt in (("w_int", torch.float64), ("scale", torch.float32),
                                            ("bias", torch.float32))})
    return g


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, layer: Dict[str, Any]) -> torch.Tensor:
    """NHWC convolution of ``x`` by the layer's integer weights (float32
    sums; no epilogue)."""
    w = layer["w"]
    y = torch.nn.functional.conv2d(_nchw(x.to(w.dtype)).float(), w.float(),
                                   stride=layer["stride"], padding=(w.shape[-1] - 1) // 2,
                                   groups=layer["groups"])
    return y.permute(0, 2, 3, 1)


def _mm_f32_out(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """NHWC 1x1 convolution as ``(M, K) x (K, N)`` of bf16 operands with
    float32 products and sums: exact products, as ``preferred_element_type``
    gives JAX."""
    b, h, w, cin = x.shape
    a = x.reshape(-1, cin).to(w2d.dtype)
    if a.device.type == "cuda":
        y = torch.mm(a, w2d, out_dtype=torch.float32)
    else:
        y = a.float() @ w2d.float()
    return y.reshape(b, h, w, -1)


def _requant(y: torch.Tensor, step: float, qmax: float, qmin: float = 0.0) -> torch.Tensor:
    """Snap to a grid, staying in float: ``clip(round(y / step)) * step``."""
    return torch.clamp(torch.round(true_div(y, step)), qmin, qmax) * step


def _matmul_1x1(x: torch.Tensor, layer: Dict[str, Any], in_step, relu: bool) -> torch.Tensor:
    """1x1 conv: exact integer products where ``in_step`` is known (float64
    sums of integers), else bf16 operands summed in float32."""
    b, h, w, cin = x.shape
    if in_step is not None:
        x_int = torch.round(true_div(x, in_step)).reshape(-1, cin).double()
        acc = (x_int @ layer["w2d"]).float()
        m = torch.tensor(np.float32(in_step) * np.asarray(layer["mult_core"], np.float32),
                         device=x.device)
        y = acc * m + layer["bias_t"]
    else:
        xb = x.reshape(-1, cin).to(torch.bfloat16).float()
        acc = xb @ layer["w2d"].float()
        y = acc * layer["mult"] + layer["bias_t"]
    y = y.reshape(b, h, w, -1)
    return torch.clamp_min(y, 0.0) if relu else y


def _conv_f32(x: torch.Tensor, layer: Dict[str, Any], relu: bool) -> torch.Tensor:
    """Depthwise / spatial conv on the integer weights, float32 throughout:
    the input is real-valued (already on its grid), ``mult_core``
    dequantizes the weights in the epilogue."""
    y = _conv(x.float(), layer) * layer["mult"] + layer["bias_t"]
    return torch.clamp_min(y, 0.0) if relu else y


def int8_forward(graph: Dict[str, Any], images: torch.Tensor):
    """Full quantized forward on a planned graph (:func:`build_int8_forward`)."""
    if images.dtype == torch.uint8:
        x = true_div(images.float(), 255.0)
    else:
        levels = 2.0 ** graph["image_bits"] - 1.0
        x = true_div(torch.round(torch.clamp(images.float(), 0.0, 1.0) * levels), levels)

    stem = graph["stem"]
    y = _requant(_conv_f32(x, stem, relu=True), stem["act_step"], stem["act_qmax"])
    step = stem["act_step"]

    for blk in graph["blocks"]:
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            y = _requant(y, blk["shared_step"], blk["shared_qmax"], -blk["shared_qmax"] - 1)
            step = blk["shared_step"]
        residual = y
        h, h_step = y, step
        if "expand" in blk:
            e = blk["expand"]
            h = _matmul_1x1(h, e, h_step, relu=True)
            if "act_step" in e:
                h = _requant(h, e["act_step"], e["act_qmax"])
                h_step = e["act_step"]
            else:
                h_step = None  # unquantized expand: float output, no grid
        d = blk["depthwise"]
        h = _conv_f32(h, d, relu=True)
        if "act_step" in d:
            h = _requant(h, d["act_step"], d["act_qmax"])
            h_step = d["act_step"]
        else:
            h_step = None  # boundary recipe: real-valued depthwise output
        h = _matmul_1x1(h, blk["project"], h_step, relu=False)
        if blk["use_residual"]:
            h = _requant(h, blk["shared_step"], blk["shared_qmax"], -blk["shared_qmax"] - 1)
            y = h + residual
            step = blk["shared_step"]
        else:
            y, step = h, None

    fs = graph["final_shared"]
    y = _requant(y, fs["step"], fs["qmax"], -fs["qmax"] - 1)
    hc = graph["head_conv"]
    y = _matmul_1x1(y, hc, fs["step"], relu=True)
    y = _requant(y, hc["act_step"], hc["act_qmax"])

    head = graph["head"]
    pooled = y.mean(dim=(1, 2))
    pooled = _requant(pooled, head["pool_step"], head["pool_qmax"], -head["pool_qmax"] - 1)
    p_int = torch.round(true_div(pooled, head["pool_step"])).double()

    def fc(name):
        scale = head[f"{name}_scale_t"] * np.float32(head["pool_step"])
        return (p_int @ head[f"{name}_w_int_t"]).float() * scale + head[f"{name}_bias_t"]

    return fc("ori"), fc("pos")


def build_int8_forward(graph: Dict[str, Any],
                       device: Union[str, torch.device] = "cuda") -> Forward:
    """Plan the graph on ``device``; returns ``images -> (ori, pos)``."""
    planned = _plan(scalars(graph), torch.device(device), torch.float32)

    @torch.inference_mode()
    def forward(images: torch.Tensor):
        with f32_convs():
            return int8_forward(planned, images)

    return forward


def build_weight_only_forward(graph: Dict[str, Any],
                              device: Union[str, torch.device] = "cuda") -> Forward:
    """Weight-only deployment forward: the integer weights (dequantized by
    their per-channel multipliers, the QAT weight grid) on bf16 activations,
    with no activation requant, only the learned ranges' clips."""
    g = _plan(scalars(graph), torch.device(device), torch.bfloat16)

    def conv(x, layer, relu):
        y = (_mm_f32_out(x, layer["w2d"]) if "w2d" in layer else _conv(x, layer))
        y = y * layer["mult"] + layer["bias_t"]
        if relu:
            y = torch.clamp_min(y, 0.0)
        if "act_step" in layer:
            # Keep the learned activation range (the clip), drop the rounding:
            # a network trained on a narrow grid relies on the clamp.
            y = torch.clamp_max(y, layer["act_step"] * layer["act_qmax"])
        return y.to(torch.bfloat16)

    def shared_clip(y, blk):
        if "shared_step" in blk:
            lim = blk["shared_step"] * blk["shared_qmax"]
            y = torch.clamp(y, -lim - blk["shared_step"], lim)
        return y

    @torch.inference_mode()
    def forward(images: torch.Tensor):
        x = true_div(images.float(), 255.0) if images.dtype == torch.uint8 else images
        with f32_convs():
            y = conv(x, g["stem"], relu=True)
            for blk in g["blocks"]:
                if blk["input_quant"] or blk["use_residual"]:
                    y = shared_clip(y, blk)
                residual = y
                h = y
                if "expand" in blk:
                    h = conv(h, blk["expand"], relu=True)
                h = conv(h, blk["depthwise"], relu=True)
                h = conv(h, blk["project"], relu=False)
                y = h + residual if blk["use_residual"] else h
                if blk["use_residual"]:
                    y = shared_clip(y, blk)
            y = conv(y, g["head_conv"], relu=True)
            head = g["head"]
            pooled = y.float().mean(dim=(1, 2))

            def fc(name):
                w = head[f"{name}_w_int_t"].float() * head[f"{name}_scale_t"]
                return pooled @ w + head[f"{name}_bias_t"]

            return fc("ori"), fc("pos")

    return forward
