"""A plain integer forward of the boundary-recipe int8 graph (MobileNetV2 +
URSONet as a converted layer graph), PyTorch, float32 with TF32 off.

The graph is the dict the build chain writes: per layer the integer
weights ``w_int`` (HWIO), a per-channel multiplier ``mult_core`` and bias;
activation grids ``act_step`` / ``act_qmax``; the shared signed grids of
the residual adds; the pooled int8 head.  Semantics:

  * 1x1 convolutions on an input that lies on a grid are exact integer
    products (the input re-derived as ``round(x / step)``, summed in
    float64, exact at these sizes), then ``acc * step * mult + bias``; on a
    real-valued input (the boundary recipe's depthwise output) the input is
    rounded to bf16 and summed in float32;
  * the stem and the depthwise layers are float32 convolutions of the
    integer weights, the multiplier in the epilogue;
  * an activation is snapped to its grid as ``clip(round(y / step)) * step``
    with an IEEE division;
  * the head pools the head conv's output, snaps the mean to the pool grid
    and applies the int8 dense heads exactly.

``lowp="int4"`` is the control: every layer's integer weights snapped to a
grid sixteen times coarser (``clip(round(w / 16), -8, 7) * 16``), int4
weights under the same multipliers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _div(y: torch.Tensor, d: float) -> torch.Tensor:
    return y / torch.full((), d, dtype=torch.float32, device=y.device)


def _snap(y: torch.Tensor, step: float, qmax: float, qmin: float = 0.0) -> torch.Tensor:
    return torch.clamp(torch.round(_div(y, step)), qmin, qmax) * step


def _int4(w: np.ndarray) -> np.ndarray:
    return np.clip(np.round(w.astype(np.float64) / 16.0), -8, 7) * 16.0


def prepare(graph: Dict[str, Any], device, lowp: Optional[str] = None) -> Dict[str, Any]:
    """Device tensors of every layer: ``w`` OIHW float32, ``w2d`` (K, N)
    float64 for the 1x1 layers, ``mult`` and ``bias`` float32."""
    def layer(e):
        w = np.asarray(e["w_int"]).astype(np.float64)
        if lowp == "int4":
            w = _int4(w)
        out = dict(e)
        out["w"] = torch.tensor(w.transpose(3, 2, 0, 1), dtype=torch.float32, device=device)
        if w.shape[0] == 1:
            out["w2d"] = torch.tensor(w.reshape(w.shape[-2], w.shape[-1]), dtype=torch.float64,
                                      device=device)
        out["mult"] = torch.tensor(np.asarray(e["mult_core"], np.float32), device=device)
        out["bias_t"] = torch.tensor(np.asarray(e["bias"], np.float32), device=device)
        return out

    g = dict(graph)
    g["stem"] = layer(graph["stem"])
    g["blocks"] = [{**b, **{k: layer(b[k]) for k in ("expand", "depthwise", "project") if k in b}}
                   for b in graph["blocks"]]
    g["head_conv"] = layer(graph["head_conv"])
    head = dict(graph["head"])
    for n in ("ori", "pos"):
        w = np.asarray(head[f"{n}_w_int"]).astype(np.float64)
        head[f"{n}_w"] = torch.tensor(_int4(w) if lowp == "int4" else w, dtype=torch.float64,
                                      device=device)
        head[f"{n}_s"] = torch.tensor(np.asarray(head[f"{n}_scale"], np.float32), device=device)
        head[f"{n}_b"] = torch.tensor(np.asarray(head[f"{n}_bias"], np.float32), device=device)
    g["head"] = head
    return g


def _conv(x: torch.Tensor, e: Dict[str, Any], relu: bool) -> torch.Tensor:
    w = e["w"]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, stride=e["stride"],
                 padding=(w.shape[-1] - 1) // 2, groups=e["groups"]).permute(0, 2, 3, 1)
    y = y * e["mult"] + e["bias_t"]
    return torch.clamp_min(y, 0.0) if relu else y


def _mm(x: torch.Tensor, e: Dict[str, Any], in_step: Optional[float], relu: bool
        ) -> torch.Tensor:
    b, h, w, cin = x.shape
    if in_step is not None:
        acc = (torch.round(_div(x, in_step)).reshape(-1, cin).double() @ e["w2d"]).float()
        mult = torch.tensor(np.float32(in_step) * np.asarray(e["mult_core"], np.float32),
                            device=x.device)
        y = acc * mult + e["bias_t"]
    else:
        acc = x.reshape(-1, cin).to(torch.bfloat16).float() @ e["w2d"].float()
        y = acc * e["mult"] + e["bias_t"]
    y = y.reshape(b, h, w, -1)
    return torch.clamp_min(y, 0.0) if relu else y


def forward(g: Dict[str, Any], images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC frames -> (orientation, position) logits of a prepared graph."""
    x = _div(images.float(), 255.0)
    stem = g["stem"]
    y = _snap(_conv(x, stem, True), stem["act_step"], stem["act_qmax"])
    step = stem["act_step"]
    for blk in g["blocks"]:
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            y = _snap(y, blk["shared_step"], blk["shared_qmax"], -blk["shared_qmax"] - 1)
            step = blk["shared_step"]
        h, h_step = y, step
        if "expand" in blk:
            e = blk["expand"]
            h = _mm(h, e, h_step, True)
            h_step = None
            if "act_step" in e:
                h, h_step = _snap(h, e["act_step"], e["act_qmax"]), e["act_step"]
        d = blk["depthwise"]
        h = _conv(h, d, True)
        h_step = None
        if "act_step" in d:
            h, h_step = _snap(h, d["act_step"], d["act_qmax"]), d["act_step"]
        h = _mm(h, blk["project"], h_step, False)
        if blk["use_residual"]:
            h = _snap(h, blk["shared_step"], blk["shared_qmax"], -blk["shared_qmax"] - 1)
            y, step = h + y, blk["shared_step"]
        else:
            y, step = h, None
    fs = g["final_shared"]
    y = _snap(y, fs["step"], fs["qmax"], -fs["qmax"] - 1)
    hc = g["head_conv"]
    y = _snap(_mm(y, hc, fs["step"], True), hc["act_step"], hc["act_qmax"])
    head = g["head"]
    pooled = _snap(y.mean(dim=(1, 2)), head["pool_step"], head["pool_qmax"],
                   -head["pool_qmax"] - 1)
    p_int = torch.round(_div(pooled, head["pool_step"])).double()

    def fc(n):
        scale = head[f"{n}_s"] * np.float32(head["pool_step"])
        return (p_int @ head[f"{n}_w"]).float() * scale + head[f"{n}_b"]

    return fc("ori"), fc("pos")
