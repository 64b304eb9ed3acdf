"""The int8-carry executor on K1 and K2 — counterpart of
``spef_tpu.quant.int8_carry.build_int8_carry_forward``, the deployed path.

Activations travel as int8 on tracked grids, with the carry's conventions
(not the bits-carry of ``int8_cuda.py``):

  * an unsigned 8-bit grid (qmax 255) is stored shifted, ``q - 128``; its
    consumer folds ``128 * step * mult * colsum(w)`` into its bias (float64,
    ``_zp_bias``) and a depthwise pads the shifted input with ``-128``, the
    shifted form of a real 0;
  * every requant to an int8 grid divides, ``round(y / step)`` (an IEEE
    division), and the grid changes between blocks multiply by the ratio of
    the steps, ``round((y + zp) * ratio)``;
  * a residual sum is exact on the shared grid, then multiplied to the
    consumer's grid, or clipped to int8 where the two steps are equal.

Every 1x1 convolution is one K1 call (``int8_matmul_requant``; the head
conv with a float32 output, requantized here), every depthwise one K2 call
(``int8_depthwise3x3``): 34 + 17 launches a flagship forward.  The stem is a
float32 convolution of the integer pixels with TF32 off (its 27-tap integer
sums are exact below 2^24) with the normalizer folded into the multiplier,
``f32(mult_core) * f32(1 / levels)``; the mean pool and the int8 FC are the
carry's own tail, ``pooled = (mean(y) + zp) * step``.

Integer inputs sum exactly, so on the integer recipes every int8 tensor and
logit equals JAX's.  Real-valued operands (the boundary recipe's bf16
projection inputs, a float handoff after an unquantized expand) are summed
in another order than XLA's, which can move an output by one step at a tie.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.ops.int8_ops import (
    int8_depthwise3x3,
    int8_depthwise3x3_plain,
    int8_matmul_requant,
    int8_matmul_requant_plain,
)
from spef_tpu_torch.quant.int8_graph import (
    build_head_tail, consumer_grid, mm_weights, scalars, true_div)
from spef_tpu_torch.quant.int8_model import f32_convs

__all__ = ["build_int8_carry_forward"]


def _zp(qmax: float) -> float:
    """Zero point of an unsigned grid stored in int8: 128 where qmax > 127."""
    return 128.0 if qmax > 127.0 else 0.0


def _zp_bias(entry: Dict[str, Any], in_step: float, in_zp: float) -> np.ndarray:
    """The consumer's bias with its producer's zero point folded in:
    ``conv(x - zp, w) = acc - zp * colsum(w)``, so the epilogue needs
    ``bias + zp * step * mult * colsum(w)`` (float64, then float32)."""
    if in_zp == 0.0:
        return np.asarray(entry["bias"], np.float32)
    colsum = np.asarray(entry["w_int"], np.float64).sum(axis=(0, 1, 2))
    corr = in_zp * in_step * np.asarray(entry["mult_core"], np.float64) * colsum
    return (np.asarray(entry["bias"], np.float64) + corr).astype(np.float32)


def _requant_int8(y: torch.Tensor, step: float, qmax: float, qmin: float = 0.0,
                  zp: float = 0.0) -> torch.Tensor:
    """Float -> int8 on the grid: ``clip(round(y / step)) - zp``."""
    return (torch.clamp(torch.round(true_div(y, step)), qmin, qmax) - zp).to(torch.int8)


def _ratio_requant(y: torch.Tensor, zp: float, ratio: float, qmax: float) -> torch.Tensor:
    """int8 (shifted by ``zp``) to a signed grid whose step is ``1 / ratio``
    of its own: ``clip(round((y + zp) * ratio))``."""
    return torch.clamp(torch.round((y.float() + zp) * ratio), -qmax - 1, qmax).to(torch.int8)


def build_int8_carry_forward(
    graph: Dict[str, Any],
    backend: str = "cuda",
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Plan the converted graph; returns ``images (B,H,W,3) -> (ori, pos)``.

    ``backend``: ``"cuda"`` calls the kernel wrappers (the kernels for CUDA
    tensors); ``"plain"`` their plain PyTorch versions, the reference the
    kernels are held against on the card.
    """
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend must be 'cuda' or 'plain', got {backend!r}")
    mm = int8_matmul_requant if backend == "cuda" else int8_matmul_requant_plain
    dw = int8_depthwise3x3 if backend == "cuda" else int8_depthwise3x3_plain
    dev = torch.device(device)
    graph = scalars(graph)
    f32 = np.float32

    def tensor(a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def mm_layer(entry: Dict[str, Any], in_step: float, in_zp: float, **kw) -> Dict[str, Any]:
        """K1's operands, the bias with the input's zero point folded in."""
        return {**mm_weights(entry, in_step, tensor),
                "bias": tensor(_zp_bias(entry, in_step, in_zp), torch.float32), "kw": kw}

    blocks = graph["blocks"]
    stem = graph["stem"]
    stem_plan = {
        "w": tensor(np.transpose(np.asarray(stem["w_int"], f32), (3, 2, 0, 1)), torch.float32),
        "bias": tensor(np.asarray(stem["bias"], f32), torch.float32),
        "step": float(stem["act_step"]), "qmax": float(stem["act_qmax"]),
        "zp": _zp(stem["act_qmax"]),
    }
    image_levels = 2.0 ** graph["image_bits"] - 1.0
    # The normalizer folds into the multiplier: f32(mult_core) * f32(1 / levels).
    stem_mult = {levels: tensor(np.asarray(stem["mult_core"], f32) * f32(1.0 / levels),
                                torch.float32) for levels in (255.0, image_levels)}
    step, zpc = stem_plan["step"], stem_plan["zp"]

    plan: List[Dict[str, Any]] = []
    for i, blk in enumerate(blocks):
        bp: Dict[str, Any] = {}
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            tgt, qmax = blk["shared_step"], blk["shared_qmax"]
            if qmax > 127.0:
                raise ValueError("shared grids are signed int8")
            if abs(step - tgt) > 1e-12 or zpc:
                bp["requant_in"] = {"zp": zpc, "ratio": step / tgt, "qmax": qmax}
            step, zpc = tgt, 0.0
        hstep, hzp = step, zpc
        float_handoff = False
        if "expand" in blk:
            e = blk["expand"]
            if "act_step" in e:
                ezp = _zp(e["act_qmax"])
                bp["expand"] = mm_layer(e, hstep, hzp, relu=True, out_inv_step=None,
                                        out_step=float(e["act_step"]),
                                        out_qmax=float(e["act_qmax"]), out_qmin=0.0,
                                        out_zp=int(ezp))
                hstep, hzp = e["act_step"], ezp
            else:
                # Unquantized expand: a float handoff, which the depthwise
                # rounds to bf16 on load.
                bp["expand"] = mm_layer(e, hstep, hzp, relu=True, out_inv_step=None)
                hstep, hzp, float_handoff = None, 0.0, True

        d = blk["depthwise"]
        hc = np.asarray(d["w_int"]).shape[-1]
        kw = dict(stride=int(d["stride"]), in_step=1.0 if float_handoff else float(hstep),
                  out_inv_step=None, halo=int(-hzp))
        if "act_step" in d:
            dzp = _zp(d["act_qmax"])
            kw.update(out_step=float(d["act_step"]), out_qmax=float(d["act_qmax"]),
                      out_zp=int(dzp))
        bp["depthwise"] = {
            "w": tensor(np.asarray(d["w_int"]).reshape(3, 3, hc), torch.int8),
            "mult": tensor(np.asarray(d["mult_core"], f32), torch.float32),
            "bias": tensor(_zp_bias(d, 0.0 if float_handoff else hstep, hzp), torch.float32),
            "kw": kw}
        if "act_step" in d:
            hstep, hzp = d["act_step"], dzp
        else:
            # Boundary recipe: real values (bf16) flow into the projection.
            hstep, hzp = 1.0, 0.0

        p = blk["project"]
        out_grid = consumer_grid(graph, i)
        if blk["use_residual"]:
            # project -> shared grid -> + residual (exact) -> the consumer's
            # grid by the ratio of the steps, or int8 where they are equal.
            shared = blk["shared_step"]
            kw = dict(relu=False, out_inv_step=None, out_step=float(shared),
                      out_qmax=float(blk["shared_qmax"]),
                      out_qmin=float(-blk["shared_qmax"] - 1))
            if out_grid is not None and abs(shared - out_grid["step"]) > 1e-12:
                kw.update(res_ratio=shared / out_grid["step"], res_qmax=float(out_grid["qmax"]),
                          res_qmin=float(out_grid["qmin"]))
                step = out_grid["step"]
            else:
                kw.update(res_ratio=1.0, res_qmax=127.0, res_qmin=-128.0)
                step = shared
        else:
            if out_grid is None:
                raise NotImplementedError("float block handoff is not in this family")
            kw = dict(relu=False, out_inv_step=None, out_step=float(out_grid["step"]),
                      out_qmax=float(out_grid["qmax"]), out_qmin=float(out_grid["qmin"]))
            step = out_grid["step"]
        bp["project"] = {**mm_layer(p, hstep, hzp, **kw), "residual": blk["use_residual"]}
        zpc = 0.0  # both emits land on signed consumer grids
        plan.append(bp)

    fs = graph["final_shared"]
    final_requant = None
    if abs(step - fs["step"]) > 1e-12 or zpc:
        final_requant = {"zp": zpc, "ratio": step / fs["step"], "qmax": fs["qmax"]}
        step, zpc = fs["step"], 0.0
    hcnv = graph["head_conv"]
    head_conv = mm_layer(hcnv, step, zpc, relu=True, out_inv_step=None)
    head_zp = _zp(hcnv["act_qmax"])
    head_step, head_qmax = float(hcnv["act_step"]), float(hcnv["act_qmax"])
    tail = build_head_tail(graph["head"], head_step, tensor, zp=head_zp)

    def run_mm(x: torch.Tensor, layer: Dict[str, Any], residual=None) -> torch.Tensor:
        b, h, w, c = x.shape
        out = mm(x.reshape(b * h * w, c), layer["w"], layer["mult"], layer["bias"],
                 residual=None if residual is None else residual.reshape(b * h * w, -1),
                 packed=layer["packed"], **layer["kw"])
        return out.view(b, h, w, -1)

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype == torch.uint8:
            x, levels = images.float(), 255.0
        else:
            x = torch.round(torch.clamp(images.float(), 0.0, 1.0) * image_levels)
            levels = image_levels
        # Stem: integer pixels, exact float32 sums (TF32 off).
        with f32_convs():
            acc = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), stem_plan["w"], stride=2,
                                             padding=1)
        acc = acc.permute(0, 2, 3, 1)
        yf = torch.clamp_min(acc * stem_mult[levels] + stem_plan["bias"], 0.0)
        y = _requant_int8(yf, stem_plan["step"], stem_plan["qmax"],
                          zp=stem_plan["zp"]).contiguous()

        for bp in plan:
            if "requant_in" in bp:
                r = bp["requant_in"]
                y = _ratio_requant(y, r["zp"], r["ratio"], r["qmax"])
            residual = y
            h = run_mm(y, bp["expand"]) if "expand" in bp else y
            d = bp["depthwise"]
            h = dw(h, d["w"], d["mult"], d["bias"], **d["kw"])
            p = bp["project"]
            y = run_mm(h, p, residual=residual if p["residual"] else None)

        if final_requant is not None:
            y = _ratio_requant(y, final_requant["zp"], final_requant["ratio"],
                               final_requant["qmax"])
        yf = run_mm(y, head_conv)
        return tail(_requant_int8(yf, head_step, head_qmax, zp=head_zp))

    forward.launches_per_call = {  # what one forward launches on backend="cuda"
        "int8_matmul_requant": sum(("expand" in bp) + 1 for bp in plan) + 1,
        "int8_depthwise3x3": len(plan),
    }
    forward.takes_uint8 = True
    return forward
