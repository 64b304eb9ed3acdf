"""Int8 inference pipeline on the hand-written CUDA kernels K1 and K2.

Counterpart of ``spef_tpu.quant.int8_pallas.build_pallas_forward``, with the
same graph semantics and carry conventions:

  * activations travel as int8 on tracked quantization grids; unsigned
    8-bit grids (qmax 255) travel as uint8 bits in int8 containers
    (``_bits_int8``), decoded by their consumer (``in_unsigned``);
  * every 1x1 convolution is one K1 call (``int8_matmul_requant``) with its
    input step folded into the per-channel multiplier; every depthwise is
    one K2 call (``int8_depthwise3x3``), stride 1 or 2, int8 or real input,
    int8 or bf16 output;
  * the projection adds the residual on the shared grid and emits the exact
    sum already requantized to the next consumer's grid (``consumer_grid``).

Unlike the TPU executor, no layer leaves the kernels: Mosaic could not lower
strided or float-output depthwise, Hopper can.  The stem convolution (bf16
inputs, f32 sums, TF32 off), the grid changes between blocks, the mean pool
and the int8 FC head are plain tensor code, as XLA ran them in JAX.

The executor follows the Pallas kernels, not ``backend="xla"`` of the JAX
package, whose int32 dot truncates the boundary recipe's bf16 projection
input (ROADMAP §C).

The whole graph is planned once (folded multipliers, kernel arguments,
device-resident weights, K1's packed weight layouts); ``forward`` only
launches.
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
    bits_int8,
    build_head_tail,
    consumer_grid,
    emit_unsigned,
    load_int8_graph,
    mm_weights,
    requant_signed,
    scalars,
    true_div,
)
from spef_tpu_torch.quant.int8_model import f32_convs

__all__ = ["build_cuda_forward", "load_int8_graph"]


def build_cuda_forward(
    graph: Dict[str, Any],
    backend: str = "cuda",
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Plan the converted graph; returns ``images (B,H,W,3) -> (ori, pos)``.

    ``graph`` is the output of ``spef_tpu.quant.convert.convert_qat_params``
    (numpy arrays or Python scalars as leaves).  ``backend``: ``"cuda"`` calls the kernel
    wrappers (the kernels for CUDA tensors); ``"plain"`` calls the plain
    PyTorch versions of the same kernels — the reference the kernels are
    held against on the card.
    """
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend must be 'cuda' or 'plain', got {backend!r}")
    mm = int8_matmul_requant if backend == "cuda" else int8_matmul_requant_plain
    dw = int8_depthwise3x3 if backend == "cuda" else int8_depthwise3x3_plain
    dev = torch.device(device)
    f32 = np.float32
    graph = scalars(graph)

    def tensor(a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    blocks = graph["blocks"]

    # ---- plan: walk the graph once with the static step / bits bookkeeping.
    stem = graph["stem"]
    stem_plan = {
        "w": tensor(np.transpose(np.asarray(stem["w_int"], f32), (3, 2, 0, 1)), torch.float32),
        "mult": tensor(np.asarray(stem["mult_core"], f32), torch.float32),
        "bias": tensor(np.asarray(stem["bias"], f32), torch.float32),
        "step": float(stem["act_step"]), "qmax": float(stem["act_qmax"]),
        "wide": stem["act_qmax"] > 127.0,
    }
    step, wide = stem_plan["step"], stem_plan["wide"]
    plan: List[Dict[str, Any]] = []
    for i, blk in enumerate(blocks):
        bp: Dict[str, Any] = {}
        # Input requant to the block's shared grid (when the producer did not
        # already emit on it).
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            tgt = blk["shared_step"]
            if abs(step - tgt) > 1e-12 or wide:
                bp["requant_in"] = {"ratio": step / tgt, "qmax": blk["shared_qmax"],
                                    "wide": wide}
            step, wide = tgt, False
        hstep, hwide = step, wide
        float_handoff = False

        if "expand" in blk:
            e = blk["expand"]
            has_grid = "act_step" in e
            e_wide = has_grid and e["act_qmax"] > 127.0
            bp["expand"] = {**mm_weights(e, hstep, tensor), "kw": dict(
                relu=True,
                out_inv_step=float(1.0 / e["act_step"]) if has_grid else None,
                out_qmax=float(e["act_qmax"]) if has_grid else 127.0,
                out_qmin=0.0, in_unsigned=hwide, out_bits=e_wide)}
            wide, hwide = False, e_wide
            if has_grid:
                hstep = e["act_step"]
            else:
                # Unquantized expand (no act grid): the f32 output hands off
                # to the depthwise, which rounds it to bf16 on load.
                hstep, float_handoff = 1.0, True

        d = blk["depthwise"]
        dw_grid = "act_step" in d
        d_wide = dw_grid and d["act_qmax"] > 127.0
        hc = np.asarray(d["w_int"]).shape[-1]
        bp["depthwise"] = {
            "w": tensor(np.asarray(d["w_int"]).reshape(3, 3, hc), torch.int8),
            "mult": tensor(np.asarray(d["mult_core"], f32), torch.float32),
            "bias": tensor(np.asarray(d["bias"], f32), torch.float32),
            "kw": dict(stride=int(d["stride"]), in_step=1.0 if float_handoff else float(hstep),
                       out_inv_step=float(1.0 / d["act_step"]) if dw_grid else None,
                       out_qmax=float(d["act_qmax"]) if dw_grid else 127.0,
                       in_unsigned=False if float_handoff else hwide, out_bits=d_wide)}
        if not float_handoff:
            wide = False
        hwide = d_wide
        # Boundary recipe (no dw act grid): real values flow into the
        # projection, whose multiplier is then unscaled.
        hstep = d["act_step"] if dw_grid else 1.0

        p = blk["project"]
        out_grid = consumer_grid(graph, i)
        if out_grid is None:
            raise NotImplementedError("float handoff between blocks is not in this family")
        if blk["use_residual"]:
            # project -> requant to the shared grid -> +residual -> requant
            # the exact sum to the consumer grid, all in K1's epilogue.
            kw = dict(relu=False, out_inv_step=float(1.0 / blk["shared_step"]),
                      out_qmax=float(blk["shared_qmax"]),
                      out_qmin=float(-blk["shared_qmax"] - 1),
                      res_ratio=float(blk["shared_step"] / out_grid["step"]),
                      res_qmax=float(out_grid["qmax"]), res_qmin=float(out_grid["qmin"]),
                      in_unsigned=hwide)
        else:
            kw = dict(relu=False, out_inv_step=float(1.0 / out_grid["step"]),
                      out_qmax=float(out_grid["qmax"]), out_qmin=float(out_grid["qmin"]),
                      in_unsigned=hwide)
        bp["project"] = {**mm_weights(p, hstep, tensor), "kw": kw, "residual": blk["use_residual"]}
        step = out_grid["step"]
        plan.append(bp)

    # Final shared grid (already the carry grid by construction).
    fs = graph["final_shared"]
    final_ratio = step / fs["step"] if abs(step - fs["step"]) > 1e-12 else None
    if final_ratio is not None:
        step = fs["step"]
    hcnv = graph["head_conv"]
    head_wide = hcnv["act_qmax"] > 127.0
    head_conv = {**mm_weights(hcnv, step, tensor), "kw": dict(
        relu=True,
        # An unsigned 8-bit head grid does not fit the int8 emit: f32 out,
        # then snapped to the grid as int16 for the f32 mean pool.
        out_inv_step=None if head_wide else float(1.0 / hcnv["act_step"]),
        out_qmax=float(hcnv["act_qmax"]), out_qmin=0.0)}
    head_step = float(hcnv["act_step"])
    tail = build_head_tail(graph["head"], head_step, tensor)
    image_levels = 2.0 ** graph["image_bits"] - 1.0

    def run_mm(x2d: torch.Tensor, layer: Dict[str, Any], residual=None) -> torch.Tensor:
        return mm(x2d, layer["w"], layer["mult"], layer["bias"], residual=residual,
                  packed=layer["packed"], **layer["kw"])

    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype == torch.uint8:
            x = true_div(images.float(), 255.0)
        else:
            x = true_div(torch.round(torch.clamp(images.float(), 0.0, 1.0) * image_levels),
                         image_levels)

        # Stem: bf16-rounded inputs, f32 products and sums (exact products,
        # TF32 off), then requant — a bf16-output conv would lose bits first.
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        with f32_convs():
            y = torch.nn.functional.conv2d(xb, stem_plan["w"], stride=2, padding=1)
        y = y.permute(0, 2, 3, 1)
        y = torch.clamp_min(y * stem_plan["mult"] + stem_plan["bias"], 0.0)
        q = torch.clamp(torch.round(true_div(y, stem_plan["step"])), 0, stem_plan["qmax"])
        y = (bits_int8(q) if stem_plan["wide"] else q.to(torch.int8)).contiguous()

        for bp in plan:
            if "requant_in" in bp:
                r = bp["requant_in"]
                y = requant_signed(y, r["ratio"], r["qmax"], unsigned=r["wide"])
            residual = y
            b, h, w, c = y.shape
            hcur = y
            if "expand" in bp:
                e = bp["expand"]
                hcur = run_mm(hcur.reshape(b * h * w, c), e).view(b, h, w, -1)
            d = bp["depthwise"]
            hcur = dw(hcur, d["w"], d["mult"], d["bias"], **d["kw"])
            hb, hh, hw, hc = hcur.shape
            p = bp["project"]
            res2d = residual.reshape(hb * hh * hw, -1) if p["residual"] else None
            y = run_mm(hcur.reshape(hb * hh * hw, hc), p, residual=res2d).view(hb, hh, hw, -1)

        if final_ratio is not None:
            y = requant_signed(y, final_ratio, fs["qmax"])

        b2, h2, w2, c2 = y.shape
        y = run_mm(y.reshape(b2 * h2 * w2, c2), head_conv).view(b2, h2, w2, -1)
        if head_wide:
            y = emit_unsigned(y, head_step, hcnv["act_qmax"])
        return tail(y)

    forward.launches_per_call = {  # what one forward launches on backend="cuda"
        "int8_matmul_requant": sum(("expand" in bp) + 1 for bp in plan) + 1,
        "int8_depthwise3x3": len(plan),
    }
    return forward
