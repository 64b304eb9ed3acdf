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
device-resident weights); ``forward`` only launches.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.ops.int8_ops import (
    int8_depthwise3x3,
    int8_depthwise3x3_plain,
    int8_matmul_requant,
    int8_matmul_requant_plain,
)

__all__ = ["build_cuda_forward", "load_int8_graph"]


def _grid_params(step: float, qmax: float, signed: bool) -> Dict[str, float]:
    return {"step": step, "qmax": qmax, "qmin": -qmax - 1 if signed else 0.0}


def _true_div(y: torch.Tensor, d: float) -> torch.Tensor:
    """``y / d`` as an IEEE division.  On CUDA, PyTorch turns division by a
    Python scalar into a multiply by its reciprocal, which can differ by an
    ulp; a 0-d device tensor keeps the division."""
    return y / torch.tensor(d, dtype=torch.float32, device=y.device)


def _emit_unsigned(y: torch.Tensor, step: float, qmax: float) -> torch.Tensor:
    """Round/clip to an unsigned grid; int8 when it fits, else int16 (the
    head-conv emit: its only consumer is the f32 mean pool)."""
    dt = torch.int8 if qmax <= 127.0 else torch.int16
    return torch.clamp(torch.round(_true_div(y, step)), 0, qmax).to(dt)


def _bits_int8(q: torch.Tensor) -> torch.Tensor:
    """Unsigned q in [0, 255] (f32) -> its uint8 bits in an int8 container."""
    return torch.where(q > 127.0, q - 256.0, q).to(torch.int8)


def _decode_unsigned_f32(y: torch.Tensor) -> torch.Tensor:
    """int8 bits-carry -> true unsigned q as f32 (exact)."""
    yf = y.float()
    return yf + 256.0 * (yf < 0)


@contextlib.contextmanager
def _no_tf32_convs():
    """float32 convolutions in float32 (cuDNN defaults to TF32)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _scalars(v: Any) -> Any:
    """0-d array leaves -> Python scalars (``engine.py``'s ``.item()`` rule)."""
    if isinstance(v, dict):
        return {k: _scalars(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_scalars(x) for x in v)
    if getattr(v, "ndim", None) == 0:
        return v.item()
    return v


def load_int8_graph(path: str) -> Dict[str, Any]:
    """Load an ``int8_graph.pkl`` (numpy leaves, as ``apps/build_int8.py``
    writes it), 0-d leaves as Python scalars."""
    import pickle

    with open(path, "rb") as f:  # a graph file this project wrote
        return _scalars(pickle.load(f))


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
    graph = _scalars(graph)

    def tensor(a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def mm_weights(layer, in_step: float) -> Dict[str, torch.Tensor]:
        w = np.asarray(layer["w_int"])
        # Folded multiplier in float32, as JAX computes f32 array * Python float.
        mult = np.asarray(layer["mult_core"], f32) * f32(in_step)
        return {"w": tensor(w.reshape(w.shape[-2], w.shape[-1]), torch.int8),
                "mult": tensor(mult, torch.float32),
                "bias": tensor(np.asarray(layer["bias"], f32), torch.float32)}

    blocks = graph["blocks"]
    n_blocks = len(blocks)

    # The grid each block's OUTPUT is emitted on: the next consumer's shared
    # grid when it has one, else the block's own shared grid, else None.
    def consumer_grid(i: int) -> Optional[Dict[str, float]]:
        if i + 1 < n_blocks:
            nxt = blocks[i + 1]
            if "shared_step" in nxt and (nxt["input_quant"] or nxt["use_residual"]):
                return _grid_params(nxt["shared_step"], nxt["shared_qmax"], signed=True)
        else:
            fs = graph["final_shared"]
            return _grid_params(fs["step"], fs["qmax"], signed=True)
        blk = blocks[i]
        if "shared_step" in blk:
            return _grid_params(blk["shared_step"], blk["shared_qmax"], signed=True)
        return None

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
            bp["expand"] = {**mm_weights(e, hstep), "kw": dict(
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
        out_grid = consumer_grid(i)
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
        bp["project"] = {**mm_weights(p, hstep), "kw": kw, "residual": blk["use_residual"]}
        step = out_grid["step"]
        plan.append(bp)

    # Final shared grid (already the carry grid by construction).
    fs = graph["final_shared"]
    final_ratio = step / fs["step"] if abs(step - fs["step"]) > 1e-12 else None
    if final_ratio is not None:
        step = fs["step"]
    hcnv = graph["head_conv"]
    head_wide = hcnv["act_qmax"] > 127.0
    head_conv = {**mm_weights(hcnv, step), "kw": dict(
        relu=True,
        # An unsigned 8-bit head grid does not fit the int8 emit: f32 out,
        # then snapped to the grid as int16 for the f32 mean pool.
        out_inv_step=None if head_wide else float(1.0 / hcnv["act_step"]),
        out_qmax=float(hcnv["act_qmax"]), out_qmin=0.0)}
    head_step = float(hcnv["act_step"])
    head = graph["head"]
    pool_step, pool_qmax = float(head["pool_step"]), float(head["pool_qmax"])

    def fc_weights(w_int, scale, bias):
        return (tensor(np.asarray(w_int), torch.float64),
                tensor(np.asarray(scale, f32) * f32(pool_step), torch.float32),
                tensor(np.asarray(bias, f32), torch.float32))

    fc_ori = fc_weights(head["ori_w_int"], head["ori_scale"], head["ori_bias"])
    fc_pos = fc_weights(head["pos_w_int"], head["pos_scale"], head["pos_bias"])
    image_levels = 2.0 ** graph["image_bits"] - 1.0

    def run_mm(x2d: torch.Tensor, layer: Dict[str, Any], residual=None) -> torch.Tensor:
        return mm(x2d, layer["w"], layer["mult"], layer["bias"], residual=residual,
                  **layer["kw"])

    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype == torch.uint8:
            x = _true_div(images.float(), 255.0)
        else:
            x = _true_div(torch.round(torch.clamp(images.float(), 0.0, 1.0) * image_levels),
                          image_levels)

        # Stem: bf16-rounded inputs, f32 products and sums (exact products,
        # TF32 off), then requant — a bf16-output conv would lose bits first.
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        with _no_tf32_convs():
            y = torch.nn.functional.conv2d(xb, stem_plan["w"], stride=2, padding=1)
        y = y.permute(0, 2, 3, 1)
        y = torch.clamp_min(y * stem_plan["mult"] + stem_plan["bias"], 0.0)
        q = torch.clamp(torch.round(_true_div(y, stem_plan["step"])), 0, stem_plan["qmax"])
        y = (_bits_int8(q) if stem_plan["wide"] else q.to(torch.int8)).contiguous()

        for bp in plan:
            if "requant_in" in bp:
                r = bp["requant_in"]
                yf = _decode_unsigned_f32(y) if r["wide"] else y.float()
                y = torch.clamp(torch.round(yf * r["ratio"]), -r["qmax"] - 1,
                                r["qmax"]).to(torch.int8)
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
            y = torch.clamp(torch.round(y.float() * final_ratio), -fs["qmax"] - 1,
                            fs["qmax"]).to(torch.int8)

        b2, h2, w2, c2 = y.shape
        y = run_mm(y.reshape(b2 * h2 * w2, c2), head_conv).view(b2, h2, w2, -1)
        if head_wide:
            y = _emit_unsigned(y, head_step, hcnv["act_qmax"])

        # Head: int sum -> f32 mean (a multiply by 1/n, as jnp.mean) -> pool
        # grid -> int8 FC, summed exactly in float64 (K = 1280 products of
        # int8 pass 2^24, where float32 sums stop being exact).
        pooled = y.float().sum(dim=(1, 2)) * float(np.float32(1.0 / (h2 * w2)))
        pooled = pooled * head_step
        p_int = torch.clamp(torch.round(_true_div(pooled, pool_step)), -pool_qmax - 1,
                            pool_qmax)

        def fc(weights):
            w_int, scale, bias = weights
            acc = (p_int.double() @ w_int).float()
            return acc * scale + bias

        return fc(fc_ori), fc(fc_pos)

    forward.launches_per_call = {  # what one forward launches on backend="cuda"
        "int8_matmul_requant": sum(("expand" in bp) + 1 for bp in plan) + 1,
        "int8_depthwise3x3": len(plan),
    }
    return forward
