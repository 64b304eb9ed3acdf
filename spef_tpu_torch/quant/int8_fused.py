"""Fused int8 pipeline on the hand-written CUDA kernels K3, K4 and K1.

Counterpart of ``spef_tpu.quant.int8_fused.build_fused_forward``, the JAX
package's deployment executor: the stem is one K3 launch
(``fused_stem``) and every inverted-residual block one K4 launch
(``fused_mbconv``), so an activation crosses device memory once a block, as
int8; the head 1x1 convolution is one K1 launch (``int8_matmul_requant``,
f32 output).  The grid bookkeeping is the JAX executor's: a tensor is always
emitted on its consumer's grid, integer residual sums are ratio-requantized
exactly, and an unsigned 8-bit stem grid travels as uint8 bits until the
first block decodes it.

Every node runs on the kernels.  The TPU executor sends the shapes Mosaic
cannot tile (widths off a multiple of 8, odd sizes at stride 2) to XLA, and
picks per-node backends from a tuning table; K3 and K4 take every shape, and
the tuning table (``plan=``, ``plan_backends``) waits for the port's
autotuner (ROADMAP §A).

Under the boundary recipe this executor is not bit-equal to
``int8_cuda.build_cuda_forward``: K4 keeps an ungridded expand output in
float32 where the K1 -> K2 chain rounds it to bf16, and the stem sums
integer pixels with 1/255 folded into the multiplier where the chain
convolves pixels / 255 rounded to bf16.  Each follows its own JAX twin.

The whole graph is planned once (folded multipliers, kernel arguments,
device-resident weights, the packed weight layouts of K3, K4 and K1);
``forward`` only launches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.ops.fused_block import (
    fused_mbconv,
    fused_mbconv_plain,
    fused_stem,
    fused_stem_plain,
    pack_mbconv_weights,
    pack_stem_weights,
)
from spef_tpu_torch.ops.int8_ops import int8_matmul_requant, int8_matmul_requant_plain
from spef_tpu_torch.quant.int8_graph import (
    TensorFn,
    build_head_tail,
    consumer_grid,
    emit_unsigned,
    grid_params,
    mm_weights,
    requant_signed,
    scalars,
)

__all__ = ["build_fused_forward", "stem_operands", "mbconv_operands"]


def _numpy_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype)


def stem_operands(stem: Dict[str, Any], tensor: TensorFn = _numpy_tensor
                  ) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, float]]:
    """``(w, mult, bias), kwargs`` of :func:`fused_stem` for a graph's stem.

    The kernel convolves the integer pixels, so 1/255 goes into the
    multiplier (in float32, as the JAX wrapper divides a float32 array).
    ``packed`` is the kernel's copy of the weights (``pack_stem_weights``)."""
    f32 = np.float32
    w = np.asarray(stem["w_int"])
    mult = np.asarray(stem["mult_core"], f32) / f32(255.0)
    w_t = tensor(w.reshape(3, 3, 3, w.shape[-1]), torch.int8)
    args = (w_t, tensor(mult, torch.float32), tensor(np.asarray(stem["bias"], f32), torch.float32))
    return args, {"inv_step": float(1.0 / stem["act_step"]), "qmax": float(stem["act_qmax"]),
                  "packed": pack_stem_weights(w_t)}


def mbconv_operands(
    blk: Dict[str, Any],
    in_step: float,
    out_grid: Optional[Dict[str, float]],
    shared_grid: Optional[Dict[str, float]] = None,
    in_unsigned: bool = False,
    tensor: TensorFn = _numpy_tensor,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``wts, kwargs`` of :func:`fused_mbconv` for one block of the graph.

    Each multiplier takes the step of the tensor its layer reads: the
    expand ``in_step``; the depthwise the hidden step (``in_step`` without
    an expand, 1 after an ungridded expand, whose output is real-valued);
    the projection the depthwise step (1 without a depthwise grid).  The
    products are float32 array times Python float, in float32, as in JAX.
    """
    f32 = np.float32
    e, d, p = blk.get("expand"), blk["depthwise"], blk["project"]
    ch = np.asarray(d["w_int"]).shape[-1]
    cout = np.asarray(p["w_int"]).shape[-1]
    hidden_grid = e is not None and "act_step" in e
    dw_grid = "act_step" in d

    def vec(a, scale: float = 1.0) -> torch.Tensor:
        return tensor(np.asarray(a, f32) * f32(scale), torch.float32)

    wts: Dict[str, torch.Tensor] = {}
    if e is not None:
        cin = np.asarray(e["w_int"]).shape[-2]
        wts.update(w1=tensor(np.asarray(e["w_int"]).reshape(cin, ch), torch.int8),
                   m1=vec(e["mult_core"], in_step), b1=vec(e["bias"]))
        h_step = e["act_step"] if hidden_grid else 1.0
    else:
        h_step = in_step
    wts.update(w2=tensor(np.asarray(d["w_int"]).reshape(3, 3, ch), torch.int8),
               m2=vec(d["mult_core"], h_step), b2=vec(d["bias"]),
               w3=tensor(np.asarray(p["w_int"]).reshape(ch, cout), torch.int8),
               m3=vec(p["mult_core"], d["act_step"] if dw_grid else 1.0), b3=vec(p["bias"]))

    kw: Dict[str, Any] = dict(
        stride=int(d["stride"]), in_unsigned=bool(in_unsigned),
        inv_h=float(1.0 / e["act_step"]) if hidden_grid else None,
        qmax_h=float(e["act_qmax"]) if hidden_grid else 127.0,
        inv_d=float(1.0 / d["act_step"]) if dw_grid else None,
        qmax_d=float(d["act_qmax"]) if dw_grid else 127.0,
        use_residual=bool(blk["use_residual"]))
    if blk["use_residual"]:
        if shared_grid is None:
            raise ValueError("a residual block needs its shared grid")
        kw.update(inv_sh=float(1.0 / shared_grid["step"]), qmax_sh=float(shared_grid["qmax"]))
        if out_grid is not None and abs(shared_grid["step"] - out_grid["step"]) > 1e-12:
            kw.update(ratio_out=float(shared_grid["step"] / out_grid["step"]),
                      qmin_o=float(out_grid["qmin"]), qmax_o=float(out_grid["qmax"]))
        else:
            kw.update(ratio_out=None, qmin_o=-128.0, qmax_o=127.0)
    else:
        if out_grid is None:
            raise NotImplementedError("float handoff between blocks is not in this family")
        kw.update(ratio_out=float(1.0 / out_grid["step"]), qmin_o=float(out_grid["qmin"]),
                  qmax_o=float(out_grid["qmax"]))
    return wts, kw


def build_fused_forward(
    graph: Dict[str, Any],
    backend: str = "cuda",
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Plan the converted graph; returns ``images (B,H,W,3) uint8 -> (ori, pos)``.

    ``graph`` is the output of ``spef_tpu.quant.convert.convert_qat_params``
    (numpy arrays or Python scalars as leaves).  ``backend``: ``"cuda"``
    calls the kernel wrappers (the kernels for CUDA tensors); ``"plain"``
    calls the plain PyTorch versions of the same kernels.  The returned
    function takes the raw uint8 frames (``takes_uint8``): the stem folds
    the normalization.
    """
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend must be 'cuda' or 'plain', got {backend!r}")
    stem_fn = fused_stem if backend == "cuda" else fused_stem_plain
    block_fn = fused_mbconv if backend == "cuda" else fused_mbconv_plain
    mm = int8_matmul_requant if backend == "cuda" else int8_matmul_requant_plain
    dev = torch.device(device)
    graph = scalars(graph)

    def tensor(a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- plan: walk the graph once with the static step / bits bookkeeping.
    stem = graph["stem"]
    stem_args, stem_kw = stem_operands(stem, tensor)
    step = stem["act_step"]
    unsigned = float(stem["act_qmax"]) > 127.0  # uint8 bits until a block decodes them
    plan: List[Dict[str, Any]] = []
    for i, blk in enumerate(graph["blocks"]):
        bp: Dict[str, Any] = {}
        # Producers emit on the consumer's grid, so this requant only fires
        # for a first block with an input grid of its own.
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            tgt = blk["shared_step"]
            if abs(step - tgt) > 1e-12 or unsigned:
                bp["requant_in"] = dict(ratio=step / tgt, qmax=blk["shared_qmax"],
                                        unsigned=unsigned)
            step, unsigned = tgt, False
        out_grid = consumer_grid(graph, i)
        shared = (grid_params(blk["shared_step"], blk["shared_qmax"])
                  if "shared_step" in blk else None)
        bp["wts"], bp["kw"] = mbconv_operands(blk, step, out_grid, shared, unsigned, tensor)
        if backend == "cuda":
            # The kernel's weight layouts, once a build and not once a call.
            bp["wts"] = pack_mbconv_weights(bp["wts"], dw_grid=bp["kw"]["inv_d"] is not None)
        # ratio_out None: the residual sum stayed on the block's shared grid.
        step = blk["shared_step"] if bp["kw"]["ratio_out"] is None else out_grid["step"]
        unsigned = False  # blocks emit on signed consumer grids
        plan.append(bp)

    fs = graph["final_shared"]
    final_ratio = step / fs["step"] if abs(step - fs["step"]) > 1e-12 else None
    if final_ratio is not None:
        step = fs["step"]
    # Head conv: K1 with f32 output, then a true division onto its grid
    # (int16 when the grid is unsigned 8-bit: its only consumer is the pool).
    hcnv = graph["head_conv"]
    head_conv = mm_weights(hcnv, step, tensor)
    head_step, head_qmax = float(hcnv["act_step"]), float(hcnv["act_qmax"])
    tail = build_head_tail(graph["head"], head_step, tensor)

    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype != torch.uint8:
            raise ValueError(f"the fused pipeline takes uint8 frames, got {images.dtype}")
        y = stem_fn(images, *stem_args, **stem_kw)
        for bp in plan:
            if "requant_in" in bp:
                y = requant_signed(y, **bp["requant_in"])
            y = block_fn(y, bp["wts"], **bp["kw"])
        if final_ratio is not None:
            y = requant_signed(y, final_ratio, fs["qmax"])
        b, h, w, c = y.shape
        yf = mm(y.reshape(b * h * w, c), head_conv["w"], head_conv["mult"], head_conv["bias"],
                relu=True, out_inv_step=None, packed=head_conv["packed"])
        return tail(emit_unsigned(yf, head_step, head_qmax).view(b, h, w, -1))

    forward.takes_uint8 = True
    forward.launches_per_call = {  # what one forward launches on backend="cuda"
        "fused_stem": 1, "fused_mbconv": len(plan), "int8_matmul_requant": 1}
    return forward
