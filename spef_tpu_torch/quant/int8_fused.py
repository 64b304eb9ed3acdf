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

Each node runs on its kernel or in its library-op form, as a backend plan
says: ``plan=``, else, with ``tuning=`` (the path of a table that
``quant/autotune.py`` measured on the card), :func:`plan_backends` of that
table; without either every node is ``"fused"`` and no table is read.  The
plan's values are the JAX package's, so a table gives the same
plan in both: ``"fused"`` is the kernel (K3, K4), and ``"xla"`` is the node as a
chain of PyTorch library ops (:func:`library_stem`, :func:`library_block`:
convolutions of bf16-valued operands with float32 sums, then the same grid
snaps and requants), the counterpart of the JAX executor's XLA
``_xla_stem`` / ``_xla_block``.  The TPU executor also sends the shapes
Mosaic cannot tile (widths off a multiple of 8, odd sizes at stride 2) to
XLA whatever the plan; K3 and K4 take every shape, so here only the plan
decides.  K4's tile is the named table's winner for the node's signature
where it has one measured on this device, else the cost model's.  The port reads no ``SPEF_PACK``: that flag selects the
TPU kernels' width-packed layout, which the port does not rebuild (ROADMAP
§B).  ``SPEF_ALL_FUSED=1`` plans every node ``"fused"``, as in JAX.

Under the boundary recipe this executor is not bit-equal to
``int8_cuda.build_cuda_forward``: K4 keeps an ungridded expand output in
float32 where the K1 -> K2 chain rounds it to bf16, and the stem sums
integer pixels with 1/255 folded into the multiplier where the chain
convolves pixels / 255 rounded to bf16.  Each follows its own JAX twin.

The whole graph is planned once (folded multipliers, kernel arguments,
device-resident weights, the packed weight layouts of K3, K4 and K1); the
backend plan and K4's tiles are resolved once an input size, at the first
call with it (the JAX executor resolves them when it traces); ``forward``
then only launches.  Under the boundary recipe the library form keeps the
JAX ``_xla_block``'s bf16 hidden tensor where K4 keeps float32, so a
hybrid plan there is not bit-equal to the all-fused forward (on grids
with integer sums it is).
"""

from __future__ import annotations

import hashlib
import os
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
    bits_int8,
    build_head_tail,
    consumer_grid,
    emit_unsigned,
    grid_params,
    mm_weights,
    requant_signed,
    scalars,
    true_div,
)
from spef_tpu_torch.quant.int8_model import _mm_f32_out, f32_convs

__all__ = ["build_fused_forward", "stem_operands", "mbconv_operands", "plan_nodes",
           "node_signatures", "plan_key", "plan_backends", "library_stem_operands",
           "library_stem", "library_block_operands", "library_block"]


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


# ---------------------------------------------------------------------------
# The backend plan (the JAX executor's, over the port's tuning table)
# ---------------------------------------------------------------------------


def node_signatures(graph: Dict[str, Any], img_hw) -> List[str]:
    """Autotuner signature of every node (stem first), in execution order:
    the JAX package's strings, sizes halved by floor division at each
    stride 2 as it walks them (a 15-row input gives 7, where the tensor
    itself has 8 rows)."""
    from spef_tpu_torch.quant.autotune import block_signature

    h, w = img_hw
    stem_cout = int(np.asarray(graph["stem"]["w_int"]).shape[-1])
    sigs = [block_signature("stem", h, w, 3, 12, stem_cout, 2)]
    cur_h, cur_w = h // 2, w // 2
    for blk in graph["blocks"]:
        d = blk["depthwise"]
        stride = int(d["stride"])
        cin = int(np.asarray(blk["expand"]["w_int"]).shape[-2] if "expand" in blk
                  else np.asarray(d["w_int"]).shape[-1])
        ch = int(np.asarray(d["w_int"]).shape[-1])
        co = int(np.asarray(blk["project"]["w_int"]).shape[-1])
        sigs.append(block_signature("mbconv", cur_h, cur_w, cin, ch, co, stride))
        cur_h, cur_w = cur_h // stride, cur_w // stride
    return sigs


def plan_key(graph: Dict[str, Any], img_hw) -> str:
    """Tuning-table key of a persisted graph-level plan."""
    sigs = node_signatures(graph, img_hw)
    return "plan:" + hashlib.md5("|".join(sigs).encode()).hexdigest()[:12]


def plan_backends(graph: Dict[str, Any], img_hw, transition_ms: float = 0.15,
                  path: Optional[str] = None, device: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Per-node backend (``"fused"`` or ``"xla"``) from the port's tuning
    table at ``path`` (``quant/autotune.py``; its default table without
    one).  With ``device`` (``autotune.device_name``) only the entries
    measured on that device count; without it every entry does, as in JAX.

    Resolution order, as in the JAX package:
      1. ``SPEF_ALL_FUSED=1`` plans every node ``"fused"``.
      2. A persisted graph-level plan (``plan:<hash>``, :func:`plan_key`)
         wins outright.
      3. Otherwise a 2-state DP over the node chain minimizes the sum of the
         nodes' times plus a cost at each boundary where the backend
         switches: a measured ``trans:<sig>-><sig>`` entry's
         ``transition_ms`` (negative values count as 0), else
         ``transition_ms``.  A node measured on one backend only, or on
         none, is pinned to ``"fused"``.
    """
    from spef_tpu_torch.quant.autotune import load_tuning

    blocks = graph["blocks"]
    if os.environ.get("SPEF_ALL_FUSED"):
        return {"stem": "fused", "blocks": ["fused"] * len(blocks)}
    table = load_tuning(path)
    if device is not None:
        table = {k: v for k, v in table.items() if v.get("device") == device}
    stored = table.get(plan_key(graph, img_hw))
    if stored and "blocks" in stored and len(stored["blocks"]) == len(blocks):
        return {"stem": stored["stem"], "blocks": list(stored["blocks"])}
    big = 1e9

    def times(sig: str) -> Tuple[float, float]:
        """(fused_ms, xla_ms) with ``big`` pinning unmeasured backends."""
        e = table.get(sig)
        if not e or e.get("ms") is None:
            return 0.0, big
        if e.get("xla_ms") is None:
            return float(e["ms"]), big
        return float(e["ms"]), float(e["xla_ms"])

    sigs = node_signatures(graph, img_hw)
    node_t = [times(sg) for sg in sigs]

    def boundary_cost(k: int) -> float:
        e = table.get(f"trans:{sigs[k - 1]}->{sigs[k]}")
        if e and e.get("transition_ms") is not None:
            return max(0.0, float(e["transition_ms"]))
        return transition_ms

    # cost[b]: the best total of nodes 0..k ending on backend b.
    cost = list(node_t[0])
    back: List[List[int]] = [[0, 0]]
    for k, (f_ms, x_ms) in enumerate(node_t[1:], start=1):
        pen = boundary_cost(k)
        new, ptr = [0.0, 0.0], [0, 0]
        for b, t in ((0, f_ms), (1, x_ms)):
            stay, switch = cost[b], cost[1 - b] + pen
            ptr[b] = b if stay <= switch else 1 - b
            new[b] = min(stay, switch) + t
        cost = new
        back.append(ptr)
    b = 0 if cost[0] <= cost[1] else 1
    choice = [b]
    for ptr in reversed(back[1:]):
        b = ptr[b]
        choice.append(b)
    choice.reverse()
    names = ["fused", "xla"]
    return {"stem": names[choice[0]], "blocks": [names[c] for c in choice[1:]]}


# ---------------------------------------------------------------------------
# The library-op form of a node (the plan's "xla")
# ---------------------------------------------------------------------------


def _library_layer(entry: Dict[str, Any], in_step: float, tensor: TensorFn) -> Dict[str, Any]:
    """A layer's integer weights (``(K, N)`` bf16 for a 1x1 layer, else OIHW
    float32; the caller sets a 3x3 layer's ``stride`` and ``groups``), its
    multiplier with ``in_step`` folded in (float32 times the step as
    float32, as JAX multiplies a float32 array by a Python float), bias and
    grid."""
    w = np.asarray(entry["w_int"])
    out = {"mult": tensor(np.asarray(entry["mult_core"], np.float32) * np.float32(in_step),
                          torch.float32),
           "bias": tensor(np.asarray(entry["bias"], np.float32), torch.float32)}
    if w.shape[0] == 1:
        out["w2d"] = tensor(w.reshape(w.shape[-2], w.shape[-1]), torch.bfloat16)
    else:
        out["w"] = tensor(np.transpose(w.astype(np.float32), (3, 2, 0, 1)), torch.float32)
    if "act_step" in entry:
        out.update(act_step=float(entry["act_step"]), act_qmax=float(entry["act_qmax"]))
    return out


def _conv_acc(x: torch.Tensor, layer: Dict[str, Any]) -> torch.Tensor:
    """NHWC convolution of bf16-valued operands (integers, or bf16 real
    values) with float32 products and sums, padded by (k - 1) // 2: JAX's
    ``_conv_acc``.  A 1x1 layer is a bf16 GEMM with a float32 output; a 3x3
    layer a float32 convolution (TF32 off: the caller's ``f32_convs``)."""
    if "w2d" in layer:
        return _mm_f32_out(x, layer["w2d"])
    w = layer["w"]
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w, stride=layer["stride"],
                                   padding=(w.shape[-1] - 1) // 2, groups=layer["groups"])
    return y.permute(0, 2, 3, 1)


def _grid_snap(yf: torch.Tensor, step: float, qmax: float) -> torch.Tensor:
    """Snap to an activation grid: int8, or int16 where the grid is wider
    than int8 (a qmax of 255); the values are exact bf16 operands."""
    q = torch.clamp(torch.round(true_div(yf, step)), 0.0, qmax)
    return q.to(torch.int16 if qmax > 127.0 else torch.int8)


def library_stem_operands(stem: Dict[str, Any], tensor: TensorFn = _numpy_tensor
                          ) -> Dict[str, Any]:
    """The stem's operands for :func:`library_stem`: its multiplier is
    ``mult_core / 255`` in float32, as JAX's ``_xla_stem`` divides."""
    layer = _library_layer(stem, 1.0, tensor)
    layer.update(stride=2, groups=1)
    layer["mult"] = tensor(np.asarray(stem["mult_core"], np.float32) / np.float32(255.0),
                           torch.float32)
    return layer


def library_stem(images: torch.Tensor, stem: Dict[str, Any]) -> torch.Tensor:
    """The stem in library ops (JAX's ``_xla_stem``): uint8 frames -> int8 on
    the stem grid, uint8 bits where the grid is unsigned 8-bit."""
    with f32_convs():
        acc = _conv_acc(images, stem)
    yf = torch.clamp_min(acc * stem["mult"] + stem["bias"], 0.0)
    q = torch.clamp(torch.round(true_div(yf, stem["act_step"])), 0.0, stem["act_qmax"])
    return bits_int8(q) if stem["act_qmax"] > 127.0 else q.to(torch.int8)


def library_block_operands(blk: Dict[str, Any], in_step: float,
                           out_grid: Optional[Dict[str, float]], in_unsigned: bool = False,
                           tensor: TensorFn = _numpy_tensor) -> Dict[str, Any]:
    """One block's operands for :func:`library_block`, with the steps of the
    tensors each layer reads folded into its multiplier as JAX's
    ``_xla_block`` folds them (the hidden step, or 1 after an ungridded
    expand; the depthwise step, or 1 without a depthwise grid)."""
    ops: Dict[str, Any] = {"in_unsigned": bool(in_unsigned),
                           "use_residual": bool(blk["use_residual"])}
    h_step = in_step
    if "expand" in blk:
        ops["expand"] = _library_layer(blk["expand"], in_step, tensor)
        h_step = blk["expand"]["act_step"] if "act_step" in blk["expand"] else 1.0
    d = blk["depthwise"]
    ops["depthwise"] = _library_layer(d, h_step, tensor)
    ops["depthwise"].update(stride=int(d["stride"]), groups=ops["depthwise"]["w"].shape[0])
    ops["project"] = _library_layer(blk["project"], d["act_step"] if "act_step" in d else 1.0,
                                    tensor)
    if blk["use_residual"]:
        ops["shared_step"], ops["shared_qmax"] = blk["shared_step"], blk["shared_qmax"]
        if out_grid is not None and abs(blk["shared_step"] - out_grid["step"]) > 1e-12:
            ops["ratio"] = float(np.float32(blk["shared_step"] / out_grid["step"]))
            ops["out_grid"] = out_grid
    else:
        if out_grid is None:
            raise NotImplementedError("float handoff between blocks is not in this family")
        ops["out_grid"] = out_grid
    return ops


def library_block(y: torch.Tensor, ops: Dict[str, Any]) -> torch.Tensor:
    """One inverted-residual block in library ops (JAX's ``_xla_block``):
    int8 (or uint8 bits, ``in_unsigned``) in, int8 on the consumer's grid
    out.  The hidden tensor is bf16 where the expand has no grid."""
    if ops["in_unsigned"]:
        y = y.to(torch.int16) & 255
    residual = y
    h = y
    with f32_convs():
        if "expand" in ops:
            e = ops["expand"]
            yf = torch.clamp_min(_conv_acc(h, e) * e["mult"] + e["bias"], 0.0)
            h = (_grid_snap(yf, e["act_step"], e["act_qmax"]) if "act_step" in e
                 else yf.to(torch.bfloat16))
        d = ops["depthwise"]
        yf = torch.clamp_min(_conv_acc(h, d) * d["mult"] + d["bias"], 0.0)
        h = (_grid_snap(yf, d["act_step"], d["act_qmax"]) if "act_step" in d
             else yf.to(torch.bfloat16))
        p = ops["project"]
        pf = _conv_acc(h, p) * p["mult"] + p["bias"]
    if ops["use_residual"]:
        qmax = ops["shared_qmax"]
        q = torch.clamp(torch.round(true_div(pf, ops["shared_step"])), -qmax - 1, qmax)
        s = q.to(torch.int32) + residual.to(torch.int32)
        if "ratio" not in ops:
            return torch.clamp(s, -128, 127).to(torch.int8)
        og = ops["out_grid"]
        return torch.clamp(torch.round(s.float() * ops["ratio"]), og["qmin"], og["qmax"]
                           ).to(torch.int8)
    og = ops["out_grid"]
    return torch.clamp(torch.round(true_div(pf, og["step"])), og["qmin"], og["qmax"]
                       ).to(torch.int8)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def plan_nodes(graph: Dict[str, Any], tensor: TensorFn, pack: bool):
    """Walk the graph once with the static step / bits bookkeeping.

    Returns ``((stem args, stem kwargs), nodes, step)``: K3's operands; a
    dict a block with K4's operands (``wts``, ``kw``; packed for the kernel
    with ``pack``), what its library form needs (``blk``, ``in_step``,
    ``out_grid``, ``unsigned``), and ``requant_in`` where its input moves to
    its own grid first; and the step of the last block's output."""
    stem_args, stem_kw = stem_operands(graph["stem"], tensor)
    step = graph["stem"]["act_step"]
    unsigned = float(graph["stem"]["act_qmax"]) > 127.0  # uint8 bits until a block decodes them
    nodes: List[Dict[str, Any]] = []
    for i, blk in enumerate(graph["blocks"]):
        bp: Dict[str, Any] = {"blk": blk}
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
        bp.update(in_step=step, out_grid=out_grid, unsigned=unsigned)
        bp["wts"], bp["kw"] = mbconv_operands(blk, step, out_grid, shared, unsigned, tensor)
        if pack:
            # The kernel's weight layouts, once a build and not once a call.
            bp["wts"] = pack_mbconv_weights(bp["wts"], dw_grid=bp["kw"]["inv_d"] is not None)
        # ratio_out None: the residual sum stayed on the block's shared grid.
        step = blk["shared_step"] if bp["kw"]["ratio_out"] is None else out_grid["step"]
        unsigned = False  # blocks emit on signed consumer grids
        nodes.append(bp)
    return (stem_args, stem_kw), nodes, step


def _launches(plan: Dict[str, Any]) -> Dict[str, int]:
    """What one forward of a plan launches on ``backend="cuda"``."""
    return {"fused_stem": int(plan["stem"] == "fused"),
            "fused_mbconv": sum(b == "fused" for b in plan["blocks"]),
            "int8_matmul_requant": 1}


def build_fused_forward(
    graph: Dict[str, Any],
    backend: str = "cuda",
    device: Union[str, torch.device] = "cuda",
    plan: Optional[Dict[str, Any]] = None,
    tuning: Optional[str] = None,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Plan the converted graph; returns ``images (B,H,W,3) uint8 -> (ori, pos)``.

    ``graph`` is the output of ``spef_tpu.quant.convert.convert_qat_params``
    (numpy arrays or Python scalars as leaves).  ``backend``: ``"cuda"``
    calls the kernel wrappers (the kernels for CUDA tensors); ``"plain"``
    calls the plain PyTorch versions of the same kernels.  ``plan``
    (``{"stem": "fused" | "xla", "blocks": [...]}``) routes each node to its
    kernel or its library-op form.  ``tuning`` is the path of a tuning
    table (``quant/autotune.py``; ``autotune.TUNING_PATH`` is the one
    ``apps.build_int8 --autotune`` writes on the card): without ``plan``,
    :func:`plan_backends` plans from it at the first call of each input
    size, and each fused block runs at its winning tile; only the entries
    measured on ``device`` count.  Without either, every node runs on its
    kernel at the cost model's tile.  The returned
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
    n_blocks = len(graph["blocks"])
    if plan is not None and (plan.get("stem") not in ("fused", "xla")
                             or len(plan.get("blocks", ())) != n_blocks
                             or any(b not in ("fused", "xla") for b in plan["blocks"])):
        raise ValueError(f"plan must name 'fused' or 'xla' for the stem and each of the "
                         f"{n_blocks} blocks, got {plan}")

    def tensor(a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- plan: walk the graph once with the static step / bits bookkeeping.
    (stem_args, stem_kw), nodes, step = plan_nodes(graph, tensor, pack=backend == "cuda")
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
    library: Dict[Any, Dict[str, Any]] = {}  # a node's library operands, made on first use
    routes: Dict[Tuple[int, int], Tuple[Dict[str, Any], List[Optional[Tuple[int, int]]]]] = {}
    all_fused = {"stem": "fused", "blocks": ["fused"] * n_blocks}

    def route(hh: int, ww: int):
        """(plan, K4 tile a block) for one input size, resolved once."""
        if (hh, ww) not in routes:
            from spef_tpu_torch.quant.autotune import device_name, lookup_tile

            p = plan or all_fused
            tiles: List[Optional[Tuple[int, int]]] = [None] * n_blocks
            if tuning is not None:
                name = device_name(dev)
                if plan is None:
                    p = plan_backends(graph, (hh, ww), path=tuning, device=name)
                if backend == "cuda":
                    for i, sig in enumerate(node_signatures(graph, (hh, ww))[1:]):
                        t = lookup_tile(sig, tuning, name)
                        tiles[i] = t if t != (0, 0) and p["blocks"][i] == "fused" else None
            if p["stem"] == "xla" and "stem" not in library:
                library["stem"] = library_stem_operands(graph["stem"], tensor)
            for i, b in enumerate(p["blocks"]):
                if b == "xla" and i not in library:
                    nd = nodes[i]
                    library[i] = library_block_operands(nd["blk"], nd["in_step"], nd["out_grid"],
                                                        nd["unsigned"], tensor)
            routes[(hh, ww)] = (p, tiles)
            forward.launches_per_call = _launches(p)
        return routes[(hh, ww)]

    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype != torch.uint8:
            raise ValueError(f"the fused pipeline takes uint8 frames, got {images.dtype}")
        p, tiles = route(images.shape[1], images.shape[2])
        if p["stem"] == "fused":
            y = stem_fn(images, *stem_args, **stem_kw)
        else:
            y = library_stem(images, library["stem"])
        for i, bp in enumerate(nodes):
            if "requant_in" in bp:
                y = requant_signed(y, **bp["requant_in"])
            if p["blocks"][i] == "xla":
                y = library_block(y, library[i])
            elif tiles[i] is not None:
                y = block_fn(y, bp["wts"], **bp["kw"], tile=tiles[i])
            else:
                y = block_fn(y, bp["wts"], **bp["kw"])
        if final_ratio is not None:
            y = requant_signed(y, final_ratio, fs["qmax"])
        b, h, w, c = y.shape
        yf = mm(y.reshape(b * h * w, c), head_conv["w"], head_conv["mult"], head_conv["bias"],
                relu=True, out_inv_step=None, packed=head_conv["packed"])
        return tail(emit_unsigned(yf, head_step, head_qmax).view(b, h, w, -1))

    forward.takes_uint8 = True
    # What one forward launches on backend="cuda": the given plan's count, or
    # every node fused until a call has resolved a named table's plan.
    forward.launches_per_call = _launches(plan or all_fused)
    return forward
