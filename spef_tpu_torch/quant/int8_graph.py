"""What every int8 executor of the port needs from a converted graph.

The graph is the dict ``spef_tpu.quant.convert.convert_qat_params`` gives
(numpy leaves): the loader, the grid bookkeeping (``consumer_grid``), the
folded 1x1-convolution operands of K1, the small requant helpers and the
pooled int8 FC head.  ``quant/int8_cuda.py`` (one kernel a layer) and
``quant/int8_fused.py`` (one kernel a block) both build on it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.ops.int8_ops import pack_mm_weights

__all__ = ["load_int8_graph", "scalars", "grid_params", "consumer_grid", "mm_weights",
           "true_div", "emit_unsigned", "bits_int8", "decode_unsigned_f32",
           "requant_signed", "build_head_tail"]

TensorFn = Callable[[Any, torch.dtype], torch.Tensor]


def scalars(v: Any) -> Any:
    """0-d array leaves -> Python scalars (``engine.py``'s ``.item()`` rule)."""
    if isinstance(v, dict):
        return {k: scalars(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(scalars(x) for x in v)
    if getattr(v, "ndim", None) == 0:
        return v.item()
    return v


def load_int8_graph(path: str) -> Dict[str, Any]:
    """Load an ``int8_graph.pkl`` (numpy leaves, as ``apps/build_int8.py``
    writes it), 0-d leaves as Python scalars."""
    import pickle

    with open(path, "rb") as f:  # a graph file this project wrote
        return scalars(pickle.load(f))


def grid_params(step: float, qmax: float, signed: bool = True) -> Dict[str, float]:
    return {"step": step, "qmax": qmax, "qmin": -qmax - 1 if signed else 0.0}


def consumer_grid(graph: Dict[str, Any], i: int) -> Optional[Dict[str, float]]:
    """The grid block ``i``'s OUTPUT is emitted on: the next consumer's
    shared grid when it has one (the final shared grid after the last
    block), else the block's own shared grid, else None."""
    blocks = graph["blocks"]
    if i + 1 < len(blocks):
        nxt = blocks[i + 1]
        if "shared_step" in nxt and (nxt["input_quant"] or nxt["use_residual"]):
            return grid_params(nxt["shared_step"], nxt["shared_qmax"])
    else:
        fs = graph["final_shared"]
        return grid_params(fs["step"], fs["qmax"])
    blk = blocks[i]
    if "shared_step" in blk:
        return grid_params(blk["shared_step"], blk["shared_qmax"])
    return None


def mm_weights(layer: Dict[str, Any], in_step: float, tensor: TensorFn) -> Dict[str, Any]:
    """K1 operands of a 1x1 convolution: ``w (K, N)`` int8, the multiplier
    with the input step folded in (in float32, as JAX computes a float32
    array times a Python float), the bias, and ``packed``, the kernel's
    copy of ``w`` (``pack_mm_weights``, once a forward-build)."""
    w = np.asarray(layer["w_int"])
    mult = np.asarray(layer["mult_core"], np.float32) * np.float32(in_step)
    w_t = tensor(w.reshape(w.shape[-2], w.shape[-1]), torch.int8)
    return {"w": w_t, "mult": tensor(mult, torch.float32),
            "bias": tensor(np.asarray(layer["bias"], np.float32), torch.float32),
            "packed": pack_mm_weights(w_t)}


def true_div(y: torch.Tensor, d: float) -> torch.Tensor:
    """``y / d`` as an IEEE division.  On CUDA, PyTorch turns division by a
    Python scalar into a multiply by its reciprocal, which can differ by an
    ulp; a 0-d device tensor keeps the division.  ``torch.full`` fills it
    on the device (the same float32 value): ``torch.tensor`` would copy it
    from the host and synchronize, which keeps a stream of forwards from
    being dispatched ahead (``serving.serve_stream``)."""
    return y / torch.full((), d, dtype=torch.float32, device=y.device)


def emit_unsigned(y: torch.Tensor, step: float, qmax: float) -> torch.Tensor:
    """Round/clip to an unsigned grid; int8 when it fits, else int16 (the
    head-conv emit: its only consumer is the f32 mean pool)."""
    dt = torch.int8 if qmax <= 127.0 else torch.int16
    return torch.clamp(torch.round(true_div(y, step)), 0, qmax).to(dt)


def bits_int8(q: torch.Tensor) -> torch.Tensor:
    """Unsigned q in [0, 255] (f32) -> its uint8 bits in an int8 container."""
    return torch.where(q > 127.0, q - 256.0, q).to(torch.int8)


def decode_unsigned_f32(y: torch.Tensor) -> torch.Tensor:
    """int8 bits-carry -> true unsigned q as f32 (exact)."""
    yf = y.float()
    return yf + 256.0 * (yf < 0)


def requant_signed(y: torch.Tensor, ratio: float, qmax: float,
                   unsigned: bool = False) -> torch.Tensor:
    """Move int8 values (or uint8 bits, ``unsigned``) to a signed grid whose
    step is ``1 / ratio`` of theirs: ``clip(round(y * ratio))`` as int8."""
    yf = decode_unsigned_f32(y) if unsigned else y.float()
    return torch.clamp(torch.round(yf * ratio), -qmax - 1, qmax).to(torch.int8)


def build_head_tail(head: Dict[str, Any], head_step: float, tensor: TensorFn,
                    zp: float = 0.0
                    ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The head after the head conv: ``y (B, h, w, C)`` integers on the
    ``head_step`` grid, stored shifted by ``zp`` (the int8 carry's unsigned
    grids) -> ``(ori, pos)`` logits.

    Int sum -> f32 mean (a multiply by 1/n, as ``jnp.mean``) -> ``(mean +
    zp) * step`` -> pool grid (a true division) -> int8 FC, summed exactly in
    float64 (K = 1280 products of int8 pass 2^24, where float32 sums stop
    being exact).
    """
    pool_step, pool_qmax = float(head["pool_step"]), float(head["pool_qmax"])

    def fc_weights(name: str):
        scale = np.asarray(head[f"{name}_scale"], np.float32) * np.float32(pool_step)
        return (tensor(np.asarray(head[f"{name}_w_int"]), torch.float64),
                tensor(scale, torch.float32),
                tensor(np.asarray(head[f"{name}_bias"], np.float32), torch.float32))

    fcs = (fc_weights("ori"), fc_weights("pos"))

    def tail(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h, w, _ = y.shape
        pooled = y.float().sum(dim=(1, 2)) * float(np.float32(1.0 / (h * w)))
        pooled = (pooled + zp) * head_step
        p_int = torch.clamp(torch.round(true_div(pooled, pool_step)), -pool_qmax - 1,
                            pool_qmax).double()
        ori, pos = ((p_int @ w_int).float() * scale + bias for w_int, scale, bias in fcs)
        return ori, pos

    return tail
