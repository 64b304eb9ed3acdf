"""QAT model -> int8 inference graph — counterpart of ``spef_tpu.quant.convert``.

Each ``QConvBnAct`` computes ``act_quant(relu(BN(conv(x, fake_quant(W)))))``.
With per-output-channel weight scales, folding BN (``g = gamma / sigma``,
``b = beta - mu * g``) into the conv is exact on the integer weights,
``quant_int(W * g)[.., c] == quant_int(W)[.., c] * sign(g_c)``, so

    conv(x_int, W_int) * (s_in * s_w_c * |g_c|) + b_c == BN(conv(x, W_q))

and the int8 executors reproduce the QAT network up to float rounding.

The graph is the JAX package's dict, with numpy leaves: ``w_int`` (int8),
``mult_core`` (float32, ``s_w * |g|``, multiplied by the input step at
execution), ``bias`` (float32), ``act_step`` / ``act_qmax`` (the output
grid, Python floats), the structure (stride, groups, residual wiring), the
shared grids and the int8 FC head.  The arithmetic is the JAX package's:
float64 numpy in the same order, so that both give the same dict on the
same parameters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from spef_tpu_torch.models.mobilenet_v2 import MOBILENET_V2_SETTINGS
from spef_tpu_torch.quant.bitwidth import default_bit_width

__all__ = ["convert_qat_params", "Int8Layer"]

_EPS = 2e-16

Int8Layer = Dict[str, Any]


def _int_weights(w: np.ndarray, bits: Optional[int], per_channel: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric quantization -> (int8 values, float scales); per output
    channel (last axis) or per tensor."""
    if bits is None:
        bits = 8  # unquantized layer: stored at int8 precision
    reduce_axes = tuple(range(w.ndim - 1)) if per_channel else tuple(range(w.ndim))
    if bits == 1:
        scale = np.maximum(np.mean(np.abs(w), axis=reduce_axes), _EPS)
        return np.where(w >= 0, 1, -1).astype(np.int8), scale
    if bits == 2:
        scale = np.maximum(np.mean(np.abs(w), axis=reduce_axes), _EPS)
        thr = 0.5 * scale
        return np.where(w > thr, 1, np.where(w < -thr, -1, 0)).astype(np.int8), scale
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = np.maximum(np.max(np.abs(w), axis=reduce_axes), _EPS) / qmax
    return np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8), scale


def _act_grid(params: dict, bits: int, signed: bool) -> Tuple[float, float]:
    """(step, qmax) of a ``FakeQuantAct`` from its learned log2 scale."""
    scale = float(2.0 ** np.asarray(params["log2_scale"]))
    qmax = (2.0 ** (bits - 1) - 1.0) if signed else (2.0 ** bits - 1.0)
    return scale / qmax, qmax


def _fold_conv_bn(conv_params, bn_params, bn_stats, weight_bits, eps=1e-5):
    """Fold BN into a quantized conv -> (w_int, mult_core, bias)."""
    w = np.asarray(conv_params["kernel"], np.float64)
    if bn_params is not None:
        gamma = np.asarray(bn_params["scale"], np.float64)
        beta = np.asarray(bn_params["bias"], np.float64)
        mean = np.asarray(bn_stats["mean"], np.float64)
        var = np.asarray(bn_stats["var"], np.float64)
        g = gamma / np.sqrt(var + eps)
        b = beta - mean * g
    else:
        g = np.ones(w.shape[-1])
        b = np.zeros(w.shape[-1])
        if "bias" in conv_params:
            b = np.asarray(conv_params["bias"], np.float64)
    w_int, s_w = _int_weights(w, weight_bits)
    # The sign of g flips the integer weights (exact; both signs supported).
    w_int = (w_int * np.sign(g)[None, None, None, :]).astype(np.int8)
    mult_core = s_w * np.abs(g)  # times s_in at execution
    return w_int, mult_core.astype(np.float32), b.astype(np.float32)


def _conv_entry(tree, name, weight_bits, act_bits, stride, groups, act_signed=False):
    p = tree["params"][name]
    bn_p = p.get("bn")
    bn_s = tree["batch_stats"].get(name, {}).get("bn") if bn_p is not None else None
    w_int, mult_core, bias = _fold_conv_bn(p["conv"], bn_p, bn_s, weight_bits)
    entry: Dict[str, Any] = {
        "w_int": w_int,
        "mult_core": mult_core,
        "bias": bias,
        "stride": stride,
        "groups": groups,
        "weight_bits": 8 if weight_bits is None else weight_bits,
    }
    if act_bits is not None and "act_quant" in p:
        step, qmax = _act_grid(p["act_quant"], act_bits, act_signed)
        entry["act_step"] = step
        entry["act_qmax"] = qmax
    return entry


def convert_qat_params(model, bit_width: Optional[dict] = None) -> Dict[str, Any]:
    """Convert a quantized model (``mobilenet_v2_q`` / ``small_mobile_q`` +
    ``ursonet_q``, as ``models.wrapper.import_model`` builds it) into the
    int8 layer graph.  The parameters are read in flax layout
    (``models.wrapper.flax_variables``)."""
    from spef_tpu_torch.models.wrapper import flax_variables

    settings = getattr(model.backbone, "settings", MOBILENET_V2_SETTINGS)
    n_blocks = sum(n for _, _, n, _ in settings)
    bw = bit_width or model.bit_width or default_bit_width(n_blocks)

    variables = flax_variables(model)
    backbone = {
        "params": variables["params"]["backbone"],
        "batch_stats": variables["batch_stats"].get("backbone", {}),
    }
    head = variables["params"]["head"]

    graph: Dict[str, Any] = {"settings": tuple(settings), "bit_width": bw}
    graph["image_bits"] = bw["image"]
    graph["stem"] = _conv_entry(
        backbone, "stem", bw["first_conv"][0], bw["first_conv"][1], stride=2, groups=1)

    blocks: List[Dict[str, Any]] = []
    in_ch = 32
    prev_used_residual = False
    block = 0
    for t, c, n, s in settings:
        for i in range(n):
            stride = s if i == 0 else 1
            use_residual = stride == 1 and in_ch == c
            input_quant = use_residual or prev_used_residual or (block == 1 and i == 0)
            bw_block = bw["inverted_residual"][block]
            bp = backbone["params"][f"block_{block}"]
            btree = {"params": bp,
                     "batch_stats": backbone["batch_stats"].get(f"block_{block}", {})}
            entry: Dict[str, Any] = {
                "use_residual": use_residual,
                "input_quant": input_quant,
                "expand_ratio": t,
            }
            if "shared_quant" in bp:
                step, qmax = _act_grid(bp["shared_quant"], bw["shared_act"], signed=True)
                entry["shared_step"] = step
                entry["shared_qmax"] = qmax
            hidden = int(round(in_ch * t))
            if t != 1:
                entry["expand"] = _conv_entry(btree, "expand", bw_block[0][0], bw_block[0][1],
                                              1, 1)
            entry["depthwise"] = _conv_entry(btree, "depthwise", bw_block[1][0],
                                             bw_block[1][1], stride, hidden)
            entry["project"] = _conv_entry(btree, "project", bw_block[2][0], None, 1, 1)
            blocks.append(entry)
            in_ch = c
            prev_used_residual = use_residual
            block += 1
    graph["blocks"] = blocks

    step, qmax = _act_grid(variables["params"]["backbone"]["final_shared_quant"],
                           bw["shared_act"], signed=True)
    graph["final_shared"] = {"step": step, "qmax": qmax}
    graph["head_conv"] = _conv_entry(
        backbone, "head_conv", bw["last_conv"][0], bw["last_conv"][1], 1, 1)

    fc_w_bits, fc_b_bits = bw.get("fully_connected", (8, 8))
    pool_step, pool_qmax = _act_grid(head["pool_quant"], bw.get("pooling", 8), signed=True)
    ori_w, ori_s = _int_weights(np.asarray(head["ori_fc_kernel"], np.float64), fc_w_bits)
    pos_w, pos_s = _int_weights(np.asarray(head["pos_fc_kernel"], np.float64), fc_w_bits)

    def _quant_bias(b):
        # The head biases are fake-quantized per tensor at fc_b_bits in QAT:
        # their exact grid values.
        ints, scale = _int_weights(np.asarray(b, np.float64), fc_b_bits, per_channel=False)
        return (ints.astype(np.float32) * scale).astype(np.float32)

    graph["head"] = {
        "pool_step": pool_step,
        "pool_qmax": pool_qmax,
        "ori_w_int": ori_w,
        "ori_scale": ori_s.astype(np.float32),
        "ori_bias": _quant_bias(head["ori_fc_bias"]),
        "pos_w_int": pos_w,
        "pos_scale": pos_s.astype(np.float32),
        "pos_bias": _quant_bias(head["pos_fc_bias"]),
    }
    return graph
