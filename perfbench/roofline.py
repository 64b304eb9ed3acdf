"""The yardstick's arithmetic: peaks of the card, the model's layer shapes,
its multiply-accumulates, and the least time a node's work could take.

Everything here is computed from a configuration file's sizes (the
inverted-residual table, the image size, the head widths) and a batch, never
from the arguments of a kernel, so a program change that replaces a kernel
leaves the bound where it was.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
A node's least time is the larger of its bytes over the memory rate and its
operations, each kind at its own peak rate; each input and output byte is
counted once and each weight byte once.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def layers(cfg: Dict) -> List[Dict]:
    """One entry a node of MobileNetV2 + URSONet at the config's image size:
    ``stem``, one ``block`` a row of the inverted-residual table (with its
    ``expand`` width, 0 where it has none), ``head_conv`` and ``fc``."""
    h, w = cfg["img_size"]
    c = cfg["stem_channels"]
    out = [{"kind": "stem", "cin": cfg["channels"], "cout": c, "stride": 2, "h": h, "w": w,
            "ho": _out(h, 2), "wo": _out(w, 2)}]
    h, w = _out(h, 2), _out(w, 2)
    for t, cout, n, s in cfg["settings"]:
        for i in range(n):
            stride = s if i == 0 else 1
            ho, wo = _out(h, stride), _out(w, stride)
            out.append({"kind": "block", "cin": c, "hidden": c * t, "expand": t != 1,
                        "cout": cout, "stride": stride, "h": h, "w": w, "ho": ho, "wo": wo})
            c, h, w = cout, ho, wo
    out.append({"kind": "head_conv", "cin": c, "cout": cfg["head_conv_channels"], "stride": 1,
                "h": h, "w": w, "ho": h, "wo": w})
    out.append({"kind": "fc", "cin": cfg["head_conv_channels"],
                "cout": cfg["n_ori_bins"] + cfg["n_pos_bins"]})
    return out


def node_macs(node: Dict) -> int:
    """Multiply-accumulates of one frame through ``node``."""
    k = node["kind"]
    if k == "stem":
        return 9 * node["cin"] * node["cout"] * node["ho"] * node["wo"]
    if k == "block":
        ch = node["hidden"]
        expand = node["cin"] * ch * node["h"] * node["w"] if node["expand"] else 0
        return expand + 9 * ch * node["ho"] * node["wo"] + ch * node["cout"] * node["ho"] * node["wo"]
    if k == "head_conv":
        return node["cin"] * node["cout"] * node["ho"] * node["wo"]
    return node["cin"] * node["cout"]


def model_macs(cfg: Dict) -> int:
    """Multiply-accumulates of one frame through the whole model."""
    return sum(node_macs(n) for n in layers(cfg))


def _bound_s(nbytes: float, ops_by_rate: Dict[str, float]) -> float:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = sum(ops / PEAK_OPS_S[rate] for rate, ops in ops_by_rate.items())
    return max(t_bytes, t_ops)


def mbconv_bound_s(node: Dict, batch: int, dw_on_grid: bool = False) -> float:
    """One inverted-residual block of the int8 graph at ``batch``: the input
    and output once as int8, the int8 weights and a float32 multiplier and
    bias a channel; the expand at the int8 rate, the nine depthwise taps at
    the float32 rate, the projection at the int8 rate when the depthwise
    output is on a grid and at the bf16 rate when it is real-valued (the
    boundary recipe's)."""
    cin, ch, cout = node["cin"], node["hidden"], node["cout"]
    npix_in = batch * node["h"] * node["w"]
    npix_out = batch * node["ho"] * node["wo"]
    weights = 9 * ch + ch * cout + 8 * ch + 8 * cout
    ops = {"f32": 2 * 9 * npix_out * ch}
    proj = "int8" if dw_on_grid else "bf16"
    ops[proj] = 2 * npix_out * ch * cout
    if node["expand"]:
        weights += cin * ch + 8 * ch
        ops["int8"] = ops.get("int8", 0) + 2 * npix_in * cin * ch
    return _bound_s(npix_in * cin + npix_out * cout + weights, ops)


def stem_bound_s(node: Dict, batch: int) -> float:
    """The stem on uint8 pixels: 27 taps at the int8 rate."""
    npix = batch * node["ho"] * node["wo"]
    nbytes = batch * node["h"] * node["w"] * node["cin"] + npix * node["cout"] \
        + 9 * node["cin"] * node["cout"] + 8 * node["cout"]
    return _bound_s(nbytes, {"int8": 2 * 9 * node["cin"] * npix * node["cout"]})


def matmul_bound_s(m: int, k: int, n: int, out_bytes: int) -> float:
    """An int8 (m, k) x (k, n) product with per-column multiplier and bias."""
    return _bound_s(m * k + k * n + m * n * out_bytes + 8 * n, {"int8": 2 * m * n * k})


def int8_forward_bound_s(cfg: Dict, batch: int) -> float:
    """The whole int8 forward at ``batch``: stem, the blocks, the head conv
    (its output once at one byte) and the FC heads (float32 logits), each
    node's least time summed."""
    total = 0.0
    for node in layers(cfg):
        k = node["kind"]
        if k == "stem":
            total += stem_bound_s(node, batch)
        elif k == "block":
            total += mbconv_bound_s(node, batch)
        elif k == "head_conv":
            total += matmul_bound_s(batch * node["ho"] * node["wo"], node["cin"], node["cout"], 1)
        else:
            total += matmul_bound_s(batch, node["cin"], node["cout"], 4)
    return total


def blocks_bound_s(cfg: Dict, batch: int) -> float:
    """The inverted-residual blocks alone at ``batch``, summed."""
    return sum(mbconv_bound_s(n, batch) for n in layers(cfg) if n["kind"] == "block")
