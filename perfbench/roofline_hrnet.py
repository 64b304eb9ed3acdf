"""The yardstick's arithmetic for HRNet-W32: every convolution of the
network with its geometry, the multiply-accumulates of a frame, and the
least time of a forward at a batch.

Computed from the configuration file's sizes (``img_size``, ``channels``,
``stem_channels``, ``stage1_blocks``, ``bottleneck_width``,
``bottleneck_expansion``, ``branch_channels``, ``stage_modules``,
``branch_blocks``, ``n_heatmaps``) and a batch, never from the program's
kernels.  Peaks and the least-time rule are ``roofline.py``'s (NVIDIA H100
SXM, 700 W): a convolution's least time is the larger of its bytes over
3.35 TB/s (its bf16 input, the residual it adds and its bf16 output each
once, its bf16 weights once) and 2 x MACs over the bf16 peak, 989 TFLOP/s;
each exchange's upsample, sum and ReLU adds its bytes (each term read once
at its own resolution, the sum written once), and the heatmaps' softmax its
float32 heatmaps read once.
"""

from __future__ import annotations

from typing import Dict, List

from perfbench.roofline import PEAK_BYTES_S, _bound_s

BF16 = 2


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def _conv(name: str, cin: int, cout: int, k: int, stride: int, h: int, w: int,
          residual: bool = False) -> Dict:
    return {"name": name, "cin": cin, "cout": cout, "k": k, "stride": stride, "h": h, "w": w,
            "ho": _out(h, stride), "wo": _out(w, stride), "residual": residual}


def _modules(cfg: Dict):
    """(stage, module, branches, multi_scale_output) of stages 2-4."""
    mods = cfg["stage_modules"]
    for s, n in enumerate(mods, start=2):
        for m in range(n):
            yield s, m, s, not (s == 1 + len(mods) and m == n - 1)


def convs(cfg: Dict) -> List[Dict]:
    """Every convolution in the forward's order, named as the port's
    modules are (``backbone.layer1.0.conv3``, ``backbone.stage4.2.fuse.0.3``,
    ``head.final_layer``): widths, kernel, stride, input and output size
    of a frame, and whether a residual is added in it."""
    h, w = cfg["img_size"]
    c, width = cfg["stem_channels"], cfg["bottleneck_width"]
    widths = cfg["branch_channels"]
    out = [_conv("backbone.conv1", cfg["channels"], c, 3, 2, h, w)]
    h, w = _out(h, 2), _out(w, 2)
    out.append(_conv("backbone.conv2", c, c, 3, 2, h, w))
    h, w = _out(h, 2), _out(w, 2)
    wide = width * cfg["bottleneck_expansion"]
    for b in range(cfg["stage1_blocks"]):
        cin, p = (c if b == 0 else wide), f"backbone.layer1.{b}"
        if cin != wide:
            out.append(_conv(f"{p}.downsample", cin, wide, 1, 1, h, w))
        out += [_conv(f"{p}.conv1", cin, width, 1, 1, h, w),
                _conv(f"{p}.conv2", width, width, 3, 1, h, w),
                _conv(f"{p}.conv3", width, wide, 1, 1, h, w, residual=True)]
    sizes = [(h, w)]
    out.append(_conv("backbone.transition1.0", wide, widths[0], 3, 1, h, w))
    out.append(_conv("backbone.transition1.1", wide, widths[1], 3, 2, h, w))
    sizes.append((_out(h, 2), _out(w, 2)))
    for s, m, n, multi in _modules(cfg):
        if m == 0 and s > 2:
            hh, ww = sizes[-1]
            out.append(_conv(f"backbone.transition{s - 1}", widths[s - 2], widths[s - 1], 3, 2,
                             hh, ww))
            sizes.append((_out(hh, 2), _out(ww, 2)))
        p = f"backbone.stage{s}.{m}"
        for i in range(n):
            for b in range(cfg["branch_blocks"]):
                for k in (1, 2):
                    out.append(_conv(f"{p}.branches.{i}.{b}.conv{k}", widths[i], widths[i], 3, 1,
                                     *sizes[i], residual=k == 2))
        for i in range(n if multi else 1):
            for j in range(n):
                if j > i:
                    out.append(_conv(f"{p}.fuse.{i}.{j}", widths[j], widths[i], 1, 1, *sizes[j]))
                for k in range(i - j):
                    cout = widths[i] if k == i - j - 1 else widths[j]
                    out.append(_conv(f"{p}.fuse.{i}.{j}.{k}", widths[j], cout, 3, 2,
                                     *sizes[j + k]))
    out.append(_conv("head.final_layer", widths[0], cfg["n_heatmaps"], 1, 1, *sizes[0]))
    return out


def exchanges(cfg: Dict) -> List[Dict]:
    """Every exchange output: its width and size, and the (width, height,
    width) of each term summed into it, at the term's own resolution."""
    h, w = cfg["img_size"]
    sizes = [(_out(_out(h, 2), 2), _out(_out(w, 2), 2))]
    for _ in cfg["branch_channels"][1:]:
        sizes.append((_out(sizes[-1][0], 2), _out(sizes[-1][1], 2)))
    widths = cfg["branch_channels"]
    out = []
    for _, _, n, multi in _modules(cfg):
        for i in range(n if multi else 1):
            terms = [(widths[i], *sizes[j if j > i else i]) for j in range(n)]
            out.append({"c": widths[i], "h": sizes[i][0], "w": sizes[i][1], "terms": terms})
    return out


def conv_macs(node: Dict) -> int:
    """Multiply-accumulates of one frame through a convolution."""
    return node["k"] * node["k"] * node["cin"] * node["cout"] * node["ho"] * node["wo"]


def model_macs(cfg: Dict) -> int:
    """Multiply-accumulates of one frame through the whole network."""
    return sum(conv_macs(n) for n in convs(cfg))


def conv_bound_s(node: Dict, batch: int) -> float:
    """One convolution's least time at ``batch`` (the module's rule)."""
    out = batch * node["ho"] * node["wo"] * node["cout"]
    nbytes = BF16 * (batch * node["h"] * node["w"] * node["cin"] + out * (1 + node["residual"])
                     + node["k"] * node["k"] * node["cin"] * node["cout"])
    return _bound_s(nbytes, {"bf16": 2 * batch * conv_macs(node)})


def forward_bound_s(cfg: Dict, batch: int) -> float:
    """The forward's least time at ``batch``: every convolution's, every
    exchange's bytes, and the softmax's."""
    total = sum(conv_bound_s(n, batch) for n in convs(cfg))
    for ex in exchanges(cfg):
        read = sum(c * h * w for c, h, w in ex["terms"])
        total += BF16 * batch * (read + ex["c"] * ex["h"] * ex["w"]) / PEAK_BYTES_S
    head = convs(cfg)[-1]
    total += 4 * batch * head["cout"] * head["ho"] * head["wo"] / PEAK_BYTES_S
    return total

