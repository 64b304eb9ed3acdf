"""Post-training activation calibration — counterpart of ``spef_tpu.quant.calibrate``.

A float checkpoint, warm-started into the QAT model and converted
(``convert_qat_params``, whose integer weights need no data), gets its
activation grids from statistics of the float network over calibration
batches: every grid site's magnitudes go into a 2048-bin histogram with
range-doubling merges, and the site's range is its ``absmax``,
``percentile`` (99.99 by default), ``mse`` or ``entropy`` choice.
``write_scales_to_params`` maps the ranges back onto the QAT model's
``log2_scale`` leaves so that a QAT fine-tune starts from them.

The tap forward runs on the device (float32 convolutions, TF32 off), and
each batch leaves it as one maximum and one histogram a site, computed as
the JAX package does: a strided sub-sample of at most 256k values, sorted,
cut at ``linspace(0, 1.25 * amax, 2049)`` by ``searchsorted(side="left")``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.quant.int8_graph import scalars, true_div
from spef_tpu_torch.quant.int8_model import f32_convs

__all__ = [
    "HistogramCollector",
    "collect_activation_stats",
    "calibrate_graph",
    "write_scales_to_params",
]

_SUBSAMPLE = 262144  # values a site a batch the histogram sees at most


class HistogramCollector:
    """Magnitude histogram with dynamic range growth (power-of-two merges)."""

    def __init__(self, n_bins: int = 2048):
        self.n_bins = n_bins
        self.counts: Optional[np.ndarray] = None
        self.range: float = 0.0
        self.amax_observed: float = 0.0

    def update(self, x: np.ndarray) -> None:
        mags = np.abs(np.asarray(x, np.float32)).ravel()
        amax = float(mags.max()) if mags.size else 0.0
        self.amax_observed = max(self.amax_observed, amax)
        if self.counts is None:
            self.range = max(amax, 1e-12) * 1.25
            self.counts = np.zeros(self.n_bins, np.int64)
        while amax > self.range:
            # Double the range; merge neighbouring bins to keep n_bins.
            merged = self.counts.reshape(-1, 2).sum(axis=1)
            self.counts = np.concatenate([merged, np.zeros(self.n_bins // 2, np.int64)])
            self.range *= 2.0
        hist, _ = np.histogram(mags, bins=self.n_bins, range=(0.0, self.range))
        self.counts += hist

    def update_hist(self, counts: np.ndarray, range_: float, amax: float) -> None:
        """Merge a pre-binned magnitude histogram (collected on the device);
        its values are taken at their bin centers."""
        counts = np.asarray(counts, np.int64)
        amax = float(amax)
        self.amax_observed = max(self.amax_observed, amax)
        if self.counts is None:
            self.range = max(float(range_), 1e-12)
            self.counts = np.zeros(self.n_bins, np.int64)
        while amax > self.range:
            merged = self.counts.reshape(-1, 2).sum(axis=1)
            self.counts = np.concatenate([merged, np.zeros(self.n_bins // 2, np.int64)])
            self.range *= 2.0
        centers = (np.arange(counts.size) + 0.5) * (float(range_) / counts.size)
        idx = np.minimum((centers / self.range * self.n_bins).astype(np.int64),
                         self.n_bins - 1)
        np.add.at(self.counts, idx, counts)

    def _centers(self) -> np.ndarray:
        w = self.range / self.n_bins
        return (np.arange(self.n_bins) + 0.5) * w

    def amax(self, method: str, qmax: float, percentile: float = 99.99) -> float:
        if self.counts is None:
            raise ValueError("no data collected")
        if method == "absmax":
            return max(self.amax_observed, 1e-12)
        if method == "percentile":
            cdf = np.cumsum(self.counts) / max(self.counts.sum(), 1)
            idx = int(np.searchsorted(cdf, percentile / 100.0))
            idx = min(idx, self.n_bins - 1)
            return max(float((idx + 1) * self.range / self.n_bins), 1e-12)
        if method == "mse":
            return self._amax_mse(qmax)
        if method == "entropy":
            return self._amax_entropy(qmax)
        raise ValueError(f"unknown calibration method {method!r}")

    def _amax_mse(self, qmax: float, n_candidates: int = 100) -> float:
        centers = self._centers()
        p = self.counts.astype(np.float64)
        best_amax, best_err = self.range, math.inf
        hi = max(self.amax_observed, self.range / self.n_bins)
        for frac in np.linspace(0.2, 1.0, n_candidates):
            amax = hi * frac
            step = amax / qmax
            q = np.clip(np.round(centers / step), 0, qmax) * step
            err = float(np.sum(p * (centers - q) ** 2))
            if err < best_err:
                best_err, best_amax = err, amax
        return max(best_amax, 1e-12)

    def _amax_entropy(self, qmax: float, start_frac: float = 0.25) -> float:
        """TensorRT-style KL calibration over candidate clip points."""
        p_full = self.counts.astype(np.float64)
        n_levels = int(qmax) + 1
        nz = np.nonzero(p_full)[0]
        if nz.size == 0:
            return max(self.amax_observed, 1e-12)
        last = int(nz[-1]) + 1
        best_i, best_kl = last, math.inf
        start = max(n_levels, int(last * start_frac))
        for i in range(start, last + 1):
            ref = p_full[:i].copy()
            ref[-1] += p_full[i:].sum()  # clip mass into the last bin
            if ref.sum() == 0:
                continue
            # Quantize bins [0, i) to n_levels, then expand back.
            edges = np.linspace(0, i, n_levels + 1).astype(int)
            q = np.zeros(i)
            for j in range(n_levels):
                lo, hi_ = edges[j], max(edges[j + 1], edges[j] + 1)
                chunk = p_full[lo:hi_]
                nz_mask = chunk > 0
                if nz_mask.any():
                    q[lo:hi_][nz_mask] = chunk[nz_mask].sum() / nz_mask.sum()
            ref_d = ref / ref.sum()
            q_d = q / max(q.sum(), 1e-12)
            mask = ref_d > 0
            kl = float(np.sum(ref_d[mask] * np.log(ref_d[mask] / np.maximum(q_d[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_i = kl, i
        return max(best_i * self.range / self.n_bins, 1e-12)


# ---------------------------------------------------------------------------
# Tap forward: the converted graph in float, returning the activations that
# feed every grid site (NHWC, as the JAX package's).
# ---------------------------------------------------------------------------


def _plan(graph: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Each layer's real-valued weights ``w_int * mult_core`` (float32, OIHW)
    and bias on the device."""

    def layer(entry):
        w = np.asarray(entry["w_int"]).astype(np.float32) * np.asarray(entry["mult_core"],
                                                                      np.float32)
        return {"w": torch.tensor(np.transpose(w, (3, 2, 0, 1)), device=device),
                "bias": torch.tensor(np.asarray(entry["bias"], np.float32), device=device),
                "stride": int(entry["stride"]), "groups": int(entry["groups"])}

    return {
        "stem": layer(graph["stem"]),
        "blocks": [{k: (layer(v) if k in ("expand", "depthwise", "project") else v)
                    for k, v in b.items()} for b in graph["blocks"]],
        "head_conv": layer(graph["head_conv"]),
    }


def _conv_f32(x: torch.Tensor, layer: Dict[str, Any], relu: bool) -> torch.Tensor:
    w = layer["w"]
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=layer["stride"],
                                   padding=(w.shape[-1] - 1) // 2, groups=layer["groups"])
    y = y.permute(0, 2, 3, 1) + layer["bias"]
    return torch.clamp_min(y, 0.0) if relu else y


def _tap_forward(planned: Dict[str, Any], images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Float forward of a planned graph; returns {site: activation}."""
    taps: Dict[str, torch.Tensor] = {}
    x = true_div(images.float(), 255.0) if images.dtype == torch.uint8 else images.float()
    y = _conv_f32(x, planned["stem"], relu=True)
    taps["stem"] = y
    for i, blk in enumerate(planned["blocks"]):
        shared_vals: List[torch.Tensor] = []
        if "shared_step" in blk and (blk["input_quant"] or blk["use_residual"]):
            shared_vals.append(y)
        residual = y
        h = y
        if "expand" in blk:
            h = _conv_f32(h, blk["expand"], relu=True)
            if blk["expand_grid"]:
                taps[f"block{i}.expand"] = h
        h = _conv_f32(h, blk["depthwise"], relu=True)
        taps[f"block{i}.depthwise"] = h
        h = _conv_f32(h, blk["project"], relu=False)
        if blk["use_residual"]:
            shared_vals.append(h)
            y = h + residual
            shared_vals.append(y)
        else:
            y = h
        if shared_vals:
            # One magnitude pool a site: the shared quantizer sees the block
            # input, the projection output and their sum.
            taps[f"block{i}.shared"] = torch.cat(
                [v.abs().reshape(v.shape[0], -1) for v in shared_vals], dim=1)
    taps["final_shared"] = y
    y = _conv_f32(y, planned["head_conv"], relu=True)
    taps["head_conv"] = y
    taps["head.pool"] = y.mean(dim=(1, 2))
    return taps


def _site_stats(v: torch.Tensor, n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(amax, counts) of one site's magnitudes on the device: the maximum
    over every value, the histogram over a strided sub-sample."""
    mags = v.float().abs().reshape(-1)
    amax = mags.max()
    rng_ = torch.clamp_min(amax, 1e-12) * 1.25
    k = max(1, mags.numel() // _SUBSAMPLE)
    sub = torch.sort(mags[::k]).values
    edges = torch.linspace(0.0, 1.0, n_bins + 1, device=v.device) * rng_
    ss = torch.searchsorted(sub, edges, side="left")
    return amax, ss[1:] - ss[:-1]


@torch.inference_mode()
def collect_activation_stats(
    graph: Dict[str, Any],
    batches: Iterable[np.ndarray],
    n_bins: int = 2048,
    max_batches: int = 256,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, HistogramCollector]:
    """Observe the float net over calibration batches (uint8 NHWC, numpy
    arrays or tensors; 256 at most); each batch's histograms are taken
    against its own range on the device and merged on the host
    (``HistogramCollector.update_hist``)."""
    dev = torch.device(device)
    g = scalars(graph)
    planned = _plan(g, dev)
    for b, blk in zip(planned["blocks"], g["blocks"]):
        b["expand_grid"] = "act_step" in blk.get("expand", {})
    collectors: Dict[str, HistogramCollector] = {}
    with f32_convs():
        for b, images in enumerate(batches):
            if b >= max_batches:
                break
            images = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
            taps = _tap_forward(planned, images.to(dev))
            for site, v in taps.items():
                amax, counts = _site_stats(v, n_bins)
                amax = float(amax)
                rng_ = max(amax, 1e-12) * 1.25
                collectors.setdefault(site, HistogramCollector(n_bins)).update_hist(
                    counts.cpu().numpy(), rng_, amax)
    if not collectors:
        raise ValueError("no calibration batches provided")
    return collectors


def calibrate_graph(
    graph: Dict[str, Any],
    batches: Iterable[np.ndarray],
    method: str = "percentile",
    percentile: float = 99.99,
    n_bins: int = 2048,
    max_batches: int = 256,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Overwrite every activation grid of ``graph`` from observed statistics.

    Returns (the calibrated graph, a shallow copy with its layer dicts
    replaced, and {site: amax}).  Weight grids are untouched.
    """
    stats = collect_activation_stats(graph, batches, n_bins, max_batches, device)
    amaxes: Dict[str, float] = {}

    def site_amax(site: str, qmax: float) -> float:
        amax = stats[site].amax(method, qmax, percentile)
        amaxes[site] = amax
        return amax

    def with_grid(layer: Dict[str, Any], site: str) -> Dict[str, Any]:
        # Recipes with real-valued interiors have no grid at some sites.
        if "act_qmax" not in layer:
            return layer
        layer = dict(layer)
        qmax = layer["act_qmax"]
        layer["act_step"] = site_amax(site, qmax) / qmax
        return layer

    g = dict(graph)
    g["stem"] = with_grid(graph["stem"], "stem")
    new_blocks = []
    for i, blk in enumerate(graph["blocks"]):
        b = dict(blk)
        if f"block{i}.shared" in stats and "shared_step" in b:
            b["shared_step"] = site_amax(f"block{i}.shared", b["shared_qmax"]) / b["shared_qmax"]
        if "expand" in b:
            b["expand"] = with_grid(b["expand"], f"block{i}.expand")
        b["depthwise"] = with_grid(b["depthwise"], f"block{i}.depthwise")
        new_blocks.append(b)
    g["blocks"] = new_blocks
    fs = dict(graph["final_shared"])
    fs["step"] = site_amax("final_shared", fs["qmax"]) / fs["qmax"]
    g["final_shared"] = fs
    g["head_conv"] = with_grid(graph["head_conv"], "head_conv")
    head = dict(graph["head"])
    head["pool_step"] = site_amax("head.pool", head["pool_qmax"]) / head["pool_qmax"]
    g["head"] = head
    return g, amaxes


def _copy_tree(tree: Any) -> Any:
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def write_scales_to_params(variables: Dict[str, Any], amaxes: Dict[str, float]) -> Dict[str, Any]:
    """Map calibrated amax values onto the QAT model's ``log2_scale`` leaves
    of a flax-layout variable tree; returns a new tree."""
    variables = _copy_tree(variables)
    params = variables["params"]

    def set_scale(tree, amax):
        tree["log2_scale"] = np.asarray(np.log2(max(amax, 1e-12)), np.float32)

    bb = params["backbone"]
    if "stem" in amaxes and "act_quant" in bb.get("stem", {}):
        set_scale(bb["stem"]["act_quant"], amaxes["stem"])
    for i in range(len([k for k in bb if k.startswith("block_")])):
        bp = bb.get(f"block_{i}", {})
        if f"block{i}.shared" in amaxes and "shared_quant" in bp:
            set_scale(bp["shared_quant"], amaxes[f"block{i}.shared"])
        if f"block{i}.expand" in amaxes and "act_quant" in bp.get("expand", {}):
            set_scale(bp["expand"]["act_quant"], amaxes[f"block{i}.expand"])
        if f"block{i}.depthwise" in amaxes and "act_quant" in bp.get("depthwise", {}):
            set_scale(bp["depthwise"]["act_quant"], amaxes[f"block{i}.depthwise"])
    if "final_shared" in amaxes and "final_shared_quant" in bb:
        set_scale(bb["final_shared_quant"], amaxes["final_shared"])
    if "head_conv" in amaxes and "act_quant" in bb.get("head_conv", {}):
        set_scale(bb["head_conv"]["act_quant"], amaxes["head_conv"])
    if "head.pool" in amaxes and "pool_quant" in params.get("head", {}):
        set_scale(params["head"]["pool_quant"], amaxes["head.pool"])
    return variables
