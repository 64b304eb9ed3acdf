"""Adaptive temporal PDF filter (PyTorch).

Counterpart of ``spef_tpu.temporal.pdf_filter``: exponential blending of
consecutive soft-classification PDFs with a distance-adaptive weight

    w = exp(-alpha * d(current, previous)),  clipped to [0, 1]
    updated = w * n * current + (1 - w) * previous,  renormalized

with the distances l2 / kl / js / hellinger / tv / wasserstein, in float32.

Two APIs:
  * :class:`TemporalPDF`: frame at a time (streaming), the reference's
    interface; ``update_pdf`` returns the distance as a Python float.
  * :func:`scan_filter`: a whole sequence ``(..., T, n_bins)``, batched over
    any leading dimensions.  It is a Python loop over ``T`` on tensors that
    stay on their device: no step reads a value back to the host, so the
    steps queue their kernels without waiting.  Frame 0 is the normalized
    current PDF with distance 0, as the JAX scan's first step gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["compute_distance", "TemporalPDF", "scan_filter",
           "ORI_FILTER_DEFAULTS", "POS_FILTER_DEFAULTS",
           "DOMAIN_FILTER_DEFAULTS", "filter_defaults"]

# The reference's SPEED-domain constants.
ORI_FILTER_DEFAULTS = dict(n=0.8, alpha=16.49, distance_metric="l2")
POS_FILTER_DEFAULTS = dict(n=0.5, alpha=48.64, distance_metric="l2")

# Domain-tuned constants, keyed by dataset family.  The D-SPEED values come
# from the sweep over the 11 kinematic scenarios recorded in
# ``experiments/accuracy_suite/temporal_tuning.json`` (js distance on both
# heads); SPEED and SPEED+ keep the reference constants.
DOMAIN_FILTER_DEFAULTS = {
    "speed": {"ori": ORI_FILTER_DEFAULTS, "pos": POS_FILTER_DEFAULTS},
    "speed_plus": {"ori": ORI_FILTER_DEFAULTS, "pos": POS_FILTER_DEFAULTS},
    "dspeed": {
        "ori": dict(n=1.1, alpha=16.554545661412405, distance_metric="js"),
        "pos": dict(n=0.2, alpha=12.188681275988856, distance_metric="js"),
    },
}
DOMAIN_FILTER_DEFAULTS["dspeed_video"] = DOMAIN_FILTER_DEFAULTS["dspeed"]


def filter_defaults(dataset: Optional[str] = None) -> Tuple[dict, dict]:
    """(ori_cfg, pos_cfg) for a dataset family (the reference constants when
    unknown or None)."""
    d = DOMAIN_FILTER_DEFAULTS.get(dataset or "",
                                   {"ori": ORI_FILTER_DEFAULTS,
                                    "pos": POS_FILTER_DEFAULTS})
    return dict(d["ori"]), dict(d["pos"])


_EPS = 1e-12


def _normalize(pdf: torch.Tensor) -> torch.Tensor:
    return pdf / torch.sum(pdf, dim=-1, keepdim=True)


def compute_distance(pdf1: torch.Tensor, pdf2: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distance between two PDFs of any scale, over the last axis."""
    pdf1, pdf2 = _normalize(pdf1), _normalize(pdf2)
    if metric == "l2":
        return torch.linalg.vector_norm(pdf1 - pdf2, dim=-1)
    if metric == "kl":
        p1, p2 = pdf1 + _EPS, pdf2 + _EPS
        return torch.sum(p1 * torch.log(p1 / p2), dim=-1)
    if metric == "js":
        m = 0.5 * (pdf1 + pdf2)
        js = 0.5 * (
            torch.sum(pdf1 * torch.log((pdf1 + _EPS) / (m + _EPS)), dim=-1)
            + torch.sum(pdf2 * torch.log((pdf2 + _EPS) / (m + _EPS)), dim=-1)
        )
        return torch.sqrt(torch.clamp_min(js, 0.0))
    if metric == "hellinger":
        return torch.sqrt(0.5 * torch.sum((torch.sqrt(pdf1) - torch.sqrt(pdf2)) ** 2, dim=-1))
    if metric == "tv":
        return 0.5 * torch.sum(torch.abs(pdf1 - pdf2), dim=-1)
    if metric == "wasserstein":
        cdf1, cdf2 = torch.cumsum(pdf1, dim=-1), torch.cumsum(pdf2, dim=-1)
        return torch.sum(torch.abs(cdf1 - cdf2), dim=-1) / pdf1.shape[-1]
    raise ValueError(f"Unsupported distance metric: {metric}")


def _blend(current: torch.Tensor, previous: torch.Tensor, n: float, alpha: float,
           metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update after the first frame: ``current`` normalized, ``previous``
    the last update.  Returns (updated, distance)."""
    distance = compute_distance(current, previous, metric)
    weight = torch.clamp(torch.exp(-alpha * distance), 0.0, 1.0)[..., None]
    blended = weight * n * current + (1.0 - weight) * previous
    return _normalize(blended), distance


@dataclasses.dataclass
class TemporalPDF:
    """Streaming (frame-at-a-time) filter, the reference's interface."""

    n: float = 1.0
    alpha: float = 1.0
    distance_metric: str = "l2"
    previous_pdf: Optional[torch.Tensor] = None

    def reset(self) -> None:
        self.previous_pdf = None

    def update_pdf(self, current_pdf) -> Tuple[torch.Tensor, float]:
        """(updated PDF, distance as a float); the first frame passes through
        normalized, with distance 0."""
        current = _normalize(torch.as_tensor(current_pdf).float())
        if self.previous_pdf is None:
            self.previous_pdf = current
            return current, 0.0
        updated, distance = _blend(current, self.previous_pdf, self.n, self.alpha,
                                   self.distance_metric)
        self.previous_pdf = updated
        return updated, float(distance)


def scan_filter(pdfs: torch.Tensor, n: float, alpha: float, metric: str = "l2"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter whole sequences: ``pdfs`` ``(..., T, n_bins)`` -> (filtered
    ``(..., T, n_bins)``, distances ``(..., T)``), float32, on ``pdfs``'s
    device.  The same trajectory as :class:`TemporalPDF` frame by frame
    (tested); the leading dimensions are independent sequences."""
    pdfs = pdfs.float()
    previous = _normalize(pdfs[..., 0, :])
    filtered = [previous]
    distances = [torch.zeros(pdfs.shape[:-2], dtype=torch.float32, device=pdfs.device)]
    for t in range(1, pdfs.shape[-2]):
        previous, distance = _blend(_normalize(pdfs[..., t, :]), previous, n, alpha, metric)
        filtered.append(previous)
        distances.append(distance)
    return torch.stack(filtered, dim=-2), torch.stack(distances, dim=-1)
