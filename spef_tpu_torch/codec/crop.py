"""Two-stage crop-refine keypoint localization — batched PyTorch.

Counterpart of ``spef_tpu.codec.crop``:

  * a square crop box ``[cx, cy, s]`` (normalized full-frame units) around
    predicted keypoints, robust to gross outliers (a median / MAD rule),
    with margin, min size and frame clamping;
  * keypoints mapped into and out of a crop, and the per-keypoint
    coarse-consistency gate of the two-pass pipeline;
  * the bilinear crop + resize as two per-sample interpolation operators
    ``(B, h_out, H)`` and ``(B, w_out, W)`` contracted with the images by
    ``einsum`` (batched matmuls) in float32 with TF32 off, the JAX
    package's formulation: each operator row holds two bilinear taps;
  * :class:`CropRefinePipeline`: coarse pass, box, crop, fine pass and the
    keypoints mapped back, one function of the images.

``jnp.median`` averages the two middle values of an even count; so does
:func:`_median` here (``torch.median`` returns the lower one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from spef_tpu_torch.codec.epnp import exact_f32

__all__ = ["MIN_BOX_SIZE", "crop_box_from_keypoints", "clamp_box", "draw_jitter", "apply_jitter",
           "jitter_box", "map_keypoints_to_crop", "map_keypoints_from_crop", "gate_keypoints",
           "crop_resize", "CropRefinePipeline"]

# Below this normalized side a 384-wide crop would sample finer than the
# 1920-pixel sensor (0.2 * 1920 = 384).
MIN_BOX_SIZE = 0.2


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis, kept: the mean of the two middle
    values for an even count."""
    s, _ = torch.sort(x, dim=-1)
    n = x.shape[-1]
    return (s[..., (n - 1) // 2:(n - 1) // 2 + 1] + s[..., n // 2:n // 2 + 1]) / 2


def clamp_box(box: torch.Tensor, min_size: float = MIN_BOX_SIZE) -> torch.Tensor:
    """Clamp ``[..., (cx, cy, s)]`` to lie fully inside the unit frame."""
    s = torch.clamp(box[..., 2], min_size, 1.0)
    cx = torch.minimum(torch.maximum(box[..., 0], s / 2), 1.0 - s / 2)
    cy = torch.minimum(torch.maximum(box[..., 1], s / 2), 1.0 - s / 2)
    return torch.stack([cx, cy, s], dim=-1)


def crop_box_from_keypoints(keypoints2d: torch.Tensor, margin: float = 1.25,
                            min_size: float = MIN_BOX_SIZE, outlier_k: Optional[float] = 3.0
                            ) -> torch.Tensor:
    """Square box ``(..., 3)`` around keypoints ``(..., 2K)``.  With
    ``outlier_k``, points farther than ``k`` median absolute deviations of
    the radius from the median centre are left out of the extent (all are
    kept where fewer than 4 would survive)."""
    kp = keypoints2d.reshape(*keypoints2d.shape[:-1], -1, 2)
    x, y = kp[..., 0], kp[..., 1]
    if outlier_k is not None:
        mx, my = _median(x), _median(y)
        r = torch.sqrt((x - mx) ** 2 + (y - my) ** 2)
        madr = _median(r)
        keep = r <= outlier_k * torch.clamp(madr, min=1e-3)
        enough = keep.sum(dim=-1, keepdim=True) >= 4
        keep = keep | ~enough
        big = 10.0
        x_min = torch.where(keep, x, big).amin(dim=-1)
        x_max = torch.where(keep, x, -big).amax(dim=-1)
        y_min = torch.where(keep, y, big).amin(dim=-1)
        y_max = torch.where(keep, y, -big).amax(dim=-1)
    else:
        x_min, x_max = x.amin(dim=-1), x.amax(dim=-1)
        y_min, y_max = y.amin(dim=-1), y.amax(dim=-1)
    cx = (x_min + x_max) / 2
    cy = (y_min + y_max) / 2
    s = torch.maximum(x_max - x_min, y_max - y_min) * margin
    return clamp_box(torch.stack([cx, cy, s], dim=-1), min_size)


def draw_jitter(generator: torch.Generator, batch_shape: Tuple[int, ...],
                scale_range: Tuple[float, float] = (1.05, 1.5), center_frac: float = 0.08
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random half of :func:`jitter_box`: scale factors ``batch_shape``
    uniform in ``scale_range`` and centre shifts ``batch_shape + (2,)``
    uniform in ``[-center_frac, center_frac)``, on the generator's device."""
    dev = generator.device
    lo, hi = scale_range
    f = lo + (hi - lo) * torch.rand(batch_shape, generator=generator, device=dev)
    d = -center_frac + 2 * center_frac * torch.rand(
        (*batch_shape, 2), generator=generator, device=dev)
    return f, d


def apply_jitter(box: torch.Tensor, f: torch.Tensor, d: torch.Tensor,
                 min_size: float = MIN_BOX_SIZE) -> torch.Tensor:
    """The deterministic half of :func:`jitter_box`: side scaled by ``f``,
    centre moved by ``d`` times the new side, then clamped."""
    s = box[..., 2] * f
    c = box[..., :2] + d * s[..., None]
    return clamp_box(torch.cat([c, s[..., None]], dim=-1), min_size)


def jitter_box(generator: torch.Generator, box: torch.Tensor,
               scale_range: Tuple[float, float] = (1.05, 1.5), center_frac: float = 0.08,
               min_size: float = MIN_BOX_SIZE) -> torch.Tensor:
    """Randomly scaled / shifted boxes (detector noise at training time)."""
    f, d = draw_jitter(generator, tuple(box.shape[:-1]), scale_range, center_frac)
    return apply_jitter(box, f.to(box.device), d.to(box.device), min_size)


def map_keypoints_to_crop(keypoints2d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Full-frame normalized keypoints ``(..., 2K)`` -> crop-local."""
    kp = keypoints2d.reshape(*keypoints2d.shape[:-1], -1, 2)
    origin = box[..., None, :2] - box[..., None, 2:3] / 2
    return ((kp - origin) / box[..., None, 2:3]).reshape(keypoints2d.shape)


def map_keypoints_from_crop(keypoints2d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`map_keypoints_to_crop`."""
    kp = keypoints2d.reshape(*keypoints2d.shape[:-1], -1, 2)
    origin = box[..., None, :2] - box[..., None, 2:3] / 2
    return (kp * box[..., None, 2:3] + origin).reshape(keypoints2d.shape)


def gate_keypoints(fine: torch.Tensor, coarse: torch.Tensor, tau: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each fine keypoint where it lies within ``tau`` (normalized) of the
    coarse one, else the coarse one.  Returns ``(keypoints, keep (..., K))``."""
    f = fine.reshape(*fine.shape[:-1], -1, 2)
    c = coarse.reshape(*coarse.shape[:-1], -1, 2)
    keep = torch.linalg.vector_norm(f - c, dim=-1, keepdim=True) <= tau
    return torch.where(keep, f, c).reshape(fine.shape), keep[..., 0]


def _axis_operator(center: torch.Tensor, side: torch.Tensor, n_in: int, n_out: int
                   ) -> torch.Tensor:
    """Per-sample 1-D bilinear resampling operator ``(B, n_out, n_in)``:
    row ``i`` samples the window ``[center - side/2, center + side/2]`` at
    the output pixel centre ``(i + 0.5) / n_out``."""
    i = (torch.arange(n_out, dtype=torch.float32, device=center.device) + 0.5) / n_out
    src = (center[:, None] - side[:, None] / 2 + i[None, :] * side[:, None]) * n_in - 0.5
    src = torch.clamp(src, 0.0, n_in - 1.0)
    lo = torch.floor(src)
    w_hi = src - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, max=n_in - 1)
    eye = torch.eye(n_in, dtype=torch.float32, device=center.device)
    return eye[lo_i] * (1.0 - w_hi)[..., None] + eye[hi_i] * w_hi[..., None]


def crop_resize(images: torch.Tensor, box: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
    """Bilinear crop + resize ``(B, H, W, C), (B, 3) -> (B, h, w, C)`` float32:
    rows then columns, each a batched product with its operator."""
    exact_f32()
    _, h_in, w_in, _ = images.shape
    h_out, w_out = out_hw
    ry = _axis_operator(box[:, 1], box[:, 2], h_in, h_out)  # (B, h_out, H)
    rx = _axis_operator(box[:, 0], box[:, 2], w_in, w_out)  # (B, w_out, W)
    rows = torch.einsum("boh,bhwc->bowc", ry, images.float())
    return torch.einsum("bpw,bowc->bopc", rx, rows)


@dataclasses.dataclass
class CropRefinePipeline:
    """The two-pass keypoint predictor: ``coarse_fn`` / ``fine_fn`` map
    images ``(B, H, W, C)`` float in [0, 1] to keypoint logits ``(B, 2K)``;
    the sigmoid is applied here.  The PnP decode stays with the caller."""

    coarse_fn: Callable[[torch.Tensor], torch.Tensor]
    fine_fn: Callable[[torch.Tensor], torch.Tensor]
    crop_hw: Tuple[int, int] = (240, 384)
    # The box is the keypoint extent times the margin: 1.5 sits in the fine
    # model's training windows (extent * [1.31, 1.88]).
    margin: float = 1.5
    min_size: float = MIN_BOX_SIZE
    # The coarse-consistency gate (gate_keypoints); None disables it.
    gate: Optional[float] = 0.02

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        coarse = torch.sigmoid(self.coarse_fn(images))
        box = crop_box_from_keypoints(coarse, self.margin, self.min_size)
        crops = crop_resize(images, box, self.crop_hw)
        fine = map_keypoints_from_crop(torch.sigmoid(self.fine_fn(crops)), box)
        out = {"keypoints": fine, "keypoints_coarse": coarse, "crop_box": box}
        if self.gate is not None:
            gated, keep = gate_keypoints(fine, coarse, self.gate)
            out.update(keypoints=gated, keypoints_fine=fine, gate_keep=keep)
        return out
