"""URSONet-style soft-classification codecs — batched PyTorch.

Counterpart of ``spef_tpu.codec.softclass``:

  * Encode: the Gaussian kernel over the bin histogram for the whole batch,
    one ``(B, 4) x (4, n_bins)`` product (ori) or ``(B, n_bins, 3)``
    squared distances (pos).
  * Ori decode: ``A = H^T diag(p) H`` for the whole batch, then the
    eigenvector of the largest eigenvalue from a batched ``eigh`` (``A`` is
    symmetric PSD).  ``eigh`` does not fix the sign of ``q``: compare
    quaternions up to sign.
  * Pos decode: probability-weighted mean of bin centers — one matmul.

All of them run in float32 with TF32 off: TF32 keeps about three decimal digits,
which is the bf16-Gram hazard the JAX package met in EPnP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.pose.rotations import euler2quat, normalize_quaternion

__all__ = ["OrientationSoftClassification", "PositionSoftClassification"]


def _grid3(n: int, min_lim: np.ndarray, max_lim: np.ndarray) -> np.ndarray:
    """(n^3, 3) grid over [min_lim, max_lim], 'ij' meshgrid order."""
    lin = np.linspace(0.0, 1.0, n)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid * (max_lim - min_lim) + min_lim


def _exact_f32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class OrientationSoftClassification:
    """Attitude codec over an n^3 Euler-bin quaternion histogram."""

    n_bins_per_dim: int
    smooth_factor: float
    delete_unused_bins: bool
    histogram: torch.Tensor  # (n_bins, 4) float32
    redundant_flags: torch.Tensor  # (n_raw_bins,) bool

    @classmethod
    def create(
        cls,
        n_bins_per_dim: int = 12,
        smooth_factor: float = 3,
        delete_unused_bins: bool = True,
        device: Union[str, torch.device] = "cuda",
    ) -> "OrientationSoftClassification":
        min_lim = np.array([-180.0, -90.0, -180.0])
        max_lim = np.array([180.0, 90.0, 180.0])
        euler_bins = _grid3(n_bins_per_dim, min_lim, max_lim)
        # float32 like the JAX package (jnp.asarray of the float64 grid).
        quats = euler2quat(torch.from_numpy(euler_bins.astype(np.float32)))

        # Circular duplicates at yaw=+180 / roll=+180 and gimbal-lock rows at
        # |pitch|=90 (except yaw=-180 & pitch=-90, which are kept).
        boundary = np.logical_or(euler_bins[:, 0] == max_lim[0], euler_bins[:, 2] == max_lim[2])
        gimbal = np.logical_and(np.abs(euler_bins[:, 1]) == max_lim[1],
                                euler_bins[:, 0] != min_lim[0])
        redundant = np.logical_or(boundary, gimbal)
        if delete_unused_bins:
            quats = quats[torch.from_numpy(~redundant)]
        return cls(
            n_bins_per_dim=n_bins_per_dim,
            smooth_factor=float(smooth_factor),
            delete_unused_bins=delete_unused_bins,
            histogram=quats.to(device=device, dtype=torch.float32),
            redundant_flags=torch.from_numpy(redundant).to(device),
        )

    @property
    def n_bins(self) -> int:
        return self.histogram.shape[0]

    def encode(self, ori: torch.Tensor) -> torch.Tensor:
        """True orientations ``(..., 4)`` -> soft-class targets ``(..., n_bins)``:
        eq. 3 of Proenca's URSONet, a Gaussian kernel of the angle to each bin."""
        _exact_f32_matmuls()
        variance = (self.smooth_factor / self.n_bins_per_dim) ** 2 / 12.0
        dots = torch.abs(ori.float() @ self.histogram.T)
        ang = 2.0 * torch.arccos(torch.clamp(dots, max=1.0)) / math.pi
        kernel = torch.exp(-(ang**2) / (2.0 * variance))
        if not self.delete_unused_bins:
            kernel = torch.where(self.redundant_flags, 0.0, kernel)
        return kernel / torch.sum(kernel, dim=-1, keepdim=True)

    def decode(self, probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(n_bins,)`` or ``(B, n_bins)`` PDFs -> ``(q, A^-1)``.

        ``q`` is the dominant eigenvector of ``A = H^T diag(p) H``; ``A^-1``
        is the max-likelihood uncertainty.
        """
        _exact_f32_matmuls()
        squeeze = probs.dim() == 1
        p = torch.atleast_2d(probs).float()
        h = self.histogram
        a = torch.einsum("bn,ni,nj->bij", p, h, h)
        _, v = torch.linalg.eigh(a)  # ascending eigenvalues
        q_avg = normalize_quaternion(v[..., :, -1])
        h_inv = torch.linalg.inv(a)
        if squeeze:
            return q_avg[0], h_inv[0]
        return q_avg, h_inv

    # The JAX codec's batched name; ``decode`` already takes ``(B, n_bins)``.
    decode_batch = decode


@dataclasses.dataclass(frozen=True)
class PositionSoftClassification:
    """Position codec over an n^3 xyz grid (5 m margin limits by default)."""

    n_bins_per_dim: int
    smooth_factor: float
    histogram: torch.Tensor  # (n_bins, 3)
    min_lim: Tuple[float, float, float]
    max_lim: Tuple[float, float, float]

    @classmethod
    def create(
        cls,
        n_bins_per_dim: int = 10,
        smooth_factor: float = 100,
        min_lim=(-16.0, -12.0, -2.0),
        max_lim=(16.0, 12.0, 40.0),
        device: Union[str, torch.device] = "cuda",
    ) -> "PositionSoftClassification":
        bins = _grid3(n_bins_per_dim, np.asarray(min_lim, float), np.asarray(max_lim, float))
        return cls(
            n_bins_per_dim=n_bins_per_dim,
            smooth_factor=float(smooth_factor),
            histogram=torch.as_tensor(bins, dtype=torch.float32, device=device),
            min_lim=tuple(min_lim),
            max_lim=tuple(max_lim),
        )

    @property
    def n_bins(self) -> int:
        return self.histogram.shape[0]

    def encode(self, pos: torch.Tensor) -> torch.Tensor:
        """True positions ``(..., 3)`` -> soft-class targets ``(..., n_bins)``:
        a Gaussian kernel over the squared distances to the bin centers."""
        variance = (self.smooth_factor / self.n_bins_per_dim) ** 2 / 12.0
        diff = pos.float()[..., None, :] - self.histogram
        kernel = torch.exp(-torch.sum(diff**2, dim=-1) / (2.0 * variance))
        return kernel / torch.sum(kernel, dim=-1, keepdim=True)

    def decode(self, probs: torch.Tensor) -> torch.Tensor:
        """Probability-weighted mean of bin centers, ``(..., n_bins) -> (..., 3)``."""
        _exact_f32_matmuls()
        probs = probs.float()
        weighted = probs @ self.histogram
        return weighted / probs.sum(dim=-1, keepdim=True)

    decode_batch = decode
