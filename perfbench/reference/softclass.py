"""The soft-classification codec of URSONet (Proenca and Gao,
arXiv:1907.04298), plain PyTorch in float32 with TF32 off.

Orientation: 12 Euler bins a dimension over [-180, 180] x [-90, 90] x
[-180, 180], the redundant ones removed (yaw or roll at +180, pitch at
+-90 but the yaw -180 row), each bin a quaternion; a target is a Gaussian
kernel of the angle to each bin, variance (smooth / n)^2 / 12; the decode
is the dominant eigenvector of ``H^T diag(p) H``.  Position: 10 bins a
dimension over the 5 m margin limits; the decode is the probability
weighted mean of the bin centres.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _grid3(n: int, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    lin = np.linspace(0.0, 1.0, n)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid * (hi - lo) + lo


def _euler_to_quat(e: torch.Tensor) -> torch.Tensor:
    """(N, 3) yaw, pitch, roll in degrees -> (N, 4) scalar-first quaternions
    (z-y-x rotation order)."""
    yaw, pitch, roll = (torch.deg2rad(e[:, i]) / 2 for i in range(3))
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    q = torch.stack([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                     sy * cp * sr + cy * sp * cr, sy * cp * cr - cy * sp * sr], -1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


class Codec:
    """The orientation and position histograms of a configuration."""

    def __init__(self, cfg: Dict, device):
        n = cfg["ori_bins_per_dim"]
        lo, hi = np.array([-180.0, -90.0, -180.0]), np.array([180.0, 90.0, 180.0])
        euler = _grid3(n, lo, hi)
        quats = _euler_to_quat(torch.from_numpy(euler.astype(np.float32)))
        redundant = (euler[:, 0] == hi[0]) | (euler[:, 2] == hi[2]) | (
            (np.abs(euler[:, 1]) == hi[1]) & (euler[:, 0] != lo[0]))
        if cfg["ori_delete_unused_bins"]:
            quats = quats[torch.from_numpy(~redundant)]
        self.ori_hist = quats.to(device)
        self.ori_var = (cfg["ori_smooth_factor"] / n) ** 2 / 12.0
        npos = cfg["pos_bins_per_dim"]
        self.pos_hist = torch.as_tensor(
            _grid3(npos, np.asarray(cfg["pos_min"], float), np.asarray(cfg["pos_max"], float)),
            dtype=torch.float32, device=device)
        self.pos_var = (cfg["pos_smooth_factor"] / npos) ** 2 / 12.0

    def encode(self, ori: torch.Tensor, pos: torch.Tensor):
        """Soft targets (ori (B, n_ori), pos (B, n_pos)) of true poses."""
        dots = torch.abs(ori.float() @ self.ori_hist.T)
        ang = 2.0 * torch.arccos(torch.clamp(dots, max=1.0)) / math.pi
        k_ori = torch.exp(-(ang ** 2) / (2.0 * self.ori_var))
        diff = pos.float()[:, None, :] - self.pos_hist
        k_pos = torch.exp(-torch.sum(diff ** 2, dim=-1) / (2.0 * self.pos_var))
        return (k_ori / k_ori.sum(-1, keepdim=True), k_pos / k_pos.sum(-1, keepdim=True))

    def decode(self, p_ori: torch.Tensor, p_pos: torch.Tensor):
        """(quaternion (B, 4), position (B, 3), eigenvalues (B, 4) ascending)
        of soft-class PDFs; the quaternion's sign is free.  The eigenvalues
        of ``H^T diag(p) H`` (they sum to 1) say how well posed the
        quaternion is: the largest near 1 for a peaked PDF, the two largest
        near each other for a PDF with two modes of equal weight, whose
        quaternion any rounding can swap."""
        h = self.ori_hist
        a = torch.einsum("bn,ni,nj->bij", p_ori.float(), h, h)
        ev, v = torch.linalg.eigh(a)
        q = v[..., :, -1]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        pos = (p_pos.float() @ self.pos_hist) / p_pos.float().sum(-1, keepdim=True)
        return q, pos, ev
