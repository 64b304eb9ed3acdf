"""Quaternion math the soft-class codec needs — batched PyTorch.

Counterpart of the matching functions of ``spef_tpu.pose.rotations`` with
the same conventions: scalar-first Hamilton quaternions ``[w, x, y, z]``,
active rotations, Euler sequence 3-2-1 (yaw, pitch, roll) in degrees.  Every
function takes arbitrary leading batch dimensions and has no branches.
The rest of the JAX module comes with the keypoints slice (ROADMAP §A).
"""

from __future__ import annotations

import math

import torch

__all__ = ["normalize_quaternion", "enforce_north", "euler2quat"]


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def enforce_north(q: torch.Tensor) -> torch.Tensor:
    """Flip quaternions so the scalar part is non-negative (north pole)."""
    return torch.where(q[..., :1] < 0, -q, q)


def euler2quat(euler: torch.Tensor, north: bool = False, degrees: bool = True) -> torch.Tensor:
    """Euler ``(..., 3)`` as ``[yaw, pitch, roll]`` -> scalar-first unit quaternion."""
    e = euler * (math.pi / 180.0) if degrees else euler
    half = e / 2
    c, s = torch.cos(half), torch.sin(half)
    cy, cp, cr = c[..., 0], c[..., 1], c[..., 2]
    sy, sp, sr = s[..., 0], s[..., 1], s[..., 2]
    q = torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )
    if north:
        q = enforce_north(q)
    return normalize_quaternion(q)
