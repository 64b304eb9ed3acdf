"""Quaternion / DCM / Euler rotation math — batched PyTorch.

Counterpart of ``spef_tpu.pose.rotations`` with the same conventions:
scalar-first Hamilton quaternions ``[w, x, y, z]``, active rotations, Euler
sequence 3-2-1 (yaw, pitch, roll) in degrees.  Every function takes
arbitrary leading batch dimensions and has no data-dependent branches:
Spurrier's four-way selection in :func:`dcm2quat` is a mask, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "quat2dcm",
    "dcm2quat",
    "quat2euler",
    "euler2quat",
    "euler2dcm",
    "dcm2euler",
    "multiply_quaternions",
    "conjugate_quaternion",
    "rotate_vector",
    "euler_angle_difference",
    "generate_orientation",
    "normalize_quaternion",
    "enforce_north",
    "quat_angle",
]

_DEG = math.pi / 180.0


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def enforce_north(q: torch.Tensor) -> torch.Tensor:
    """Flip quaternions so the scalar part is non-negative (north pole)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat2dcm(q: torch.Tensor) -> torch.Tensor:
    """Scalar-first unit quaternion ``(..., 4)`` -> DCM ``(..., 3, 3)``."""
    q0, q1, q2, q3 = q.unbind(-1)
    r00 = 2 * q0**2 - 1 + 2 * q1**2
    r11 = 2 * q0**2 - 1 + 2 * q2**2
    r22 = 2 * q0**2 - 1 + 2 * q3**2
    r01 = 2 * q1 * q2 - 2 * q0 * q3
    r02 = 2 * q1 * q3 + 2 * q0 * q2
    r10 = 2 * q1 * q2 + 2 * q0 * q3
    r12 = 2 * q2 * q3 - 2 * q0 * q1
    r20 = 2 * q1 * q3 - 2 * q0 * q2
    r21 = 2 * q2 * q3 + 2 * q0 * q1
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


def dcm2quat(dcm: torch.Tensor, north: bool = False) -> torch.Tensor:
    """DCM ``(..., 3, 3)`` -> scalar-first unit quaternion (Spurrier's method).

    All four candidates are computed and the numerically safe one (largest
    of trace, m11, m22, m33) is selected by masks, in the reference's order.
    """
    m = dcm
    m11, m12, m13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m21, m22, m23 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m31, m32, m33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m11 + m22 + m33

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-20))

    q0_a = safe_sqrt(1 + trace) / 2
    d0 = 4 * q0_a
    cand0 = torch.stack([q0_a, (m32 - m23) / d0, (m13 - m31) / d0, (m21 - m12) / d0], -1)
    q1_b = safe_sqrt(m11 / 2 + (1 - trace) / 4)
    d1 = 4 * q1_b
    cand1 = torch.stack([(m32 - m23) / d1, q1_b, (m21 + m12) / d1, (m31 + m13) / d1], -1)
    q2_c = safe_sqrt(m22 / 2 + (1 - trace) / 4)
    d2 = 4 * q2_c
    cand2 = torch.stack([(m13 - m31) / d2, (m12 + m21) / d2, q2_c, (m32 + m23) / d2], -1)
    q3_d = safe_sqrt(m33 / 2 + (1 - trace) / 4)
    d3 = 4 * q3_d
    cand3 = torch.stack([(m21 - m12) / d3, (m13 + m31) / d3, (m23 + m32) / d3, q3_d], -1)

    use0 = trace > torch.maximum(m11, torch.maximum(m22, m33))
    use1 = m11 > torch.maximum(trace, torch.maximum(m22, m33))
    use2 = m22 > torch.maximum(trace, torch.maximum(m11, m33))
    q = torch.where(use0[..., None], cand0,
                    torch.where(use1[..., None], cand1,
                                torch.where(use2[..., None], cand2, cand3)))
    if north:
        q = enforce_north(q)
    return normalize_quaternion(q)


def quat2euler(q: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Scalar-first unit quaternion -> ``(..., 3)`` ``[yaw, pitch, roll]``,
    the pitch argument clipped for robustness as in the reference."""
    q0, q1, q2, q3 = q.unbind(-1)
    yaw = torch.atan2(2 * (q0 * q3 + q1 * q2), 2 * (q0**2 + q1**2) - 1)
    clip_arg = torch.clamp(1 - (2 * (q1 * q3 - q0 * q2)) ** 2, 0.0, 1.0)
    pitch = torch.atan2(-2 * (q1 * q3 - q0 * q2), torch.sqrt(clip_arg))
    roll = torch.atan2(2 * (q0 * q1 + q2 * q3), 2 * (q0**2 + q3**2) - 1)
    e = torch.stack([yaw, pitch, roll], -1)
    return torch.rad2deg(e) if degrees else e


def euler2quat(euler: torch.Tensor, north: bool = False, degrees: bool = True) -> torch.Tensor:
    """Euler ``(..., 3)`` as ``[yaw, pitch, roll]`` -> scalar-first unit quaternion."""
    e = euler * _DEG if degrees else euler
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


def euler2dcm(euler: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Euler ``(..., 3)`` as ``[yaw, pitch, roll]`` -> DCM ``(..., 3, 3)``."""
    e = euler * _DEG if degrees else euler
    c, s = torch.cos(e), torch.sin(e)
    cy, cp, cr = c[..., 0], c[..., 1], c[..., 2]
    sy, sp, sr = s[..., 0], s[..., 1], s[..., 2]
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def dcm2euler(dcm: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """DCM ``(..., 3, 3)`` -> ``(..., 3)`` ``[yaw, pitch, roll]``."""
    m11, m21, m31 = dcm[..., 0, 0], dcm[..., 1, 0], dcm[..., 2, 0]
    m32, m33 = dcm[..., 2, 1], dcm[..., 2, 2]
    yaw = torch.atan2(m21, m11)
    pitch = torch.atan2(-m31, torch.sqrt(torch.clamp(1 - m31**2, 0.0, 1.0)))
    roll = torch.atan2(m32, m33)
    e = torch.stack([yaw, pitch, roll], -1)
    return torch.rad2deg(e) if degrees else e


def multiply_quaternions(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Hamilton product of scalar-first quaternions, normalized; broadcasts."""
    q0, q1, q2, q3 = qa.unbind(-1)
    p0, p1, p2, p3 = qb.unbind(-1)
    w = q0 * p0 - q1 * p1 - q2 * p2 - q3 * p3
    x = q0 * p1 + q1 * p0 + q2 * p3 - q3 * p2
    y = q0 * p2 + q2 * p0 - q1 * p3 + q3 * p1
    z = q0 * p3 + q3 * p0 + q1 * p2 - q2 * p1
    return normalize_quaternion(torch.stack([w, x, y, z], -1))


def conjugate_quaternion(q: torch.Tensor) -> torch.Tensor:
    """``[w, x, y, z] -> [w, -x, -y, -z]``."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Actively rotate 3-vectors ``v`` by quaternions ``q``: ``R(q) @ v``."""
    return torch.einsum("...ij,...j->...i", quat2dcm(q), v)


def euler_angle_difference(angle1: torch.Tensor, angle2: torch.Tensor) -> torch.Tensor:
    """Circular angle difference ``angle2 - angle1`` wrapped to [-180, 180) degrees."""
    return torch.remainder(angle2 - angle1 + 180.0, 360.0) - 180.0


def quat_angle(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between two unit quaternions, sign-invariant."""
    dot = torch.clamp(torch.abs(torch.sum(qa * qb, dim=-1)), 0.0, 1.0)
    return 2.0 * torch.arccos(dot)


def generate_orientation(generator: Optional[torch.Generator], n_samples: int) -> torch.Tensor:
    """Uniform random unit quaternions ``(n_samples, 4)``, Shoemake's subgroup
    algorithm.  ``generator`` takes the place of the JAX key."""
    x = torch.rand((3, n_samples), generator=generator)
    x0, x1, x2 = x[0], x[1], x[2]
    theta1 = 2 * math.pi * x1
    theta2 = 2 * math.pi * x2
    r1 = torch.sqrt(1 - x0)
    r2 = torch.sqrt(x0)
    return torch.stack([torch.sin(theta1) * r1, torch.cos(theta1) * r1,
                        torch.sin(theta2) * r2, torch.cos(theta2) * r2], -1)
