"""The benchmark's frame maker: poses from the recipe's ranges and the Tango
wireframe drawn at them on noise, made on the device from a seeded
``torch.Generator`` in a few batched calls.

A frame is what the flagship was trained on (the port's
``data/synthetic.py``, the JAX writers' frames): the 11 Tango keypoints
projected by the D-SPEED camera scaled to the image, 15 edges each in its
own colour and a filled disc at each keypoint, thickness 36 / depth pixels
at 240x384 (drawn half a pixel wider, without the anti-aliased fringe), plus Gaussian noise of standard deviation 6 on all channels,
in the channel order the model reads.  It is drawn by distance to each
segment and disc, not by OpenCV's rasterizer, so it is the same picture
and not the same bytes; a trained model gives peaked PDFs on it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

TANGO_3D_KEYPOINTS = np.array([
    [-0.3700, -0.3850, 0.3215], [-0.3700, 0.3850, 0.3215], [0.3700, 0.3850, 0.3215],
    [0.3700, -0.3850, 0.3215], [-0.3700, -0.2640, 0.0000], [-0.3700, 0.3040, 0.0000],
    [0.3700, 0.3040, 0.0000], [0.3700, -0.2640, 0.0000], [-0.5427, 0.4877, 0.2535],
    [0.5427, 0.4877, 0.2591], [0.3050, -0.5790, 0.2515],
], np.float32)

EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7), (1, 8), (2, 9), (3, 10))


def _colours() -> Tuple[np.ndarray, np.ndarray]:
    """Edge and keypoint colours of the training renders (drawn BGR, read
    back reversed)."""
    rng = np.random.RandomState(42)
    edges = rng.randint(80, 256, (len(EDGES), 3))[:, ::-1]
    points = rng.randint(100, 256, (len(TANGO_3D_KEYPOINTS), 3))[:, ::-1]
    return edges.astype(np.float32), points.astype(np.float32)


def camera_k(camera: Dict) -> np.ndarray:
    fpx, fpy = camera["fx"] / camera["ppx"], camera["fy"] / camera["ppy"]
    return np.array([[fpx, 0.0, camera["nu"] / 2], [0.0, fpy, camera["nv"] / 2],
                     [0.0, 0.0, 1.0]])


def quat_to_dcm(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) scalar-first quaternions -> (N, 3, 3), the renderer's matrix."""
    q0, q1, q2, q3 = q.unbind(-1)
    return torch.stack([
        torch.stack([2 * q0**2 - 1 + 2 * q1**2, 2 * q1 * q2 - 2 * q0 * q3,
                     2 * q1 * q3 + 2 * q0 * q2], -1),
        torch.stack([2 * q1 * q2 + 2 * q0 * q3, 2 * q0**2 - 1 + 2 * q2**2,
                     2 * q2 * q3 - 2 * q0 * q1], -1),
        torch.stack([2 * q1 * q3 - 2 * q0 * q2, 2 * q2 * q3 + 2 * q0 * q1,
                     2 * q0**2 - 1 + 2 * q3**2], -1)], -2)


def project(q: torch.Tensor, pos: torch.Tensor, camera: Dict) -> torch.Tensor:
    """(N, 11, 2) pixels of the keypoints at full camera resolution."""
    kp = torch.as_tensor(TANGO_3D_KEYPOINTS, device=q.device)
    xyz = kp @ quat_to_dcm(q).transpose(-1, -2) + pos[:, None, :]
    k = camera_k(camera)
    u = k[0, 0] * xyz[..., 0] / xyz[..., 2] + k[0, 2]
    v = k[1, 1] * xyz[..., 1] / xyz[..., 2] + k[1, 2]
    return torch.stack([u, v], -1)


def sample_poses(gen: torch.Generator, n: int, camera: Dict, z_range=(3.0, 35.0),
                 xy_over_z: float = 0.3, min_visible: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` (ori, pos) pairs: Shoemake-uniform orientations, depth uniform in
    ``z_range``, x and y uniform within ``xy_over_z`` of it, at least
    ``min_visible`` keypoints in the frame; by rejection, in batches."""
    dev = gen.device
    oris, poss, have = [], [], 0
    while have < n:
        m = 2 * (n - have) + 64
        u = torch.rand((m, 6), generator=gen, device=dev, dtype=torch.float64)
        t1, t2 = 2 * math.pi * u[:, 1], 2 * math.pi * u[:, 2]
        r1, r2 = torch.sqrt(1 - u[:, 0]), torch.sqrt(u[:, 0])
        q = torch.stack([torch.sin(t1) * r1, torch.cos(t1) * r1, torch.sin(t2) * r2,
                         torch.cos(t2) * r2], -1).float()
        z = z_range[0] + (z_range[1] - z_range[0]) * u[:, 3]
        x = (2 * u[:, 4] - 1) * xy_over_z * z
        y = (2 * u[:, 5] - 1) * xy_over_z * z
        pos = torch.stack([x, y, z], -1).float()
        uv = project(q, pos, camera)
        inside = ((uv[..., 0] >= 0) & (uv[..., 0] < camera["nu"]) & (uv[..., 1] >= 0)
                  & (uv[..., 1] < camera["nv"])).sum(-1) >= min_visible
        oris.append(q[inside])
        poss.append(pos[inside])
        have += int(inside.sum())
    return torch.cat(oris)[:n], torch.cat(poss)[:n]


def render(gen: torch.Generator, q: torch.Tensor, pos: torch.Tensor, camera: Dict,
           img_size: Tuple[int, int], noise_std: float = 6.0) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames of the wireframe at each pose, on noise."""
    h, w = img_size
    dev = q.device
    sx, sy = w / camera["nu"], h / camera["nv"]
    uv = project(q, pos, camera)
    uv = torch.round(torch.stack([uv[..., 0] * sx, uv[..., 1] * sy], -1))
    thick = torch.clamp(torch.round(60.0 / pos[:, 2] * min(sx, sy) * 3), min=1.0)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    img = torch.zeros((q.shape[0], h, w, 3), device=dev)
    edge_c, point_c = (torch.as_tensor(c, device=dev) for c in _colours())
    half = ((thick + 1) / 2)[:, None, None]
    for (a, b), colour in zip(EDGES, edge_c):
        pa, pb = uv[:, a], uv[:, b]
        d = pb - pa
        len2 = torch.clamp((d * d).sum(-1), min=1e-6)[:, None, None]
        px = xs - pa[:, 0, None, None]
        py = ys - pa[:, 1, None, None]
        t = torch.clamp((px * d[:, 0, None, None] + py * d[:, 1, None, None]) / len2, 0.0, 1.0)
        dist2 = (px - t * d[:, 0, None, None]) ** 2 + (py - t * d[:, 1, None, None]) ** 2
        img = torch.where((dist2 <= half * half)[..., None], colour, img)
    radius = (thick + 1)[:, None, None]
    for i, colour in enumerate(point_c):
        dist2 = (xs - uv[:, i, 0, None, None]) ** 2 + (ys - uv[:, i, 1, None, None]) ** 2
        img = torch.where((dist2 <= radius * radius)[..., None], colour, img)
    noise = torch.randn((q.shape[0], h, w, 1), generator=gen, device=dev) * noise_std
    return torch.clamp(img + noise, 0, 255).to(torch.uint8)


def make_frames(gen: torch.Generator, n: int, camera: Dict, img_size: Tuple[int, int],
                frames: Dict, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(images (n, H, W, 3) uint8, ori, pos) on the generator's device, by
    the traffic's ``frames`` parameters, drawn ``chunk`` frames at a time."""
    ori, pos = sample_poses(gen, n, camera, tuple(frames["z_range"]), frames["xy_over_z"],
                            frames["min_visible"])
    images = torch.cat([render(gen, ori[i:i + chunk], pos[i:i + chunk], camera, img_size,
                               frames["noise_std"]) for i in range(0, n, chunk)])
    return images, ori, pos
