"""Synthetic wireframe Tango frames with exact poses — counterpart of
``spef_tpu.data.synthetic`` (``generate_positions`` and ``render_frame``).

The pose sampling mirrors the reference's D-SPEED generator: uniform random
orientations, positions with z in [3, 35] and x, y within +/-0.3 z, at least
8 of the 11 keypoints inside the frame.  A frame is the wireframe of those
keypoints, each edge in its own colour, drawn anti-aliased
(:mod:`spef_tpu_torch.data.raster`, OpenCV's drawing in plain Python), plus
Gaussian noise.  For the same random state both packages give the same
frames bit for bit; the calibration of the int8 graph runs on them.

The dataset writers come with the data slice (ROADMAP §A, item 7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from spef_tpu_torch.data.camera import DSPEED_CAMERA, Camera
from spef_tpu_torch.data.raster import Canvas

__all__ = ["TANGO_3D_KEYPOINTS", "generate_positions", "render_frame"]

# The 11 Tango keypoints [m], rows = points, cols = (x, y, z): the SPNv2
# tangoPoints asset (``spef_tpu.codec.keypoints.TANGO_3D_KEYPOINTS``).
TANGO_3D_KEYPOINTS = np.array(
    [
        [-0.3700, -0.3850, 0.3215],
        [-0.3700, 0.3850, 0.3215],
        [0.3700, 0.3850, 0.3215],
        [0.3700, -0.3850, 0.3215],
        [-0.3700, -0.2640, 0.0000],
        [-0.3700, 0.3040, 0.0000],
        [0.3700, 0.3040, 0.0000],
        [0.3700, -0.2640, 0.0000],
        [-0.5427, 0.4877, 0.2535],
        [0.5427, 0.4877, 0.2591],
        [0.3050, -0.5790, 0.2515],
    ],
    dtype=np.float32,
)

# Wireframe edges over the 11 keypoints (top face, bottom face, pillars,
# antenna tips to the nearest top corners).
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # top plate
    (4, 5), (5, 6), (6, 7), (7, 4),  # bottom plate
    (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
    (1, 8), (2, 9), (3, 10),  # antennas
]


def _project_np(q: np.ndarray, pos: np.ndarray, camera: Camera) -> np.ndarray:
    """Projection of the 11 keypoints -> (11, 2) pixels."""
    q0, q1, q2, q3 = q
    r = np.array(
        [
            [2 * q0**2 - 1 + 2 * q1**2, 2 * q1 * q2 - 2 * q0 * q3, 2 * q1 * q3 + 2 * q0 * q2],
            [2 * q1 * q2 + 2 * q0 * q3, 2 * q0**2 - 1 + 2 * q2**2, 2 * q2 * q3 - 2 * q0 * q1],
            [2 * q1 * q3 - 2 * q0 * q2, 2 * q2 * q3 + 2 * q0 * q1, 2 * q0**2 - 1 + 2 * q3**2],
        ]
    )
    xyz = TANGO_3D_KEYPOINTS @ r.T + pos
    k = camera.K
    u = k[0, 0] * xyz[:, 0] / xyz[:, 2] + k[0, 2]
    v = k[1, 1] * xyz[:, 1] / xyz[:, 2] + k[1, 2]
    return np.stack([u, v], axis=-1)


def _random_quats(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Shoemake uniform quaternions."""
    x0, x1, x2 = rng.rand(n), rng.rand(n), rng.rand(n)
    t1, t2 = 2 * np.pi * x1, 2 * np.pi * x2
    r1, r2 = np.sqrt(1 - x0), np.sqrt(x0)
    return np.stack([np.sin(t1) * r1, np.cos(t1) * r1, np.sin(t2) * r2, np.cos(t2) * r2], -1)


def generate_positions(
    rng: np.random.RandomState,
    n: int,
    camera: Camera = DSPEED_CAMERA,
    z_range: Tuple[float, float] = (3.0, 35.0),
    min_visible: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (ori, pos) pairs under the visibility constraint, by rejection."""
    oris, poss = [], []
    while len(oris) < n:
        q = _random_quats(rng, 1)[0]
        z = rng.uniform(*z_range)
        x = rng.uniform(-0.3, 0.3) * z
        y = rng.uniform(-0.3, 0.3) * z
        pos = np.array([x, y, z], np.float32)
        uv = _project_np(q, pos, camera)
        visible = np.sum(
            (uv[:, 0] >= 0) & (uv[:, 0] < camera.nu) & (uv[:, 1] >= 0) & (uv[:, 1] < camera.nv)
        )
        if visible >= min_visible:
            oris.append(q.astype(np.float32))
            poss.append(pos)
    return np.stack(oris), np.stack(poss)


def render_frame(
    q: np.ndarray,
    pos: np.ndarray,
    camera: Camera = DSPEED_CAMERA,
    img_size: Tuple[int, int] = (1200, 1920),
    noise_std: float = 6.0,
    rng: Optional[np.random.RandomState] = None,
    window: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Render one wireframe frame (H, W, 3) uint8 at camera resolution scaled
    to ``img_size`` (H, W).

    ``window``: an optional normalized crop window ``[cx, cy, s]`` rendered
    to ``img_size`` in place of the full frame (an ideal sensor crop).
    """
    h, w = img_size
    uv = _project_np(q, pos, camera)
    if window is not None:
        cx, cy, s = float(window[0]), float(window[1]), float(window[2])
        un = uv[:, 0] / camera.nu
        vn = uv[:, 1] / camera.nv
        uv = np.stack([(un - (cx - s / 2)) / s * w, (vn - (cy - s / 2)) / s * h], -1)
        sx, sy = w / (camera.nu * s), h / (camera.nv * s)
    else:
        sx, sy = w / camera.nu, h / camera.nv
        uv = np.stack([uv[:, 0] * sx, uv[:, 1] * sy], -1)

    canvas = Canvas(h, w)
    depth = float(pos[2])
    thickness = max(1, int(round(60.0 / depth * min(sx, sy) * 3)))
    # Distinct colours per edge: a plain grey wireframe is nearly symmetric
    # under 180-degree flips, which makes orientation unlearnable.
    edge_rng = np.random.RandomState(42)
    edge_colors = edge_rng.randint(80, 256, (len(_EDGES), 3)).tolist()
    for (a, b), color in zip(_EDGES, edge_colors):
        pa = tuple(int(c) for c in np.round(uv[a]).astype(int))
        pb = tuple(int(c) for c in np.round(uv[b]).astype(int))
        canvas.line(pa, pb, [int(c) for c in color], thickness)
    point_colors = edge_rng.randint(100, 256, (uv.shape[0], 3)).tolist()
    for i in range(uv.shape[0]):
        p = tuple(int(c) for c in np.round(uv[i]).astype(int))
        canvas.filled_circle(p, thickness + 1, [int(c) for c in point_colors[i]])
    img = np.frombuffer(bytes(canvas.buf), np.uint8).reshape(h, w, 3).copy()
    if noise_std > 0:
        rng = rng or np.random.RandomState(0)
        noise = rng.randn(h, w, 1) * noise_std
        img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return img
