"""Host-side yaw-rotation augmentation: a warp of each frame in the loader.

Counterpart of ``spef_tpu.data.augment_host`` (``host_yaw_rotation``,
``HostRotationAugment``): the resized frame is warped by ``K R K^-1`` (``K``
scaled to the frame, ``R`` a yaw rotation) and its pose rotated to match,
with the same random draws (``np.random.RandomState(seed)``: ``rand() >=
p`` skips the frame, else one more ``rand()`` gives the angle).

JAX warps with ``cv2.warpPerspective``; the port depends on no OpenCV, so
:func:`warp_perspective_plain` is that call in numpy (``INTER_LINEAR``,
``BORDER_CONSTANT`` 0), written to give OpenCV 5.0's bytes, and
``native/warp.cpp`` the same arithmetic in C++ (std::fma), about a hundred
times faster.  OpenCV 5.0
warps in float32, not in fixed point as OpenCV 4 did, and its x86 build
computes 16 output columns at a time with fused multiply-adds:

  * inverse map: the inverse of ``M`` (float64) cast to float32; per row
    the constants ``y*M1 + M2`` (two roundings), then ``fma(x, M0, .)``;
    ``1/w`` then a product, for ``x`` below the last multiple of 16; the
    remaining columns (the scalar tail) ``fma(x, M0, y*M1) + M2`` divided
    by ``w``;
  * taps: ``floor`` of the source coordinates, each of the four taps that
    falls outside the image is 0;
  * ``v0 = fma(a, p01 - p00, p00)``, ``v1`` the same on the lower row,
    ``v = fma(b, v1 - v0, v0)``, then ``rint`` and a clip to [0, 255].

In numpy a float32 FMA is a float64 product plus sum rounded to float32
(exact for the map and the first two taps' sums; the last one could round
twice, which no tested frame shows).  ``tests/test_torch_augment_host.py``
holds both against ``cv2.warpPerspective`` on yaw warps at several angles
and sizes, and against each other.

:func:`warp_perspective` runs the C++ warp where g++ is present and the
numpy one where it is not (:func:`warp_backend`); the two give the same
bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

from spef_tpu_torch import native
from spef_tpu_torch.data.camera import Camera

__all__ = ["warp_backend", "warp_perspective", "warp_perspective_plain", "host_yaw_rotation",
           "yaw_pose", "HostRotationAugment"]

_F32 = np.float32
# Output columns a SIMD iteration of OpenCV's warp computes (two 8-lane
# float32 registers); the columns past the last full group take its scalar
# tail.
_VECTOR_COLUMNS = 16


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the float64 product of two
    float32 values is exact)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(_F32)


def warp_backend() -> str:
    """``"native"`` where g++ is present (``native/warp.cpp``), else
    ``"numpy"``."""
    return "native" if native.warp_available() else "numpy"


def _inverse(m: np.ndarray) -> np.ndarray:
    """The map's inverse in float64, cast to float32, as OpenCV inverts it."""
    return np.linalg.inv(np.asarray(m, np.float64)).astype(_F32)


def warp_perspective(image: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(image, m, dsize)`` with ``INTER_LINEAR`` and a
    constant border of 0: ``image`` (H, W, C) uint8, ``dsize`` (width,
    height) of the output; each output pixel samples ``image`` at
    ``m^-1 @ (x, y, 1)``.  On :func:`warp_backend`."""
    if warp_backend() == "native":
        return native.warp_perspective(image, _inverse(m), dsize[1], dsize[0])
    return warp_perspective_plain(image, m, dsize)


def warp_perspective_plain(image: np.ndarray, m: np.ndarray,
                           dsize: Tuple[int, int]) -> np.ndarray:
    """:func:`warp_perspective` in numpy."""
    w_out, h_out = dsize
    h, w = image.shape[:2]
    mi = _inverse(m)
    ys = np.arange(h_out, dtype=_F32)[:, None]
    split = (w_out // _VECTOR_COLUMNS) * _VECTOR_COLUMNS
    xv = np.arange(split, dtype=_F32)[None, :]
    xt = np.arange(split, w_out, dtype=_F32)[None, :]

    def vector(r):  # fma(x, M0, y*M1 + M2)
        return _fma(xv, mi[r, 0], ys * mi[r, 1] + mi[r, 2])

    def tail(r):  # fma(x, M0, y*M1) + M2
        return _fma(xt, mi[r, 0], ys * mi[r, 1]) + mi[r, 2]

    inv_w = _F32(1) / vector(2)
    w_tail = tail(2)
    sx = np.concatenate([vector(0) * inv_w, tail(0) / w_tail], axis=1)
    sy = np.concatenate([vector(1) * inv_w, tail(1) / w_tail], axis=1)

    # Taps from a zero-padded copy: coordinates clipped to [-2, size + 1]
    # keep every tap inside the padding, which is the constant border.
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx).reshape(-1, 1).astype(np.float64)
    b = (sy - fy).reshape(-1, 1).astype(np.float64)
    pw = w + 5
    channels = image.shape[2] if image.ndim == 3 else 1
    padded = np.zeros((h + 5, pw, channels), np.uint8)
    padded[2:2 + h, 2:2 + w] = image.reshape(h, w, channels)
    i00 = ((np.clip(fy, -2, h + 1).astype(np.int64) + 2) * pw
           + np.clip(fx, -2, w + 1).astype(np.int64) + 2).reshape(1, -1)
    taps = np.take(padded.reshape(-1, channels), i00 + np.array([[0], [1], [pw], [pw + 1]]),
                   axis=0).astype(np.float64)
    # Pixel differences are exact; the float64 product of a float32 weight by
    # one is exact, and so is its sum with a pixel: one float32 FMA each.
    v0 = (a * (taps[1] - taps[0]) + taps[0]).astype(_F32)
    v1 = (a * (taps[3] - taps[2]) + taps[2]).astype(_F32)
    v = _fma(b, v1 - v0, v0)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out.reshape((h_out, w_out) + image.shape[2:])


def _euler2dcm_yaw(deg: float) -> np.ndarray:
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _dcm2quat(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    q = np.array([
        np.sqrt(max(1 + tr, 0)) / 2,
        (m[2, 1] - m[1, 2]),
        (m[0, 2] - m[2, 0]),
        (m[1, 0] - m[0, 1]),
    ])
    q[1:] /= 4 * max(q[0], 1e-12)
    return q / np.linalg.norm(q)


def _quat_mul(qa, qb) -> np.ndarray:
    q0, q1, q2, q3 = qa
    p0, p1, p2, p3 = qb
    q = np.array([
        q0 * p0 - q1 * p1 - q2 * p2 - q3 * p3,
        q0 * p1 + q1 * p0 + q2 * p3 - q3 * p2,
        q0 * p2 + q2 * p0 - q1 * p3 + q3 * p1,
        q0 * p3 + q3 * p0 + q1 * p2 - q2 * p1,
    ])
    return q / np.linalg.norm(q)


def host_yaw_rotation(image: np.ndarray, ori: np.ndarray, pos: np.ndarray, camera: Camera,
                      rotation_deg: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Warp one resized frame (H, W, 3) uint8 by a yaw rotation of
    ``rotation_deg`` and rotate its pose: ``(image, ori, pos)``."""
    h, w = image.shape[:2]
    r_change = _euler2dcm_yaw(rotation_deg)
    k = camera.K.copy()
    k[0] *= w / camera.nu
    k[1] *= h / camera.nv
    transform = k @ r_change @ np.linalg.inv(k)
    return (warp_perspective(image, transform, (w, h)),) + yaw_pose(ori, pos, rotation_deg)


def yaw_pose(ori: np.ndarray, pos: np.ndarray,
             rotation_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """The pose ``(ori, pos)`` of :func:`host_yaw_rotation`, without the warp."""
    r_change = _euler2dcm_yaw(rotation_deg)
    pos_new = (r_change @ np.asarray(pos, np.float64)).astype(np.float32)
    ori_new = _quat_mul(_dcm2quat(r_change), np.asarray(ori, np.float64)).astype(np.float32)
    return ori_new, pos_new


class HostRotationAugment:
    """Per-frame random yaw rotation for ``BatchLoader(rot_augment=...)``:
    with probability ``rot_probability`` a uniform angle in
    [-rot_max_magnitude, rot_max_magnitude].

    ``aug(image, ori, pos)`` draws and warps, as JAX's; :meth:`draw` and
    :meth:`apply` split the two, so that a loader can take the draws in
    frame order and warp the frames on several threads.  ``warp`` is the
    :func:`warp_backend` it warps on.  ``frames`` / ``warped`` count the
    draws and the warps, ``warp_seconds`` the host time of the warps (summed
    over threads)."""

    def __init__(self, camera: Camera, rot_probability: float = 0.5,
                 rot_max_magnitude: float = 50.0, seed: int = 1001):
        self.camera = camera
        self.warp = warp_backend()
        self.rot_probability = rot_probability
        self.rot_max_magnitude = rot_max_magnitude
        self.rng = np.random.RandomState(seed)
        self.frames = 0
        self.warped = 0
        self.warp_seconds = 0.0
        self._lock = threading.Lock()

    def draw(self) -> Optional[float]:
        """The next frame's angle in degrees, or None where it is not rotated."""
        self.frames += 1
        if self.rng.rand() >= self.rot_probability:
            return None
        return (self.rng.rand() - 0.5) * 2 * self.rot_max_magnitude

    def apply(self, image, ori, pos, deg: Optional[float], warp: bool = True):
        """``(image, ori, pos)`` rotated by ``deg`` (unchanged where None);
        without ``warp`` only the pose (another rank warps the frame)."""
        if deg is None:
            return image, ori, pos
        if not warp:
            return (image,) + yaw_pose(ori, pos, deg)
        start = time.perf_counter()
        out = host_yaw_rotation(image, ori, pos, self.camera, deg)
        with self._lock:
            self.warp_seconds += time.perf_counter() - start
            self.warped += 1
        return out

    def __call__(self, image, ori, pos):
        return self.apply(image, ori, pos, self.draw())
