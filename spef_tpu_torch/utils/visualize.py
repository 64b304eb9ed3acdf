"""Pose visualization overlays: axis arrows, wireframe, keypoints, bboxes.

Counterpart of ``spef_tpu.utils.visualize.VisualizePose``: RGB / MYC / RCA
axis-arrow triads for true / predicted / temporal poses, the Tango wireframe
from the keypoint label vector, and normalized-bbox rectangles, drawn on
BGR uint8 frames.  The JAX package draws with OpenCV; the port draws the
same calls with :class:`spef_tpu_torch.data.raster.Canvas` (``arrowedLine``
and ``rectangle`` at ``LINE_8``, ``line`` and filled ``circle`` at
``LINE_AA``) and resizes with :func:`~spef_tpu_torch.data.raster.resize_linear`
(``cv2.resize``, ``INTER_LINEAR``), pixel for pixel.  Each ``draw_*`` draws
into the array it is given and returns it, as OpenCV's calls do.

The projection computes the DCM in float32, as the JAX package does (its
float64 quaternion becomes a float32 JAX array: JAX runs without 64-bit
floats), and the rest in float64 numpy, the same operations in the same
order.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.data.raster import Canvas, resize_linear
from spef_tpu_torch.pose.rotations import quat2dcm

__all__ = ["VisualizePose"]

_ARROW_COLORS = {
    # BGR triads for the three axis arrows (x, y, z).
    "RGB": [(0, 0, 255), (0, 255, 0), (255, 0, 0)],
    "MYC": [(255, 0, 255), (0, 255, 255), (255, 255, 0)],
    "RCA": [(0, 0, 180), (200, 200, 0), (180, 120, 0)],
}
_POINT_COLORS = {
    "red": (0, 0, 255),
    "green": (0, 255, 0),
    "blue": (255, 0, 0),
}
# Wireframe edges over [origin + 11 keypoints] label layout.
_WIRE_EDGES = [
    (1, 2), (2, 3), (3, 4), (4, 1),  # top plate
    (5, 6), (6, 7), (7, 8), (8, 5),  # bottom plate
    (1, 5), (2, 6), (3, 7), (4, 8),  # pillars
    (2, 9), (3, 10), (4, 11),  # antennas
]


def _drawn(image: np.ndarray, draw) -> np.ndarray:
    """Run ``draw(canvas)`` on a canvas of ``image`` and write the result back
    into ``image`` (the in-place contract of OpenCV's drawing calls)."""
    canvas = Canvas.from_array(image)
    draw(canvas)
    image[...] = canvas.to_array()
    return image


class VisualizePose:
    def __init__(self, spe_utils, resolution: Optional[Tuple[int, int]] = None):
        self.spe_utils = spe_utils
        self.resolution = resolution

    def set_spe_utils(self, spe_utils):
        self.spe_utils = spe_utils

    # ------------------------------------------------------------------
    def _project_axes(self, q: np.ndarray, r: np.ndarray, scale: float = 1.0) -> np.ndarray:
        """Project origin + unit axis heads to pixels -> (4, 2)."""
        pts = np.array([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]], np.float64)
        q32 = torch.as_tensor(np.asarray(q, np.float64), dtype=torch.float32)
        dcm = quat2dcm(q32).numpy().astype(np.float64)
        xyz = pts @ dcm.T + np.asarray(r, np.float64)
        k = self.spe_utils.camera.K
        u = k[0, 0] * xyz[:, 0] / xyz[:, 2] + k[0, 2]
        v = k[1, 1] * xyz[:, 1] / xyz[:, 2] + k[1, 2]
        return np.stack([u, v], axis=-1)

    def _scale_to_image(self, image: np.ndarray) -> Tuple[float, float]:
        h, w = image.shape[:2]
        return w / self.spe_utils.camera.nu, h / self.spe_utils.camera.nv

    def draw_arrow(self, image: np.ndarray, pose: Dict, color: str = "RGB") -> np.ndarray:
        sx, sy = self._scale_to_image(image)
        uv = self._project_axes(pose["ori"], pose["pos"])
        uv = uv * [sx, sy]
        # A garbage prediction (an untrained model with z ~ 0) projects to
        # NaN / inf: skip the overlay instead of failing.
        if not np.isfinite(uv).all():
            return image
        uv = np.round(np.clip(uv, -1e6, 1e6)).astype(int)
        origin = (int(uv[0, 0]), int(uv[0, 1]))

        def draw(canvas: Canvas) -> None:
            for i, c in enumerate(_ARROW_COLORS[color]):
                canvas.arrowed_line(origin, (int(uv[i + 1, 0]), int(uv[i + 1, 1])), c, 2, 0.1)

        return _drawn(image, draw)

    def draw_keypoints(self, image: np.ndarray, keypoints: np.ndarray,
                       color: str = "red", wireframe: bool = True) -> np.ndarray:
        """Draw the normalized keypoint label vector (+ Tango wireframe)."""
        h, w = image.shape[:2]
        kp = np.asarray(keypoints).reshape(-1, 2) * [w, h]
        if not np.isfinite(kp).all():
            return image
        pts = [(int(x), int(y)) for x, y in np.round(np.clip(kp, -1e6, 1e6)).astype(int)]
        c = _POINT_COLORS[color]

        def draw(canvas: Canvas) -> None:
            if wireframe and len(pts) >= 12:
                for a, b in _WIRE_EDGES:
                    canvas.line(pts[a], pts[b], c, 1)
            for p in pts:
                canvas.filled_circle(p, 3, c)

        return _drawn(image, draw)

    def draw_bbox(self, image: np.ndarray, bbox: np.ndarray, color: str = "red") -> np.ndarray:
        h, w = image.shape[:2]
        box = np.asarray(bbox, np.float64) * [w, h, w, h]
        if not np.isfinite(box).all():
            return image
        x0, y0, x1, y1 = np.clip(box, -1e6, 1e6)
        return _drawn(image, lambda canvas: canvas.rectangle(
            (int(x0), int(y0)), (int(x1), int(y1)), _POINT_COLORS[color], 2))

    # ------------------------------------------------------------------
    def add_visualization(
        self,
        image: Optional[np.ndarray] = None,
        true_pose: Optional[dict] = None,
        pred_pose: Optional[dict] = None,
        temp_pose: Optional[dict] = None,
        show_true_pose: bool = False,
        show_pred_pose: bool = False,
        show_temp_pose: bool = False,
        show_true_bbox: bool = False,
        show_pred_bbox: bool = False,
        show_temp_bbox: bool = False,
        show_true_keypoints: bool = False,
        show_pred_keypoints: bool = False,
        show_temp_keypoints: bool = False,
    ) -> np.ndarray:
        """Compose the overlays on a copy of ``image`` (the JAX package's
        flags); resized to ``resolution`` where one is set."""
        assert image is not None, "Image must be provided."
        image = copy.deepcopy(np.asarray(image))

        for pose, show_p, show_k, show_b, arrow, col in (
            (true_pose, show_true_pose, show_true_keypoints, show_true_bbox, "RGB", "red"),
            (pred_pose, show_pred_pose, show_pred_keypoints, show_pred_bbox, "MYC", "green"),
            (temp_pose, show_temp_pose, show_temp_keypoints, show_temp_bbox, "RCA", "blue"),
        ):
            if pose is None:
                continue
            if show_p and "ori" in pose and "pos" in pose:
                image = self.draw_arrow(image, pose, color=arrow)
            if show_k and "keypoints" in pose:
                image = self.draw_keypoints(image, pose["keypoints"], color=col)
            if show_b and "bbox" in pose:
                image = self.draw_bbox(image, pose["bbox"], color=col)

        if self.resolution is not None:
            image = resize_linear(image, self.resolution)
        return image
