"""Keypoint projection and PnP decoding — batched PyTorch.

Counterpart of ``spef_tpu.codec.keypoints``: the 11 Tango keypoints, their
projection through the camera (with Brown distortion), the normalized
label vector and its box, and the batched decode of predicted keypoints
through EPnP or RANSAC (:mod:`spef_tpu_torch.codec.epnp`), with the
border gate.  This module owns :data:`TANGO_3D_KEYPOINTS` for the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from spef_tpu_torch.codec.epnp import RANSAC_SUBSETS, epnp_ransac, epnp_solve_batch, exact_f32
from spef_tpu_torch.data.camera import Camera
from spef_tpu_torch.pose.rotations import dcm2quat, quat2dcm

__all__ = ["TANGO_3D_KEYPOINTS", "TANGO_AXES", "TANGO_SUBSET_AXES", "KeyPoints"]

# 11 Tango keypoints [m], rows = points, cols = (x, y, z): the SPNv2
# tangoPoints asset of the reference.
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


# The principal axes (rows, by descending spread) of the Tango points and of
# each of RANSAC's 16 subsets (``codec.epnp.RANSAC_SUBSETS``), with the signs
# JAX's ``eigh`` gives them (LAPACK on the CPU): the directions of
# ``spef_tpu.codec.epnp._choose_control_points``'s control points.  EPnP's
# beta approximations depend on which way each axis points, so on noisy
# keypoints the sign is part of the answer (a third of the test frames move
# by more than 1 deg with one axis flipped, in float64 too); ``eigh`` leaves
# it to the library, so the solver aligns its axes with these
# (tests/test_torch_epnp.py holds them against JAX).
TANGO_AXES = np.array(
    ((-0.761639, 0.647987, -0.004308),
     (0.647794, 0.761547, 0.020227),
     (-0.016388, -0.012615, 0.999786)),
    dtype=np.float32,
)
TANGO_SUBSET_AXES = np.array(
    (
        ((-0.425174, 0.903487, 0.054204),
         (0.898019, 0.413602, 0.149986),
         (-0.113091, -0.112447, 0.987201)),
        ((-0.854123, 0.510657, -0.098508),
         (0.517511, 0.853305, -0.063660),
         (-0.051549, 0.105352, 0.993098)),
        ((-0.668887, 0.743354, -0.003818),
         (0.739594, 0.664969, -0.104004),
         (0.074773, 0.072391, 0.994570)),
        ((-0.686500, 0.718068, 0.114436),
         (0.726490, 0.683948, 0.066545),
         (0.030485, -0.128819, 0.991199)),
        ((-0.945263, -0.294695, -0.140117),
         (-0.325433, 0.882833, 0.338672),
         (-0.023895, -0.365733, 0.930413)),
        ((-0.842492, 0.537525, 0.035703),
         (0.536239, 0.830444, 0.151032),
         (-0.051534, -0.146388, 0.987884)),
        ((-0.732584, -0.668856, 0.126302),
         (-0.680467, 0.715031, -0.160297),
         (-0.016905, 0.203375, 0.978955)),
        ((-0.483724, -0.875037, -0.017891),
         (-0.871281, 0.483384, -0.084912),
         (-0.082950, 0.025486, 0.996228)),
        ((-0.902672, 0.390142, 0.181585),
         (-0.368731, -0.918775, 0.141032),
         (0.221858, 0.060350, 0.973210)),
        ((-0.813222, -0.581951, 0.001536),
         (-0.581951, 0.813224, 0.000500),
         (0.001540, 0.000487, 0.999999)),
        ((-0.769852, 0.638222, -0.001158),
         (0.636498, 0.767636, -0.074866),
         (0.046892, 0.058373, 0.997193)),
        ((-0.794968, 0.606024, 0.027588),
         (0.556589, 0.746700, -0.364208),
         (0.241319, 0.274179, 0.930909)),
        ((-0.850830, -0.525126, 0.018208),
         (-0.525225, 0.848973, -0.058162),
         (-0.015084, 0.059049, 0.998141)),
        ((-0.910460, 0.407002, -0.073570),
         (0.403969, 0.913241, 0.052921),
         (0.088726, 0.018462, -0.995885)),
        ((-0.627656, 0.777182, 0.045127),
         (0.773902, 0.629192, -0.072068),
         (0.084404, 0.010310, 0.996378)),
        ((-0.681437, 0.728278, 0.072488),
         (0.731838, 0.677030, 0.077738),
         (-0.007538, -0.106023, 0.994335)),
    ),
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class KeyPoints:
    """Keypoint utilities bound to a camera.

    The label vector is ``[x0, y0, x1, y1, ...]`` normalized by the image
    size, point 0 being the spacecraft frame's origin prepended to the 11
    keypoints: 12 points, 24 values.
    """

    camera: Camera
    keypoints3d: torch.Tensor  # (N, 3) float32, the 11 Tango points (no origin)
    K: torch.Tensor  # (3, 3) float32 intrinsics
    dist: Optional[torch.Tensor]  # (5,) float32 Brown coefficients, or None
    scale: torch.Tensor  # (2,) float32 image size (nu, nv)
    subsets: torch.Tensor  # (16, 6) RANSAC's subset table (RANSAC_SUBSETS), int64
    # The control frames' axis signs (TANGO_AXES / TANGO_SUBSET_AXES) for the
    # Tango points; None for other points (the library's signs).
    axes: Optional[torch.Tensor] = None
    subset_axes: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, camera: Camera, keypoints3d: Optional[np.ndarray] = None,
               device: Union[str, torch.device] = "cuda") -> "KeyPoints":
        """The camera's constants go to ``device`` once, here."""
        tango = keypoints3d is None
        pts = TANGO_3D_KEYPOINTS if tango else np.asarray(keypoints3d, np.float32)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return cls(camera=camera, keypoints3d=f32(pts), K=f32(camera.K),
                   dist=None if camera.dist_coeffs is None else f32(camera.dist_coeffs),
                   scale=f32([camera.nu, camera.nv]),
                   subsets=torch.tensor(RANSAC_SUBSETS, device=device),
                   axes=f32(TANGO_AXES) if tango else None,
                   subset_axes=f32(TANGO_SUBSET_AXES) if tango else None)

    def project(self, ori: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``ori`` (..., 4), ``pos`` (..., 3) -> pixels (..., N+1, 2) of the
        origin and the keypoints, Brown-distorted where the camera has
        coefficients."""
        pts = torch.cat([torch.zeros_like(self.keypoints3d[:1]), self.keypoints3d])
        pts = pts.to(device=ori.device)
        xyz = torch.einsum("...ij,mj->...mi", quat2dcm(ori), pts) + pos[..., None, :]
        x0 = xyz[..., 0] / xyz[..., 2]
        y0 = xyz[..., 1] / xyz[..., 2]
        dist = self.camera.dist_coeffs
        if dist is not None:
            k1, k2, p1, p2, k3 = dist
            r2 = x0 * x0 + y0 * y0
            cdist = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            x = x0 * cdist + p1 * 2 * x0 * y0 + p2 * (r2 + 2 * x0 * x0)
            y = y0 * cdist + p1 * (r2 + 2 * y0 * y0) + p2 * 2 * x0 * y0
        else:
            x, y = x0, y0
        K = self.K.to(x.device)
        return torch.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], dim=-1)

    def create_keypoints2d(self, ori: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Normalized (0-1) label vector ``(..., 2 * (N+1))``."""
        uv = self.project(ori, pos) / self.scale.to(ori.device)
        return uv.reshape(*uv.shape[:-2], -1).float()

    def decode_batch(self, keypoints2d: torch.Tensor, ransac: bool = False,
                     border_gate: Optional[float] = None, min_gated_points: int = 6
                     ) -> Dict[str, torch.Tensor]:
        """Normalized keypoints (B, 2 * (N+1)), origin first (dropped) ->
        ``{'ori': (B, 4), 'pos': (B, 3)}`` by EPnP, or RANSAC with ``ransac``.

        ``border_gate``: predictions within this normalized margin of the
        frame's border (border-saturated, i.e. off-frame keypoints) get
        weight 0 in the solve; a frame left with fewer than
        ``min_gated_points`` points is solved on all of them.
        """
        exact_f32()
        kp = torch.atleast_2d(keypoints2d)
        uv = kp.reshape(kp.shape[0], -1, 2)
        dev = uv.device
        uv_px = (uv * self.scale.to(dev))[:, 1:, :]  # drop the origin point
        weights = None
        if border_gate is not None:
            m = float(border_gate)
            xy = uv[:, 1:, :]
            w = ((xy > m) & (xy < 1.0 - m)).all(dim=-1).float()
            enough = w.sum(dim=-1, keepdim=True) >= min_gated_points
            weights = torch.where(enough, w, torch.ones_like(w))
        K, pts3d = self.K.to(dev), self.keypoints3d.to(dev)
        dist = None if self.dist is None else self.dist.to(dev)
        axes = None if self.axes is None else self.axes.to(dev)
        if ransac:
            subset_axes = None if self.subset_axes is None else self.subset_axes.to(dev)
            r, t, _ = epnp_ransac(pts3d, uv_px, K, dist, subsets=self.subsets.to(dev),
                                  weights=weights, axes=axes, subset_axes=subset_axes)
        else:
            r, t = epnp_solve_batch(pts3d, uv_px, K, dist, weights=weights, axes=axes)
        return {"ori": dcm2quat(r).float(), "pos": t.float()}

    def create_bbox_from_keypoints(self, keypoints2d: torch.Tensor) -> torch.Tensor:
        """Normalized box ``[x_min, y_min, x_max, y_max]`` of a label vector."""
        kp = keypoints2d.reshape(*keypoints2d.shape[:-1], -1, 2)
        x, y = kp[..., 0], kp[..., 1]
        return torch.stack([x.amin(dim=-1), y.amin(dim=-1), x.amax(dim=-1), y.amax(dim=-1)],
                           dim=-1)
