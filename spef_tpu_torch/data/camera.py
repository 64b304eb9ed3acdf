"""Camera intrinsics for the supported datasets.

Counterparts of the per-dataset ``Camera`` classes in the reference:
SPEED (`src/data/datasets/speed.py:18-32`), SPEED+ with Brown distortion
coefficients (`src/data/datasets/speed_plus.py:18-38`), and D-SPEED
(`src/data/datasets/dspeed.py:18-31`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Camera", "SPEED_CAMERA", "SPEED_PLUS_CAMERA", "DSPEED_CAMERA", "load_camera"]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with optional Brown distortion coefficients."""

    fx: float  # focal length [m]
    fy: float  # focal length [m]
    nu: int  # horizontal pixels
    nv: int  # vertical pixels
    ppx: float  # pixel pitch [m/pixel]
    ppy: float
    dist_coeffs: Optional[Tuple[float, ...]] = None  # (k1, k2, p1, p2, k3)

    @property
    def fpx(self) -> float:
        return self.fx / self.ppx

    @property
    def fpy(self) -> float:
        return self.fy / self.ppy

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.fpx, 0.0, self.nu / 2],
                [0.0, self.fpy, self.nv / 2],
                [0.0, 0.0, 1.0],
            ]
        )

    # Alias used by OpenCV-style call sites (reference uses camera.distCoeffs).
    @property
    def distCoeffs(self):  # noqa: N802 - reference-compat name
        return None if self.dist_coeffs is None else np.asarray(self.dist_coeffs)


SPEED_CAMERA = Camera(fx=0.0176, fy=0.0176, nu=1920, nv=1200, ppx=5.86e-6, ppy=5.86e-6)

SPEED_PLUS_CAMERA = Camera(
    fx=0.017513075965995915,
    fy=0.017511673079277208,
    nu=1920,
    nv=1200,
    ppx=5.86e-6,
    ppy=5.86e-6,
    dist_coeffs=(
        -0.22383016606510672,
        0.51409797089106379,
        -0.00066499611998340662,
        -0.00021404771667484594,
        -0.13124227429077406,
    ),
)

DSPEED_CAMERA = Camera(fx=0.0176, fy=0.0176, nu=1920, nv=1200, ppx=5.86e-6, ppy=5.86e-6)


def load_camera(dataset: str) -> Camera:
    """Camera lookup by dataset name/path (reference: `import_dataset.py:60-84`).

    Extensions over the reference: a ``camera.json`` file in the dataset
    root overrides the registry (SPEED+ ships one); unknown dataset names
    fall back to the SPEED/D-SPEED intrinsics with a warning instead of
    failing (synthetic/custom datasets use the same camera).
    """
    import json
    import os
    import warnings

    for root in (dataset, os.path.dirname(dataset.rstrip("/"))):
        cam_file = os.path.join(root, "camera.json")
        if os.path.isfile(cam_file):
            with open(cam_file) as f:
                c = json.load(f)
            dist = c.get("dist_coeffs", c.get("distCoeffs"))
            return Camera(
                fx=c["fx"], fy=c["fy"],
                nu=c.get("Nu", c.get("nu")),
                nv=c.get("Nv", c.get("nv")),
                ppx=c.get("ppx", 5.86e-6), ppy=c.get("ppy", 5.86e-6),
                dist_coeffs=tuple(dist) if dist else None,
            )

    name = dataset.rstrip("/").split("/")[-1].lower()
    if "dspeed" in dataset.lower():
        return DSPEED_CAMERA
    if name == "speed_plus":
        return SPEED_PLUS_CAMERA
    if name == "speed":
        return SPEED_CAMERA
    warnings.warn(
        f"Dataset {dataset}: unknown camera; falling back to the SPEED/D-SPEED intrinsics"
    )
    return DSPEED_CAMERA
