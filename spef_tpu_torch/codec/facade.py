"""SPEUtils facade: final activations, decoding, target encoding and scoring
(PyTorch).

Counterpart of ``spef_tpu.codec.facade`` for the ``regression`` and
``classification`` modes.  The keypoints mode (EPnP decode) is in ROADMAP
§A (keypoints family) and raises ``NotImplementedError`` until that slice lands.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from spef_tpu_torch.codec.softclass import (
    OrientationSoftClassification,
    PositionSoftClassification,
)
from spef_tpu_torch.data.camera import Camera
from spef_tpu_torch.pose import score as score_lib

MODES = ("regression", "classification", "keypoints")

__all__ = ["SPEUtils", "MODES"]

_KEYPOINTS_TODO = ("keypoints mode is not ported yet (ROADMAP §A, keypoints family: "
                   "codec/epnp.py, codec/keypoints.py, codec/crop.py)")


@dataclasses.dataclass(frozen=True)
class SPEUtils:
    """Spacecraft Pose Estimation utils facade."""

    camera: Camera
    ori_mode: str
    pos_mode: str
    orientation: OrientationSoftClassification
    position: PositionSoftClassification

    @classmethod
    def create(
        cls,
        camera: Camera,
        ori_mode: str = "regression",
        n_ori_bins_per_dim: int = 12,
        ori_smooth_factor: float = 3,
        ori_delete_unused_bins: bool = True,
        pos_mode: str = "regression",
        n_pos_bins_per_dim: int = 10,
        pos_smooth_factor: float = 100,
        device: Union[str, torch.device] = "cuda",
    ) -> "SPEUtils":
        if ori_mode not in MODES or pos_mode not in MODES:
            raise ValueError(f"modes must be in {MODES}, got {ori_mode!r}, {pos_mode!r}")
        if "keypoints" in (ori_mode, pos_mode):
            raise NotImplementedError(_KEYPOINTS_TODO)
        return cls(
            camera=camera,
            ori_mode=ori_mode,
            pos_mode=pos_mode,
            orientation=OrientationSoftClassification.create(
                n_ori_bins_per_dim, ori_smooth_factor, ori_delete_unused_bins, device=device),
            # Position limits carry a 5 m margin (the create defaults).
            position=PositionSoftClassification.create(
                n_pos_bins_per_dim, pos_smooth_factor, device=device),
        )

    @classmethod
    def from_config(cls, cfg, camera: Camera, device: Union[str, torch.device] = "cuda"
                    ) -> "SPEUtils":
        """The facade an experiment config (``MODEL.HEAD``, ``DATA``) describes."""
        return cls.create(
            camera,
            ori_mode=cfg.MODEL.HEAD.ORI,
            n_ori_bins_per_dim=cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM,
            ori_smooth_factor=cfg.DATA.ORI_SMOOTH_FACTOR,
            ori_delete_unused_bins=cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS,
            pos_mode=cfg.MODEL.HEAD.POS,
            n_pos_bins_per_dim=cfg.MODEL.HEAD.N_POS_BINS_PER_DIM,
            pos_smooth_factor=cfg.DATA.POS_SMOOTH_FACTOR,
            device=device,
        )

    def last_activ(self, pose: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pose = dict(pose)
        if self.ori_mode == "regression":
            pose["ori"] = pose["ori"] / torch.linalg.vector_norm(
                pose["ori"], dim=-1, keepdim=True)
        else:
            pose["ori_soft"] = torch.softmax(pose["ori_soft"], dim=-1)
        if self.pos_mode == "classification":
            pose["pos_soft"] = torch.softmax(pose["pos_soft"], dim=-1)
        return pose

    def decode(self, pose: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pose = dict(pose)
        if self.ori_mode == "classification":
            pose["ori"], _ = self.orientation.decode(pose["ori_soft"])
        if self.pos_mode == "classification":
            pose["pos"] = self.position.decode(pose["pos_soft"])
        return pose

    def encode_targets(self, ori: torch.Tensor, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Training targets of a batch: the pose, and its soft-class PDFs in
        the classification modes.  The keypoint and box targets come with
        the keypoints family (ROADMAP §A, item 8)."""
        target: Dict[str, torch.Tensor] = {"ori": ori, "pos": pos}
        if self.ori_mode == "classification":
            target["ori_soft"] = self.orientation.encode(ori)
        if self.pos_mode == "classification":
            target["pos_soft"] = self.position.encode(pos)
        return target

    @staticmethod
    def get_score(true_pose: dict, pred_pose: dict) -> Dict[str, float]:
        return score_lib.get_score(true_pose, pred_pose)

    @staticmethod
    def score_batch(true_pose: dict, pred_pose: dict) -> Dict[str, torch.Tensor]:
        """Batch-mean metrics, no host sync and no raise (``invalid`` counts)."""
        return score_lib.score_batch(
            true_pose["ori"], true_pose["pos"], pred_pose["ori"], pred_pose["pos"])
