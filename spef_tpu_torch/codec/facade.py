"""SPEUtils facade: final activations, decoding, target encoding and scoring
(PyTorch).

Counterpart of ``spef_tpu.codec.facade``: the ``regression``,
``classification`` and ``keypoints`` modes.  In the keypoints mode the last
activation is the sigmoid and the decode is EPnP, or RANSAC
(``keypoints_ransac``), with the optional border gate
(``codec/keypoints.py``).

The keypoint helper is built where a mode is ``keypoints`` or where
``use_keypoints=True`` asks for it (the JAX ``create`` builds it unless
told not to); with it, ``encode_targets`` adds the ``keypoints`` and
``bbox`` targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from spef_tpu_torch.codec.keypoints import KeyPoints
from spef_tpu_torch.codec.softclass import (
    OrientationSoftClassification,
    PositionSoftClassification,
)
from spef_tpu_torch.data.camera import Camera
from spef_tpu_torch.pose import score as score_lib

MODES = ("regression", "classification", "keypoints")

__all__ = ["SPEUtils", "MODES"]


@dataclasses.dataclass(frozen=True)
class SPEUtils:
    """Spacecraft Pose Estimation utils facade."""

    camera: Camera
    ori_mode: str
    pos_mode: str
    orientation: OrientationSoftClassification
    position: PositionSoftClassification
    keypoints: Optional[KeyPoints] = None
    # RANSAC PnP for the keypoints-mode decode.
    keypoints_ransac: bool = False
    # Border-saturation gate (normalized margin) of the keypoints-mode decode.
    keypoints_border_gate: Optional[float] = None

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
        use_keypoints: Optional[bool] = None,
        keypoints_ransac: bool = False,
        keypoints_border_gate: Optional[float] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "SPEUtils":
        if ori_mode not in MODES or pos_mode not in MODES:
            raise ValueError(f"modes must be in {MODES}, got {ori_mode!r}, {pos_mode!r}")
        keypoints_mode = "keypoints" in (ori_mode, pos_mode)
        if use_keypoints is False and keypoints_mode:
            raise ValueError("keypoints mode requires keypoint support")
        use_keypoints = keypoints_mode if use_keypoints is None else use_keypoints
        return cls(
            camera=camera,
            ori_mode=ori_mode,
            pos_mode=pos_mode,
            orientation=OrientationSoftClassification.create(
                n_ori_bins_per_dim, ori_smooth_factor, ori_delete_unused_bins, device=device),
            # Position limits carry a 5 m margin (the create defaults).
            position=PositionSoftClassification.create(
                n_pos_bins_per_dim, pos_smooth_factor, device=device),
            keypoints=KeyPoints.create(camera, device=device) if use_keypoints else None,
            keypoints_ransac=keypoints_ransac,
            keypoints_border_gate=keypoints_border_gate,
        )

    @classmethod
    def from_config(cls, cfg, camera: Camera, device: Union[str, torch.device] = "cuda",
                    keypoints_ransac: bool = False,
                    keypoints_border_gate: Optional[float] = None) -> "SPEUtils":
        """The facade an experiment config (``MODEL.HEAD``, ``DATA``) describes,
        with the keypoints-mode decode options."""
        return cls.create(
            camera,
            ori_mode=cfg.MODEL.HEAD.ORI,
            n_ori_bins_per_dim=cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM,
            ori_smooth_factor=cfg.DATA.ORI_SMOOTH_FACTOR,
            ori_delete_unused_bins=cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS,
            pos_mode=cfg.MODEL.HEAD.POS,
            n_pos_bins_per_dim=cfg.MODEL.HEAD.N_POS_BINS_PER_DIM,
            pos_smooth_factor=cfg.DATA.POS_SMOOTH_FACTOR,
            keypoints_ransac=keypoints_ransac,
            keypoints_border_gate=keypoints_border_gate,
            device=device,
        )

    @property
    def keypoints_mode(self) -> bool:
        return self.ori_mode == "keypoints" and self.pos_mode == "keypoints"

    def last_activ(self, pose: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pose = dict(pose)
        if self.keypoints_mode:
            pose["keypoints"] = torch.sigmoid(pose["keypoints"])
            return pose
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
        if self.keypoints_mode:
            pose.update(self.keypoints.decode_batch(
                pose["keypoints"], ransac=self.keypoints_ransac,
                border_gate=self.keypoints_border_gate))
            return pose
        if self.ori_mode == "classification":
            pose["ori"], _ = self.orientation.decode(pose["ori_soft"])
        if self.pos_mode == "classification":
            pose["pos"] = self.position.decode(pose["pos_soft"])
        return pose

    def encode_targets(self, ori: torch.Tensor, pos: torch.Tensor,
                       crop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Training targets of a batch: the pose, its soft-class PDFs in the
        classification modes and, with the keypoint helper, the keypoint
        label vector and its box, in the crop-local coordinates of the
        per-sample ``crop`` windows ``[cx, cy, s]`` where they are given."""
        target: Dict[str, torch.Tensor] = {"ori": ori, "pos": pos}
        if self.keypoints is not None:
            kp2d = self.keypoints.create_keypoints2d(ori, pos)
            if crop is not None:
                from spef_tpu_torch.codec.crop import map_keypoints_to_crop

                kp2d = map_keypoints_to_crop(kp2d, crop)
            target["keypoints"] = kp2d
            target["bbox"] = self.keypoints.create_bbox_from_keypoints(kp2d)
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
