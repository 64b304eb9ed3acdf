"""ESA pose-estimation scoring — batched PyTorch.

Counterpart of ``spef_tpu.pose.score``.  The score is

    ESA score = mean orientation error (rad) + mean normalized position error

with orientation error ``2 * arccos(|<q_pred, q_true>|)``, in float32 as the
JAX package computes it: ``2 * arccos`` near 1 moves with the precision.

A dot product above 1 is clipped to 1; above 1.01 it is a broken
prediction, counted as ``invalid``, and :func:`get_score` raises
``ValueError`` on it, as the reference does.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["pose_errors", "score_batch", "get_score"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def pose_errors(ori_true, pos_true, ori_pred, pos_pred) -> Dict[str, torch.Tensor]:
    """Per-sample errors (no reduction) of ``(B, ...)`` inputs: ``pos_error``
    (m), ``norm_pos_error``, ``ori_error`` (rad) and the count of
    ``invalid`` orientation dot products (> 1.01)."""
    ori_true, pos_true, ori_pred, pos_pred = map(_f32, (ori_true, pos_true, ori_pred, pos_pred))
    pos_error = torch.linalg.vector_norm(pos_true - pos_pred, dim=-1)
    norm_pos_error = pos_error / torch.linalg.vector_norm(pos_true, dim=-1)
    inter_sum = torch.abs(torch.sum(ori_pred * ori_true, dim=-1))
    invalid = torch.sum(inter_sum > 1.01)
    inter_sum = torch.clamp(inter_sum, max=1.0)
    ori_error = 2.0 * torch.arccos(inter_sum)
    return {
        "pos_error": pos_error,
        "norm_pos_error": norm_pos_error,
        "ori_error": ori_error,
        "invalid": invalid,
    }


def score_batch(ori_true, pos_true, ori_pred, pos_pred) -> Dict[str, torch.Tensor]:
    """Batch-mean metrics: ``esa_score``, ``ori_score`` (rad), ``pos_score``
    (normalized), ``ori_error`` (deg), ``pos_error`` (m) and ``invalid``."""
    e = pose_errors(ori_true, pos_true, ori_pred, pos_pred)
    mean_ori = torch.mean(e["ori_error"])
    mean_norm_pos = torch.mean(e["norm_pos_error"])
    return {
        "esa_score": mean_ori + mean_norm_pos,
        "ori_score": mean_ori,
        "pos_score": mean_norm_pos,
        "ori_error": torch.rad2deg(mean_ori),
        "pos_error": torch.mean(e["pos_error"]),
        "invalid": e["invalid"],
    }


def get_score(true_pose: dict, pred_pose: dict) -> Dict[str, float]:
    """Host-side scoring with the reference's error semantics: raises
    ``ValueError`` when any orientation dot product exceeds 1.01."""
    metrics = score_batch(true_pose["ori"], true_pose["pos"], pred_pose["ori"], pred_pose["pos"])
    metrics = {k: float(v) for k, v in metrics.items()}
    if metrics.pop("invalid") > 0:
        raise ValueError("Intermediate sum issue due to error in model prediction (orientation)")
    return metrics
