"""Pose-estimation losses — PyTorch, differentiable.

Counterpart of ``spef_tpu.train.loss``, with its two quirks:

  * :func:`pos_reg_loss` takes the *Frobenius* norm over the whole batch
    matrix (no ``dim``), optionally divided by the Frobenius norm of the
    target batch;
  * :func:`ori_reg_loss` zeroes dot products above 1 before ``arccos``
    (the scoring path clips them to 1 instead).

The losses do not raise on NaN: the trainer checks the loss on the host
when it flushes its metrics (``train/trainer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

MODES = ("regression", "classification", "keypoints")

__all__ = ["pos_reg_loss", "ori_reg_loss", "soft_class_loss", "keypoints_loss", "SPELoss"]


def pos_reg_loss(pred: torch.Tensor, target: torch.Tensor,
                 norm_distance: bool = True) -> torch.Tensor:
    """Position regression loss: Frobenius norm over the batch."""
    loss = torch.linalg.norm(pred - target)
    if norm_distance:
        loss = loss / torch.linalg.norm(target)
    return loss


def ori_reg_loss(pred: torch.Tensor, target: torch.Tensor, target_pos: torch.Tensor = None,
                 norm_distance: bool = True) -> torch.Tensor:
    """Orientation regression loss: arccos of |q_pred . q_true|, a dot
    product above 1 zeroed first."""
    inter_sum = torch.abs(torch.sum(pred * target, dim=-1, keepdim=True))
    inter_sum = torch.where(inter_sum > 1.0, torch.zeros_like(inter_sum), inter_sum)
    loss = torch.arccos(inter_sum)
    if norm_distance:
        loss = loss / torch.linalg.vector_norm(target_pos, dim=-1, keepdim=True)
    return torch.mean(loss)


def soft_class_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Cross-entropy with soft targets; ``pred`` is already a softmax."""
    return torch.mean(torch.sum(-(target * torch.log(pred + eps)), dim=-1))


def keypoints_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE keypoint loss."""
    return torch.mean((pred - target) ** 2)


@dataclasses.dataclass(frozen=True)
class SPELoss:
    """Dispatching loss: total = beta * ori + pos."""

    ori_mode: str
    pos_mode: str
    beta: float = 1.0
    norm_distance: bool = True

    def __post_init__(self):
        if self.ori_mode not in MODES or self.pos_mode not in MODES:
            raise ValueError(f"modes must be in {MODES}, got {self.ori_mode!r}, "
                             f"{self.pos_mode!r}")

    def compute_loss(self, prediction: Dict[str, torch.Tensor],
                     target: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.ori_mode == "keypoints" and self.pos_mode == "keypoints":
            return keypoints_loss(prediction["keypoints"], target["keypoints"])
        if self.ori_mode == "regression":
            ori = ori_reg_loss(prediction["ori"], target["ori"], target["pos"],
                               self.norm_distance)
        else:
            ori = soft_class_loss(prediction["ori_soft"], target["ori_soft"])
        if self.pos_mode == "regression":
            pos = pos_reg_loss(prediction["pos"], target["pos"], self.norm_distance)
        else:
            pos = soft_class_loss(prediction["pos_soft"], target["pos_soft"])
        return self.beta * ori + pos

    __call__ = compute_loss
