"""Train / eval steps — PyTorch, eager.

Counterpart of ``spef_tpu.train.step``: forward in train mode, the last
activation, the loss, ``backward``, the optimizer step and, with
``clip_batchnorm``, every BatchNorm scale clamped to [0, 1] (a FINN
constraint kept for QAT).  The JAX step is one jitted program over a
pytree state; here the state is the model and its optimizer, updated in
place.

The float models keep their ``compute_dtype``: bf16 convolutions with
float32 parameters (their gradients are float32) and float32 BatchNorm, as
in JAX.  No autocast and no loss scaling: bf16 has float32's 8-bit
exponent, so gradients that fp16 would flush to zero stay representable,
which is why the JAX package needs no scaler either.

With a data-parallel ``mesh`` of more than one rank (``parallel/mesh.py``)
the step is the single-device step on the global batch: ``images`` are this
rank's rows, ``targets`` the global batch's; the activated outputs are
gathered over the ranks before the loss, each rank back-propagates
``loss / size`` and the gradients are summed over the ranks before the
optimizer step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.models.layers import BatchNorm, set_dropout_generator
from spef_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_gradients
from spef_tpu_torch.train.loss import SPELoss
from spef_tpu_torch.utils import profiling

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "train_update"]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the host
    scheduler and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       scheduler: Any = None) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def _apply_last_activation(spe_utils: SPEUtils, pred) -> Dict[str, torch.Tensor]:
    """The final activation of the two raw outputs, by mode."""
    if spe_utils.ori_mode == "keypoints" and spe_utils.pos_mode == "keypoints":
        out = pred[0] if isinstance(pred, tuple) else pred
        return {"keypoints": torch.sigmoid(out)}
    pose: Dict[str, torch.Tensor] = {}
    if spe_utils.ori_mode == "regression":
        pose["ori"] = pred[0] / torch.linalg.vector_norm(pred[0], dim=-1, keepdim=True)
    else:
        pose["ori_soft"] = torch.softmax(pred[0], dim=-1)
    if spe_utils.pos_mode == "classification":
        pose["pos_soft"] = torch.softmax(pred[1], dim=-1)
    else:
        pose["pos"] = pred[1]
    return pose


def _clamp_batchnorm_scales(model: nn.Module) -> None:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.clamp_(0.0, 1.0)


def train_update(state: TrainState, images: torch.Tensor, targets: Dict[str, torch.Tensor],
                 spe_utils: SPEUtils, spe_loss: SPELoss, generator: torch.Generator,
                 clip_batchnorm: bool = False, mesh: Optional[Mesh] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer step on a batch of float NHWC images in [0, 1];
    dropout masks from ``generator``.  Returns the loss and the activated
    pose of the train-mode forward (of the global batch under a ``mesh``),
    detached, on the device.  Under a ``mesh`` the model's BatchNorm and
    Dropout layers must hold it (``models.layers.set_data_parallel``).
    While a profiler runs, its four stages are spans ``spef.train.forward``
    (the model and the last activation), ``.loss``, ``.backward``
    (``zero_grad``, ``backward`` and the gradients' all-reduce) and
    ``.optimizer`` (the step and the BatchNorm clamp)."""
    model = state.model
    size = 1 if mesh is None else mesh.size
    with profiling.span("train.forward"):
        model.train()
        set_dropout_generator(model, generator)
        pose = _apply_last_activation(spe_utils, model(images))
        if size > 1:
            pose = {k: all_gather_rows(mesh, v) for k, v in pose.items()}
    with profiling.span("train.loss"):
        loss = spe_loss.compute_loss(pose, targets)
    with profiling.span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        (loss / size if size > 1 else loss).backward()
        all_reduce_gradients(mesh, model)
    with profiling.span("train.optimizer"):
        state.optimizer.step()
        if clip_batchnorm:
            _clamp_batchnorm_scales(model)
    state.step += 1
    return loss.detach(), {k: v.detach() for k, v in pose.items()}


def make_train_step(
    spe_utils: SPEUtils,
    spe_loss: SPELoss,
    clip_batchnorm: bool = False,
    compute_metrics: bool = True,
) -> Callable:
    """``step(state, images, targets, generator) -> (state, metrics)``;
    ``targets`` already hold the encoded soft targets
    (``SPEUtils.encode_targets``); the metrics are 0-d device tensors."""

    def train_step(state: TrainState, images, targets, generator):
        loss, pose = train_update(state, images, targets, spe_utils, spe_loss, generator,
                                  clip_batchnorm)
        metrics = {"loss": loss}
        if compute_metrics:
            with torch.no_grad():
                metrics.update(spe_utils.score_batch(targets, spe_utils.decode(pose)))
        return state, metrics

    return train_step


def make_eval_step(spe_utils: SPEUtils, spe_loss: Optional[SPELoss] = None) -> Callable:
    """``step(state, images, targets) -> (metrics, decoded)``: the forward in
    eval mode, activation, decode and score."""

    def eval_step(state: TrainState, images, targets):
        state.model.eval()
        with torch.no_grad():
            pose = _apply_last_activation(spe_utils, state.model(images))
            metrics = {}
            if spe_loss is not None:
                metrics["loss"] = spe_loss.compute_loss(pose, targets)
            decoded = spe_utils.decode(pose)
            metrics.update(spe_utils.score_batch(targets, decoded))
        return metrics, decoded

    return eval_step
