"""Optimizer / LR-schedule factory — ``torch.optim``.

Counterpart of ``spef_tpu.train.optimizer``: SGD with momentum or Adam,
scheduled on the host by epoch (:class:`MultiStepScheduler`, piecewise
constant, or :class:`PlateauScheduler`, ReduceLROnPlateau(min)), which
writes the learning rate into every parameter group
(:func:`set_learning_rate`) between epochs.

The updates are optax's:

  * SGD: ``optax.sgd(lr, momentum)`` keeps the trace ``buf = g + m * buf``
    from zeros, so its first step is ``buf = g``, as ``torch.optim.SGD``'s;
    ``p -= lr * buf``.
  * Adam: ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root): ``m_hat / (sqrt(v_hat) + eps)`` is ``torch.optim.Adam``'s
    ``(m / bc1) / (sqrt(v) / sqrt(bc2) + eps)``.
  * Weight decay: ``optax.add_decayed_weights(wd)`` chained before either
    adds ``wd * p`` to the gradient, an L2 term, which is torch's
    ``weight_decay`` on both optimizers (not AdamW's decoupled decay).  As
    in JAX it applies to every parameter, BatchNorm's included.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["import_optimizer", "PlateauScheduler", "MultiStepScheduler", "set_learning_rate"]


@dataclasses.dataclass
class MultiStepScheduler:
    """lr(epoch) = lr0 * gamma^(#milestones passed)."""

    base_lr: float
    milestones: Sequence[int]
    gamma: float
    lr: float = None  # type: ignore[assignment]

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        passed = sum(1 for m in self.milestones if epoch >= m)
        self.lr = self.base_lr * (self.gamma**passed)
        return self.lr


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(min): decay lr by gamma after `patience` epochs
    without improvement."""

    base_lr: float
    patience: int
    gamma: float
    best: float = float("inf")
    bad_epochs: int = 0
    lr: float = None  # type: ignore[assignment]

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        if metric is None:
            return self.lr
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = self.lr * self.gamma
                self.bad_epochs = 0
        return self.lr


def import_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float = 0.01,
    optimizer: str = "SGD",
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    scheduler: str = "MultiStepLR",
    milestones: Tuple[int, ...] = (5, 15),
    gamma: float = 0.1,
):
    """(``torch.optim.SGD`` or ``Adam`` over ``params``, host scheduler)."""
    if optimizer not in ("SGD", "Adam"):
        raise ValueError(f"optimizer must be SGD or Adam, got {optimizer!r}")
    if scheduler not in ("OnPlateau", "MultiStepLR"):
        raise ValueError(f"scheduler must be OnPlateau or MultiStepLR, got {scheduler!r}")
    if optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    if scheduler == "MultiStepLR":
        sched = MultiStepScheduler(base_lr=learning_rate, milestones=milestones, gamma=gamma)
    else:
        sched = PlateauScheduler(base_lr=learning_rate, patience=milestones[0], gamma=gamma)
    return opt, sched


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write ``lr`` into every parameter group of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
