"""Epoch checkpoints and the durable best model.

Counterpart of ``spef_tpu.train.checkpoint.CheckpointManager``, with its
API (``save``, ``latest_epoch``, ``save_best``, ``restore``, keeping the
newest ``max_to_keep`` epochs):

  * an epoch's checkpoint is ``ckpt_<epoch>.pt``, a ``torch.save`` of the
    model's state dict, the optimizer's state dict (its learning rate
    included) and the step, beside ``meta_<epoch>.json`` (the trainer's
    bookkeeping: epoch, best value, best epoch);
  * the best model is ``best_model.msgpack`` in flax's format (``params`` +
    ``batch_stats``), written by the port's own writer at every
    improvement, so that it survives a preemption and loads in either
    package.

Resuming from a JAX orbax directory is not a goal: the two packages'
optimizer states have different trees.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from spef_tpu_torch.models.flax_msgpack import write_flax_msgpack

__all__ = ["CheckpointManager"]

BEST_FILE = "best_model.msgpack"
_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-granular checkpoints of a ``TrainState`` + trainer bookkeeping."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.pt")

    def epochs(self):
        """The epochs with a checkpoint on disk, in order."""
        found = (_CKPT.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, state, meta: Optional[Dict[str, Any]] = None) -> None:
        """Write the epoch's checkpoint (atomically) and its meta JSON; drop
        the checkpoints older than the newest ``max_to_keep``."""
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(), "step": state.step}
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        if meta is not None:
            with open(os.path.join(self.directory, f"meta_{epoch}.json"), "w") as f:
                json.dump(meta, f, default=float)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save_best(self, variables: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> str:
        """Write the best-so-far model (a flax variable tree, as
        ``models.wrapper.flax_variables`` gives it) as ``best_model.msgpack``."""
        path = os.path.join(self.directory, BEST_FILE)
        tmp = path + ".tmp"
        write_flax_msgpack(tmp, {"params": variables["params"],
                                 "batch_stats": variables.get("batch_stats", {})})
        os.replace(tmp, path)
        if meta is not None:
            with open(os.path.join(self.directory, "best_meta.json"), "w") as f:
                json.dump(meta, f, default=float)
        return path

    def restore(self, state, epoch: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        """Load an epoch's checkpoint (the latest by default) into ``state``'s
        model and optimizer, on the model's device; returns (state, meta)."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        # A checkpoint this project wrote: tensors, numbers and dicts only.
        payload = torch.load(self._path(epoch), map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        meta: Dict[str, Any] = {"epoch": epoch}
        meta_path = os.path.join(self.directory, f"meta_{epoch}.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta.update(json.load(f))
        return state, meta
