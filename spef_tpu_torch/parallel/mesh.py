"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``spef_tpu.parallel.mesh`` (``make_mesh``, ``shard_batch``,
``replicate``).  JAX's mesh only changes where the data sits: a sharded
train step is the single-device step on the global batch, BatchNorm
statistics included.  The port keeps that meaning on one process a card:

  * every rank reads the same global batch, its loader decoding and warping
    only the rank's rows (``data/dataset.py``, ``BatchLoader.mesh``), keeps
    its rows (:func:`shard_batch`), and draws its random values for the
    global batch too (the trainer's augmentation and dropout take the rank's
    rows of them);
  * train-mode BatchNorm sums its batch moments over the ranks
    (``models/layers.py::BatchNorm`` with ``mesh``), flax's one-pass
    statistics of the global batch;
  * the activated outputs are gathered in rank order (:func:`all_gather_rows`,
    differentiable), so the loss and the metrics are those of the global
    batch, and each rank back-propagates ``loss / size``;
  * the parameter gradients are summed over the ranks
    (:func:`all_reduce_gradients`), so every rank takes the same step.

NCCL on cards, gloo on the CPU.  A mesh of size 1 (no process group) changes
nothing: every function here returns its input.  ``apps.train
--data-parallel`` runs under ``torch.distributed.run``, which sets the
environment :func:`make_mesh` reads.

Inference is sharded in one process instead, over a :class:`LocalMesh` of
the local devices (``spef_tpu/parallel/mesh.py:30-56``: ``make_mesh``,
``data_sharding``, ``replicated``): :func:`make_local_mesh` lists the
devices, :func:`data_sharding` gives each its contiguous rows of a batch,
and :func:`replicated` builds one replica of a predict function (its
weights) on each of them.  ``engine.ShardedPredict`` runs the replicas.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "all_gather_rows",
           "all_reduce_sum", "all_reduce_gradients", "LocalMesh", "make_local_mesh",
           "mesh_or_device", "data_sharding", "replicated", "on_device"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a 1-D data-parallel mesh of ``size`` ranks."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``."""
        if n_global % self.size:
            raise ValueError(f"batch size {n_global} must divide over the {self.size}-rank mesh")
        n = n_global // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(device: Union[str, torch.device] = "cuda", rank: Optional[int] = None,
              size: Optional[int] = None, init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process: ``rank`` and ``size`` default to
    ``torch.distributed.run``'s ``RANK`` and ``WORLD_SIZE`` (size 1 without
    them), ``init_method`` to its ``MASTER_ADDR`` / ``MASTER_PORT``.  Above
    size 1 it joins the process group (NCCL on cards, each rank on the card
    ``LOCAL_RANK``; gloo on the CPU)."""
    import torch.distributed as dist

    size = int(os.environ.get("WORLD_SIZE", "1")) if size is None else size
    device = torch.device(device)
    if size == 1:
        return Mesh(0, 1, device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method or "env://", rank=rank, world_size=size)
    return Mesh(rank, size, device)


def shard_batch(mesh: Optional[Mesh], batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch."""
    if mesh is None or mesh.size == 1:
        return batch
    rows = mesh.rows(len(batch["mask"]))
    return {k: v[rows] for k, v in batch.items()}


def replicate(mesh: Optional[Mesh], module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank."""
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients.
    (``torch.distributed.nn.functional.all_reduce`` is the same, deprecated
    since torch 2.13 for a private module.)"""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (differentiable)."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x``: every rank's rows, in rank order
    (differentiable): the sum over the ranks of each rank's rows set in
    zeros, so the gradient of this rank's rows is the sum over the ranks of
    their gradients of them."""
    if mesh is None or mesh.size == 1:
        return x
    zeros = torch.zeros_like(x)
    parts = [x if r == mesh.rank else zeros for r in range(mesh.size)]
    return all_reduce_sum(mesh, torch.cat(parts))


def all_reduce_gradients(mesh: Optional[Mesh], module: nn.Module) -> None:
    """Sum every parameter gradient over the ranks, as one flat buffer."""
    if mesh is None or mesh.size == 1:
        return
    import torch.distributed as dist

    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()



# ---------------------------------------------------------------------------
# Inference over the local devices, in one process
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A 1-D mesh of local devices, JAX's ``Mesh`` over ``jax.devices()``:
    the cards of this host, or CPU replicas (the counterpart of the virtual
    CPU devices JAX's tests run on)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_local_mesh(device: Union[str, torch.device] = "cuda",
                    n_devices: Optional[int] = None) -> LocalMesh:
    """Every visible card (``"cuda"``), or the first ``n_devices`` of them;
    one named card (``"cuda:K"``); ``n_devices`` CPU replicas (``"cpu"``,
    one by default).  Raises where fewer than ``n_devices`` cards are
    visible, as JAX's ``make_mesh`` asserts."""
    device = torch.device(device)
    if device.index is not None:
        if n_devices not in (None, 1):
            raise ValueError(f"{device} names one device, not {n_devices}")
        return LocalMesh((device,))
    if device.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise ValueError(f"need {n_devices or 'a'} CUDA device(s), have {have}")
        return LocalMesh(tuple(torch.device("cuda", i) for i in range(n)))
    if device.type == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"need at least one CPU replica, got {n}")
        return LocalMesh((device,) * n)
    raise ValueError(f"no local mesh of {device.type} devices")


def mesh_or_device(mesh: Optional[LocalMesh],
                   device: Union[str, torch.device]) -> LocalMesh:
    """``mesh``, or without one the one-device mesh of ``device``."""
    return mesh if mesh is not None else LocalMesh((torch.device(device),))


def data_sharding(mesh: LocalMesh, n_rows: int) -> List[slice]:
    """Each device's contiguous rows of a batch of ``n_rows``, in device
    order.  The rows must divide over the mesh, as JAX's batch sharding
    requires."""
    if n_rows % mesh.size:
        raise ValueError(f"a window of {n_rows} rows does not divide over the "
                         f"{mesh.size}-device mesh")
    n = n_rows // mesh.size
    return [slice(i * n, (i + 1) * n) for i in range(mesh.size)]


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing to
    do for a CPU device)."""
    import contextlib

    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def replicated(mesh: LocalMesh, build: Callable[[torch.device], Any]) -> List[Any]:
    """One replica a device: ``build(device)``, called with that device
    current."""
    replicas = []
    for device in mesh.devices:
        with on_device(device):
            replicas.append(build(device))
    return replicas
