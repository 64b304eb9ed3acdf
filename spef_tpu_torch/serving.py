"""Serving runtime: batched pose inference over the local devices.

Counterpart of ``spef_tpu.serving``:

  * :class:`PoseServer`: a fixed-size batch window (requests are zero-padded
    up to it, so every call runs the same shapes), sharded over a local
    mesh (``parallel.mesh.make_local_mesh``; JAX's server runs on every
    local chip) by rows, one replica of the predict function a device
    (``engine.ShardedPredict``: every device's forward, then one decode of
    the gathered window on the first), one device without a mesh; latency
    statistics; on ``cuda`` a page-locked (pinned) host buffer of the
    window's shape, allocated once, whose rows are copied to each card
    asynchronously;
  * :func:`serve_stream`: pipelined streaming inference over an iterator of
    frame batches, ``depth`` batches in flight (JAX's dispatch ahead, block
    late), on one device as JAX's.  On CUDA that overlap needs the
    host-to-device copy to be asynchronous, so the stream keeps a ring of
    ``depth`` pinned buffers, filled by a staging thread, and issues each
    copy on a side stream that the compute stream waits on.

On ``device="cpu"`` neither pins memory nor uses streams: that is the path
the caller asked for.  On ``cuda`` a failure to pin or to launch raises;
nothing falls back to a pageable copy, and a failure on any card of a mesh
raises: nothing runs on fewer cards.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.engine import ShardedPredict, per_device
from spef_tpu_torch.parallel.mesh import LocalMesh, data_sharding, mesh_or_device
from spef_tpu_torch.utils import profiling

__all__ = ["PoseServer", "OversizeRequest", "serve_stream"]


def _pinned(shape, dtype: np.dtype) -> torch.Tensor:
    """A page-locked host tensor; ``pin_memory`` raises where it cannot pin."""
    return torch.empty(tuple(shape), dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True)


class OversizeRequest(ValueError, AssertionError):
    """A request above the serving window: a ``ValueError``, and the
    ``AssertionError`` JAX's server raises."""


class PoseServer:
    """Batched pose-inference server over a local mesh (one device without
    one).

    ``mesh``: the window's rows are split over its devices (the window must
    divide over them), and ``predict_fn`` is then ``build(device) ->
    predict function``, built once a device, since a predict function
    closes over one device's weights; ``device`` is then the mesh's first.
    ``predict_fn`` (the :class:`engine.ShardedPredict` of the replicas) is
    a predict function on a window anywhere, its pose on ``device``.
    """

    def __init__(
        self,
        predict_fn: Callable,  # images (B, H, W, C) tensor on `device` -> pose dict
        img_shape: Tuple[int, int, int],
        max_batch: int = 256,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[LocalMesh] = None,
    ):
        self.img_shape = tuple(img_shape)
        self.max_batch = max_batch
        self.mesh = mesh
        build = per_device(predict_fn, mesh)
        mesh = mesh_or_device(mesh, device)
        data_sharding(mesh, max_batch)  # the window must divide over the mesh
        self.device = mesh.devices[0]
        self._sharded = self.predict_fn = ShardedPredict.build(mesh, build)
        self._latencies: collections.deque = collections.deque(maxlen=1000)
        # On cuda, the window's pinned staging buffer of uint8 frames.
        self._staging = (_pinned((max_batch, *self.img_shape), np.uint8)
                         if self.device.type == "cuda" else None)

    def warmup(self) -> float:
        """Run the window once (kernel builds, cuDNN plans); returns seconds."""
        shards = self._sharded.scatter(
            torch.zeros((self.max_batch, *self.img_shape), dtype=torch.uint8))
        self._sharded.synchronize()
        t0 = time.perf_counter()
        self._sharded.run(shards)
        self._sharded.synchronize()
        return time.perf_counter() - t0

    def _window(self, images: np.ndarray) -> torch.Tensor:
        """The request padded to the window, on the host.  On ``cuda``: the
        pinned buffer, the request copied in and its tail zeroed (the pad);
        each card's rows are then sent with ``non_blocking=True``, and
        ``predict`` synchronizes before the buffer is written again."""
        n = images.shape[0]
        if self._staging is None:
            if n < self.max_batch:
                pad = np.zeros((self.max_batch - n, *self.img_shape), images.dtype)
                images = np.concatenate([images, pad])
            return torch.from_numpy(np.ascontiguousarray(images))
        if images.dtype != np.uint8:
            raise TypeError(f"the pinned staging buffer holds uint8 frames, got {images.dtype}")
        host = self._staging.numpy()
        host[:n] = images
        host[n:] = 0
        return self._staging

    def predict(self, images: np.ndarray) -> Tuple[Dict[str, np.ndarray], float]:
        """Serve one request (any batch size <= max_batch): pads to the
        window, returns host numpy results and the latency in ms.  The
        latency is JAX's: the host clock from before the copy (here the
        staging copy into the pinned buffer, which also writes the pad) to
        after the results are ready on every device (the decode ran on the
        first, on the window gathered there); the request's rows are then
        copied to the host."""
        images = np.asarray(images)
        n = images.shape[0]
        if n > self.max_batch:
            raise OversizeRequest(f"batch {n} > serving window {self.max_batch}")
        t0 = time.perf_counter()
        pose = self._sharded.run(self._sharded.scatter(self._window(images)))
        self._sharded.synchronize()
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._latencies.append(latency_ms)
        return {k: v[:n].cpu().numpy() for k, v in pose.items()}, latency_ms

    def stats(self) -> Dict[str, float]:
        lat = np.asarray(self._latencies) if self._latencies else np.zeros(1)
        return {
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "mean_ms": float(lat.mean()),
            "requests": len(self._latencies),
            "devices": self._sharded.mesh.size,
        }


_END = object()  # the end of a stager's batches


class _Stager:
    """A thread that copies each host batch into the next of a ring of
    ``depth`` pinned buffers, ahead of the consumer: it writes a buffer
    again only after the event of the copy that last read it (handed back
    by :meth:`release`) has completed.  The caller's thread is free to
    dispatch the forwards meanwhile (numpy's copy releases the GIL), and it
    blocks wherever a predict function synchronizes with the card.

    While a profiler runs, the thread's work goes into spans
    ``spef.stage.{pull,slot_wait,copy}`` and, since a profiler of one
    thread does not see them, the wait for a buffer and the copy into
    counters (``stage.slot_wait``, ``stage.copy``: how many, and their
    ``_ns``; ``stage.copy_bytes``); the consumer counts a staged window's
    wait in the queue (``stage.queued``, ``stage.queued_ns``)."""

    def __init__(self, batches: Iterable[np.ndarray], depth: int):
        self._ring = [None] * depth
        self._free = [queue.Queue() for _ in range(depth)]
        for q in self._free:
            q.put(None)  # no copy has read the buffer yet
        self._filled: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _run(self, batches: Iterator[np.ndarray]) -> None:
        try:
            for i in itertools.count():
                with profiling.span("stage.pull"):
                    batch = next(batches, _END)
                if batch is _END:
                    break
                slot = i % len(self._ring)
                with profiling.timed("stage.slot_wait"):
                    copied = self._free[slot].get()
                    if self._stop.is_set():
                        return
                    if copied is not None:
                        copied.synchronize()
                batch = np.asarray(batch)
                buf = self._ring[slot]
                if (buf is None or tuple(buf.shape) != batch.shape
                        or buf.numpy().dtype != batch.dtype):
                    buf = self._ring[slot] = _pinned(batch.shape, batch.dtype)
                with profiling.timed("stage.copy", batch.nbytes):
                    buf.numpy()[...] = batch
                # The put's time, for the wait in the queue (tracing only).
                put_ns = time.perf_counter_ns() if profiling.tracing() else None
                self._filled.put((slot, buf, put_ns))
            self._filled.put(None)
        except Exception as e:  # raised again in the consumer's thread by next()
            self._filled.put(e)

    def next(self):
        """(slot, pinned buffer) of the next batch, or None at the end."""
        item = self._filled.get()
        if isinstance(item, Exception):
            raise item
        if item is None:
            return None
        slot, buf, put_ns = item
        if put_ns is not None:
            profiling.count_time("stage.queued", time.perf_counter_ns() - put_ns)
        return slot, buf

    def release(self, slot: int, copied: "torch.cuda.Event") -> None:
        """The copy out of ``slot``'s buffer was issued; ``copied`` follows it."""
        self._free[slot].put(copied)

    def close(self) -> None:
        self._stop.set()
        for q in self._free:
            q.put(None)
        self._thread.join(timeout=60)


def _when_done(out: Dict[str, torch.Tensor], done: "torch.cuda.Event"):
    """``out`` once ``done`` (recorded after its forward) has completed.
    The event's synchronizations are counted (``serve.event_syncs``): the
    staging thread makes the same runtime call, which a profiler of this
    thread alone cannot tell from this one."""
    with profiling.span("serve.wait_done"):
        profiling.count("serve.event_syncs")
        done.synchronize()
    return out


def serve_stream(
    predict_fn: Callable,
    batches: Iterable[np.ndarray],
    depth: int = 2,
    device: Union[str, torch.device] = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Pipelined streaming inference: keep ``depth`` batches in flight and
    yield each batch's pose dict (device tensors, computed) in order.

    On ``cuda`` a staging thread (:class:`_Stager`) copies the batches into
    a ring of ``depth`` pinned buffers; each is sent to the card on a side
    stream, and the forward runs on the current stream after it waits on
    that copy's event.  So the host's staging copy of the next batches and
    their transfers overlap the forward of the one before, even where the
    predict function synchronizes the host (the decode's ``eigh``).
    While a profiler runs, the consumer's thread marks its wait for a
    staged window, the copy's launch, the predict function and the wait for
    a window in flight (spans ``spef.serve.{wait_staged,h2d,predict,
    wait_done}``).
    """
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    device = torch.device(device)
    pending: collections.deque = collections.deque()
    if device.type != "cuda":
        for batch in batches:
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
            with profiling.span("serve.predict"):
                pending.append(predict_fn(x))
            if len(pending) >= depth:
                yield pending.popleft()
        while pending:
            yield pending.popleft()
        return

    compute = torch.cuda.current_stream(device)
    copy_stream = torch.cuda.Stream(device)
    stager = _Stager(batches, depth)
    try:
        while True:
            with profiling.span("serve.wait_staged"):
                item = stager.next()
            if item is None:
                break
            slot, buf = item
            with profiling.span("serve.h2d"), torch.cuda.stream(copy_stream):
                x = buf.to(device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            stager.release(slot, copied)
            compute.wait_event(copied)
            # x was allocated on the copy stream and is read on the compute stream.
            x.record_stream(compute)
            with profiling.span("serve.predict"):
                out = predict_fn(x)
            done = torch.cuda.Event()
            done.record(compute)
            pending.append((out, done))
            if len(pending) >= depth:
                yield _when_done(*pending.popleft())
        while pending:
            yield _when_done(*pending.popleft())
    finally:
        stager.close()
