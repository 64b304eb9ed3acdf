"""Serving runtime: batched pose inference on one device.

Counterpart of ``spef_tpu.serving.PoseServer`` without the mesh: a fixed-size
batch window (requests are zero-padded up to it, so every call runs the same
shapes), and latency statistics.  Batches in flight on several CUDA streams
are in ROADMAP §A, deploy and serve.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

__all__ = ["PoseServer"]


class PoseServer:
    """Batched pose-inference server on one device."""

    def __init__(
        self,
        predict_fn: Callable,  # images (B, H, W, C) tensor on `device` -> pose dict
        img_shape: Tuple[int, int, int],
        max_batch: int = 256,
        device: Union[str, torch.device] = "cuda",
    ):
        self.predict_fn = predict_fn
        self.img_shape = tuple(img_shape)
        self.max_batch = max_batch
        self.device = torch.device(device)
        self._latencies: collections.deque = collections.deque(maxlen=1000)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> float:
        """Run the window once (kernel builds, cuDNN plans); returns seconds."""
        dummy = torch.zeros((self.max_batch, *self.img_shape), dtype=torch.uint8,
                            device=self.device)
        t0 = time.perf_counter()
        self.predict_fn(dummy)
        self._sync()
        return time.perf_counter() - t0

    def predict(self, images: np.ndarray) -> Tuple[Dict[str, np.ndarray], float]:
        """Serve one request (any batch size <= max_batch): pads to the
        window, returns host numpy results and the latency in ms (host to
        device copy plus device work, as the JAX server measures it)."""
        n = images.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} > serving window {self.max_batch}")
        if n < self.max_batch:
            pad = np.zeros((self.max_batch - n, *self.img_shape), images.dtype)
            images = np.concatenate([images, pad])
        t0 = time.perf_counter()
        out = self.predict_fn(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        self._sync()
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._latencies.append(latency_ms)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}, latency_ms

    def stats(self) -> Dict[str, float]:
        lat = np.asarray(self._latencies) if self._latencies else np.zeros(1)
        return {
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "mean_ms": float(lat.mean()),
            "requests": len(self._latencies),
            "devices": 1,
        }
