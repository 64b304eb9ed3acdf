"""Profiling and timing helpers.

Counterpart of ``spef_tpu.utils.profiling``:

  * :func:`trace`: a context manager around ``torch.profiler`` writing a
    Chrome / TensorBoard trace (host ops and, where a card is present, its
    kernels) into ``log_dir``;
  * :func:`benchmark_fn`: latency / throughput statistics (p50 / p95 /
    mean / min, items a second) of any callable, each call ended by
    ``torch.cuda.synchronize`` where JAX blocks until ready;
  * :func:`measure_execution_time`: a decorator printing wall time a call.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["trace", "benchmark_fn", "measure_execution_time"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (a
    ``*.pt.trace.json`` file that TensorBoard and Chrome's trace viewer
    read); yields the profiler, whose ``key_averages()`` sums by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync()


def benchmark_fn(
    fn: Callable,
    *args,
    warmup: int = 3,
    iters: int = 20,
    items_per_call: int = 1,
) -> Dict[str, float]:
    """Latency / throughput statistics for a device callable (host clock
    around each call and its synchronize)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "mean_ms": float(times.mean() * 1e3),
        "p50_ms": float(np.percentile(times, 50) * 1e3),
        "p95_ms": float(np.percentile(times, 95) * 1e3),
        "min_ms": float(times.min() * 1e3),
        "items_per_sec": float(items_per_call / times.mean()),
    }


def measure_execution_time(func: Callable) -> Callable:
    """Decorator printing wall time a call (the reference's ``gui.py``)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        print(f"{func.__name__}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
        return result

    return wrapper
