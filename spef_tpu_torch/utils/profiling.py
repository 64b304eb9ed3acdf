"""Tracing of the port: spans and counters at its layers' boundaries.

Counterpart of ``spef_tpu.utils.profiling``:

  * :func:`span`: a ``record_function`` named ``spef.<name>`` while a
    ``torch.profiler`` runs, and one shared null context otherwise, so an
    untraced call reads a flag (about half a microsecond) instead of
    entering a ``record_function`` (about ten, profiler or not);
  * :func:`count`, :func:`count_time`, :func:`counters`,
    :func:`reset_counters`: named counters, added to only while a profiler
    runs, for what a span cannot carry into a trace of one thread: work and
    waits on the serving stream's staging thread, and waits measured across
    threads; :func:`timed` is a span that also counts itself into
    ``<name>``, its nanoseconds into ``<name>_ns`` and what it moved into
    ``<name>_bytes``, together;
  * :func:`trace`: a context manager around ``torch.profiler`` over every
    thread, writing a Chrome / TensorBoard trace (host ops, the spans and,
    where a card is present, its kernels) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "tracing", "span", "timed", "count", "count_time", "counters",
           "reset_counters"]

_NULL = contextlib.nullcontext()
_counters: Dict[str, int] = {}
_lock = threading.Lock()  # the staging thread and the caller's count at once


def tracing() -> bool:
    """Whether a profiler runs.  torch's Python-side flag, which every
    thread reads; the C++ ``_profiler_enabled()`` is per thread and reads
    false on a thread the profiler does not trace."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The span ``spef.<name>`` while tracing; else a shared null context."""
    if tracing():
        return _autograd_profiler.record_function("spef." + name)
    return _NULL


class _Timed:
    def __init__(self, name: str, nbytes: int):
        self.name, self.nbytes = name, nbytes
        self.rf = _autograd_profiler.record_function("spef." + name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        count_time(self.name, time.perf_counter_ns() - self.t0, self.nbytes)
        return self.rf.__exit__(*exc)


def timed(name: str, nbytes: int = 0):
    """:func:`span` that also counts itself as :func:`count_time` does."""
    return _Timed(name, nbytes) if tracing() else _NULL


def count(name: str, value: int = 1) -> None:
    """Add ``value`` to the counter ``name`` while tracing."""
    if tracing():
        with _lock:
            _add(name, value)


def _add(name: str, value: int) -> None:  # under _lock
    _counters[name] = _counters.get(name, 0) + value


def count_time(name: str, ns: int, nbytes: int = 0) -> None:
    """Add one to the counter ``name``, ``ns`` to ``<name>_ns`` and, where
    given, ``nbytes`` to ``<name>_bytes``, together, while tracing: so a
    mean time or a rate covers the same intervals."""
    if tracing():
        with _lock:
            _add(name, 1)
            _add(name + "_ns", ns)
            if nbytes:
                _add(name + "_bytes", nbytes)


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of every thread into ``log_dir``
    (a ``*.pt.trace.json`` file that TensorBoard and Chrome's trace viewer
    read), the staging thread's spans included; yields the profiler, whose
    ``key_averages()`` sums by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync()
