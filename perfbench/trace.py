"""The traced stretch of a run: ``torch.profiler`` over CPU and CUDA
activities, read in memory, and the sums the per-layer readers take from it.

The harness wraps its calls into each layer in ``record_function`` spans
named ``bench.<layer>`` and one span ``bench.stretch`` around the whole
traced stretch.  A device operation (kernel, copy or set) belongs to the
innermost benchmark span, on the launching thread, that holds the runtime
call which launched it; the correlation id links the two.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Spans around the benchmark's calls, and the profiler over a stretch;
    with ``enabled`` false every span is a no-op and nothing is recorded."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self._stretch = None
        self.summary: Optional["TraceSummary"] = None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        with torch.autograd.profiler.record_function(f"bench.{name}"):
            yield

    def prepare(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initializes the device's tracing, which takes seconds."""
        if not self.enabled:
            return
        self.start()
        self.stop()
        self.summary = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._stretch = torch.autograd.profiler.record_function("bench.stretch")
        self._stretch.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stretch.__exit__(None, None, None)
        self.prof.stop()
        self.summary = TraceSummary(self.prof.profiler.kineto_results.events())
        self.prof = None


def _kind(e) -> str:
    """The kineto activity of an event, from its device, its name and
    whether it is a user annotation (the event binding of the torch the
    benchmark runs on has no ``activity_type``)."""
    name, annotation = e.name(), e.is_user_annotation()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        return {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}.get(name[:6], "kernel")
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _span_ns(e) -> Tuple[int, int]:
    return e.start_ns(), e.start_ns() + e.duration_ns()


class TraceSummary:
    """Device operations with their spans, benchmark spans, and the stretch."""

    def __init__(self, events):
        spans: List[Tuple[int, int, int, str]] = []  # (start, end, thread, name)
        cpu: List[Tuple[int, int, int, str]] = []
        ops: Dict[int, Tuple[int, int]] = {}  # an op or span's id -> (start, thread)
        runtime: Dict[int, Tuple[int, int]] = {}  # a runtime call's correlation -> same
        device = []
        for e in events:
            kind = _kind(e)
            if kind in _DEVICE_KINDS:
                device.append((e, kind))
                continue
            if kind == "gpu_user_annotation":
                continue
            (start, end), thread = _span_ns(e), e.start_thread_id()
            if kind == "user_annotation" and e.name().startswith("bench."):
                spans.append((start, end, thread, e.name()[len("bench."):]))
            (runtime if kind == "cuda_runtime" else ops)[e.correlation_id()] = (
                start, thread)
            cpu.append((start, end, thread, e.name()))
        stretch = [s for s in spans if s[3] == "stretch"]
        self.t0, self.t1 = (stretch[0][0], stretch[0][1]) if stretch else (0, 0)
        self.spans = [s for s in spans if s[3] != "stretch" and s[0] >= self.t0
                      and s[1] <= self.t1]
        self.main_thread = stretch[0][2] if stretch else None
        self._cpu = sorted(cpu)
        self.ops = []  # (start, end, kind, name, span or None)
        for e, kind in device:
            # The op or span that launched it (its external id), else the
            # runtime call (its correlation id).
            launch = ops.get(e.linked_correlation_id()) or runtime.get(e.correlation_id())
            span = self._span_at(*launch) if launch else None
            self.ops.append((*_span_ns(e), kind, e.name(), span))
        self.ops.sort()

    def _span_at(self, t: int, thread: int) -> Optional[str]:
        best = None
        for start, end, th, name in self.spans:
            if th == thread and start <= t <= end and (best is None or start >= best[0]):
                best = (start, name)
        return best[1] if best else None

    # ---- what the readers take ------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def count(self, span: str) -> int:
        """Benchmark spans of that name inside the stretch."""
        return sum(1 for s in self.spans if s[3] == span)

    def device_s(self, span: Optional[str] = None, kinds=("kernel",), name_has: str = "") -> float:
        """Seconds of device operations of ``kinds`` whose names hold
        ``name_has``, launched inside ``span`` (any, with None)."""
        return sum(end - start for start, end, kind, name, sp in self.ops
                   if kind in kinds and name_has in name and (span is None or sp == span)) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device operations' intervals, clipped to the stretch."""
        merged: List[List[int]] = []
        for start, end, _, _, _ in self.ops:
            start, end = max(start, self.t0), min(end, self.t1)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        total: Dict[str, int] = collections.Counter()
        for start, end, _, name, _ in self.ops:
            total[name[:160]] += end - start
        return [[name, ns * 1e-9] for name, ns in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time inside the stretch, summed by what the
        launching thread was doing at each gap's middle: its benchmark span
        and innermost operation (one sweep over the host's events)."""
        total: Dict[str, int] = collections.Counter()
        edges = [self.t0] + [t for iv in self.busy_intervals() for t in iv] + [self.t1]
        i, active = 0, []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while i < len(self._cpu) and self._cpu[i][0] <= mid:
                if self._cpu[i][2] == self.main_thread:
                    active.append(self._cpu[i])
                i += 1
            active = [e for e in active if e[1] >= mid]
            spans = [e for e in active if e[3].startswith("bench.") and e[3] != "bench.stretch"]
            ops = [e for e in active if not e[3].startswith("bench.")]
            span = max(spans)[3][len("bench."):] if spans else "outside spans"
            total[f"{span}/{max(ops)[3] if ops else 'host'}"] += b - a
        return [[name, ns * 1e-9] for name, ns in total.most_common(n)]

