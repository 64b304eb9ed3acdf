"""What the per-layer readers take from the program's own tracing: its
``spef.`` spans among the host events of the traced stretch's main thread
(``TraceSummary._cpu``), and its counters
(``spef_tpu_torch.utils.profiling.counters``, added to only while a
profiler runs, so their totals cover the traced stretch).

A program without these spans or counters gives None, never an error.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

# Runtime calls that block the host until the device reaches a point
# (``cudaMemcpy`` is the synchronous copy; ``cudaMemcpyAsync`` is not one).
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpy")
# The same but an event's: the trace gives a runtime call of a thread the
# profiler does not trace the main thread's id, and the serving stream's
# staging thread waits on an event each window, so the dispatcher counts
# its own event waits instead.
BLOCKING_BUT_EVENTS = tuple(b for b in BLOCKING if b != "cudaEventSynchronize")


def counters() -> Dict[str, int]:
    """The program's counters; empty where it has none."""
    try:
        from spef_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def mean_ms(trace, name: str) -> Optional[float]:
    """The mean of the intervals the program counted as ``name`` (counters
    ``<name>``, how many, and ``<name>_ns``), in ms."""
    if trace.window_s <= 0:
        return None
    c = counters()
    n = c.get(name, 0)
    return c[name + "_ns"] / n * 1e-6 if n and name + "_ns" in c else None


def rate_gb_s(trace, name: str) -> Optional[float]:
    """The bytes the program counted over the intervals' time (counters
    ``<name>_bytes`` and ``<name>_ns``), in GB/s."""
    if trace.window_s <= 0:
        return None
    c = counters()
    ns, nbytes = c.get(name + "_ns", 0), c.get(name + "_bytes", 0)
    return nbytes / ns if ns and nbytes else None


def _main_events(trace) -> List[Tuple[int, int, int, str]]:
    """The host events of the stretch's main thread that start inside it."""
    return [e for e in getattr(trace, "_cpu", ())
            if e[2] == trace.main_thread and trace.t0 <= e[0] <= trace.t1]


def spans(trace, prefix: str) -> List[Tuple[int, int]]:
    """(start, end) of the main thread's spans whose name starts with
    ``spef.<prefix>``, clipped to the stretch, sorted."""
    return sorted((s, min(e, trace.t1)) for s, e, _, name in _main_events(trace)
                  if name.startswith("spef." + prefix))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_in_spans_ms(trace, prefix: str, per: str) -> Optional[float]:
    """Device idle time (no kernel or copy) inside the main thread's
    ``spef.<prefix>`` spans, in ms a benchmark span ``per``."""
    n = trace.count(per) if trace.window_s > 0 else 0
    held = _union(spans(trace, prefix)) if n else []
    if not held:
        return None
    edges = [trace.t0] + [t for iv in trace.busy_intervals() for t in iv] + [trace.t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    ns, j = 0, 0
    for a, b in idle:  # both sorted and disjoint
        while j < len(held) and held[j][1] <= a:
            j += 1
        k = j
        while k < len(held) and held[k][0] < b:
            ns += min(b, held[k][1]) - max(a, held[k][0])
            k += 1
    return ns / n * 1e-6


def host_syncs(trace, per: str, blocking=BLOCKING, counter: str = "") -> Optional[float]:
    """Blocking runtime calls (names in ``blocking``) that the main thread
    makes inside a ``spef.`` span, plus the program's counter ``counter``
    where given, a benchmark span ``per``."""
    n = trace.count(per) if trace.window_s > 0 else 0
    held = _union(spans(trace, "")) if n else []
    if not held:
        return None
    starts = [a for a, _ in held]
    calls = counters().get(counter, 0) if counter else 0
    for t, _, _, name in _main_events(trace):
        if name in blocking:
            i = bisect.bisect_right(starts, t) - 1
            calls += i >= 0 and t <= held[i][1]
    return calls / n
