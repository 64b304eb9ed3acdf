"""The readers of the program's own spans and counters (``metrics/_program.py``
and the metrics on it), on a ``TraceSummary`` made by hand from
kineto-like events, on one made by the profiler on the CPU, and on a
program that has no spans or counters (None, never an error)."""

import os
import time

import pytest
import torch

from perfbench import harness
from perfbench.trace import TraceSummary
from spef_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MS = 1_000_000  # ns
MAIN, OTHER = 1, 2
SERVE = ("stage_copy_ms.serve", "slot_wait_ms.serve", "queue_ms.serve",
         "stage_copy_gbps.serve", "stager_idle_ms.serve", "host_syncs.serve")
COUNTED = 4  # SERVE's readers of counters alone
TRAIN = ("host_syncs.train", "backward_idle_ms.train")


class _Event:
    """What ``TraceSummary`` reads of a kineto event."""

    def __init__(self, name, start, end, thread=MAIN, device=False, annotation=False, corr=0):
        self._name, self._start, self._end = name, start, end
        self._thread, self._device, self._annotation, self._corr = thread, device, annotation, corr

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._corr


def _span(name, a, b, thread=MAIN):
    return _Event(name, a * MS, b * MS, thread, annotation=True)


def _call(name, a, b, thread=MAIN):
    return _Event(name, a * MS, b * MS, thread)


def _kernel(a, b):
    return _Event("void kernel", a * MS, b * MS, device=True)


def _serving_trace():
    """A 100 ms stretch, two windows: the card busy 0-20, 40-60 and
    90-100 ms; the main thread waits for a staged window over 15-45 and
    70-80 (idle inside them: 20-40 and 70-80, 30 ms); the other thread's
    wait is not the dispatcher's."""
    return TraceSummary([
        _span("bench.stretch", 0, 100),
        _span("bench.forward", 0, 10), _span("bench.forward", 40, 50),
        _span("spef.serve.wait_staged", 15, 45), _span("spef.serve.wait_staged", 70, 80),
        _span("spef.serve.wait_staged", 20, 90, thread=OTHER),
        _span("spef.predict.finish", 50, 60), _span("spef.decode.eigh", 52, 58),
        _span("spef.serve.wait_done", 60, 65),
        _call("cudaStreamSynchronize", 55, 57),  # in the decode: counts
        _call("cudaMemcpyAsync", 53, 54),  # not blocking
        _call("cudaEventSynchronize", 61, 64),  # in the wait for a window: the program's count
        _call("cudaEventSynchronize", 56, 57),  # the stager's, given the main thread's id
        _call("cudaMemcpy", 66, 67),  # outside any spef. span
        _call("cudaStreamSynchronize", 55, 57, thread=OTHER),  # not the main thread
        _kernel(0, 20), _kernel(40, 60), _kernel(90, 100),
    ])


def _ctx(cell):
    _, _, cfg, traffic, limits = harness.cell_files(ROOT, cell)
    return harness.Context(ROOT, {}, cfg, traffic, limits, 1, 1.0, True, None, "plain", 0.0)


def _read(name, trace, cell="flagship_int8.stream_b256"):
    return harness.load_reader(name).read(trace, _ctx(cell))


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_device_idle_inside_the_dispatchers_wait_for_a_staged_window():
    assert _read("stager_idle_ms.serve", _serving_trace()) == pytest.approx(30 / 2)


def test_blocking_calls_inside_the_programs_spans_are_host_syncs():
    """The decode's stream synchronization from the trace; event waits from
    the dispatcher's own count, never from the trace."""
    assert _read("host_syncs.serve", _serving_trace()) == pytest.approx(1 / 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("serve.event_syncs", 2)
    assert _read("host_syncs.serve", _serving_trace()) == pytest.approx((1 + 2) / 2)


def test_training_readers_take_the_backward_and_the_steps():
    trace = TraceSummary([
        _span("bench.stretch", 0, 100),
        _span("bench.step", 0, 45), _span("bench.step", 50, 95),
        _span("spef.train.backward", 10, 30), _span("spef.train.backward", 60, 80),
        _span("spef.train.optimizer", 30, 40),
        _call("cudaStreamSynchronize", 35, 36), _call("cudaDeviceSynchronize", 85, 86),
        _kernel(0, 15), _kernel(25, 65), _kernel(75, 100),
    ])
    cell = "flagship_float.train_b64"
    assert _read("backward_idle_ms.train", trace, cell) == pytest.approx((10 + 10) / 2)
    assert _read("host_syncs.train", trace, cell) == pytest.approx(1 / 2)


def test_counter_ratios_are_means_over_what_was_counted():
    """Each mean over its own count: four copies, two waits for a buffer,
    three gets from the queue (a window put before the profiler stopped and
    not yet got is in none of them)."""
    trace = _serving_trace()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            profiling.count_time("stage.copy", 10 * MS, 50_000_000)
        for ns in (1 * MS, 3 * MS):
            profiling.count_time("stage.slot_wait", ns)
        for _ in range(3):
            profiling.count_time("stage.queued", 0)
    assert _read("stage_copy_ms.serve", trace) == pytest.approx(10.0)
    assert _read("stage_copy_gbps.serve", trace) == pytest.approx(5.0)
    assert _read("slot_wait_ms.serve", trace) == pytest.approx(2.0)
    assert _read("queue_ms.serve", trace) == 0.0


def test_nothing_read_gives_none(monkeypatch):
    serving = _serving_trace()
    # no counters: the stager did not stage in the stretch
    for name in SERVE[:COUNTED]:
        assert _read(name, serving) is None, name
    # no stretch, no spef. spans, no windows
    empty = TraceSummary([])
    unspanned = TraceSummary([_span("bench.stretch", 0, 100), _span("bench.forward", 0, 10),
                              _span("bench.step", 0, 10), _call("cudaStreamSynchronize", 5, 6),
                              _kernel(0, 20)])
    idle = TraceSummary([_span("bench.stretch", 0, 100), _span("spef.serve.wait_staged", 5, 9),
                         _span("spef.train.backward", 5, 9)])
    for trace in (empty, unspanned, idle):
        for name in SERVE[COUNTED:]:
            assert _read(name, trace) is None, name
        for name in TRAIN:
            assert _read(name, trace, "flagship_float.train_b64") is None, name
    # a program without counters (the parent of the tracing): None, no error
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count_time("stage.copy", 40 * MS, 100)
    monkeypatch.delattr(profiling, "counters")
    for name in SERVE[:COUNTED]:
        assert _read(name, serving) is None, name


def test_readers_on_the_profilers_own_trace():
    """The profiler's events on the CPU: the spans and the stretch's main
    thread are found; no device op runs, so the whole wait is idle."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("bench.stretch"):
            for _ in range(2):
                with torch.autograd.profiler.record_function("bench.forward"):
                    torch.ones(8).sum()
                with profiling.span("serve.wait_staged"):
                    time.sleep(0.01)
    trace = TraceSummary(prof.profiler.kineto_results.events())
    assert trace.count("forward") == 2
    assert _read("stager_idle_ms.serve", trace) >= 10.0
    assert _read("host_syncs.serve", trace) == 0.0
