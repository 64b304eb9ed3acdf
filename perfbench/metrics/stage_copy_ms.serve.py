"""The serving stream's staging copy, in ms a copy: the stager thread's
numpy copy of each window into its pinned buffer (``serving.py::_Stager``;
counters ``stage.copy_ns`` over ``stage.copy``, since the benchmark's
profiler traces one thread)."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.mean_ms(trace, "stage.copy")
