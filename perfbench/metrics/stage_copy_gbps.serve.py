"""The bandwidth of the serving stream's staging copy, in GB/s: the bytes
the stager thread copied into its pinned buffers over the copies' time
(counters ``stage.copy_bytes`` over ``stage.copy_ns``, added together)."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.rate_gb_s(trace, "stage.copy")
