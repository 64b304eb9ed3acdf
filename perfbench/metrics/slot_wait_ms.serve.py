"""A pulled window's wait for a free pinned buffer, in ms a wait: the
stager's wait for the ring slot and for the copy that last read it
(counters ``stage.slot_wait_ns`` over ``stage.slot_wait``)."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.mean_ms(trace, "stage.slot_wait")
