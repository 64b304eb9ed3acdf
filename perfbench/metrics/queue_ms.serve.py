"""A staged window's wait for the dispatching thread, in ms a window: from
the stager's put into the filled queue to the dispatcher's get, over the
gets that found a put's time (counters ``stage.queued_ns`` over
``stage.queued``, both added at the get)."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.mean_ms(trace, "stage.queued")
