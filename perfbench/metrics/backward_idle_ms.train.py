"""Device idle time while the main thread is in the backward pass, in ms a
step: the card's gaps (no kernel or copy) inside the main thread's
``spef.train.backward`` spans (``zero_grad``, ``backward``, the
all-reduce), over the steps."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.idle_in_spans_ms(trace, "train.backward", "step")
