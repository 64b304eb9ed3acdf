"""Device idle time while the dispatching thread runs HRNet's forward, in ms
a window: the card's gaps (no kernel or copy) inside the main thread's
``spef.hrnet.`` spans (the stem, the four stages, the exchanges), over the
windows forwarded: the forward's launches falling behind the card."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.idle_in_spans_ms(trace, "hrnet.", "forward")
