"""Device idle time while the dispatching thread waits for a staged window,
in ms a window: the card's gaps (no kernel or copy) inside the main
thread's ``spef.serve.wait_staged`` spans, over the windows forwarded."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.idle_in_spans_ms(trace, "serve.wait_staged", "forward")
