"""The whole int8 forward's share of its roofline, in %: the least time of
stem, blocks, head conv and heads at the window's batch
(``roofline.int8_forward_bound_s``), over the forward's device time a
window, whatever kernels implement it."""

from perfbench import roofline


def read(trace, ctx):
    n = trace.count("forward")
    s = trace.device_s("forward")
    if not n or s <= 0:
        return None
    batch = ctx.size("window", ctx.traffic["window"])
    return 100.0 * roofline.int8_forward_bound_s(ctx.cfg, batch) / (s / n)
