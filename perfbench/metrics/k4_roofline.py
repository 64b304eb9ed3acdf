"""K4's share of its roofline, in %: the least time the inverted-residual
blocks' work could take at the window's batch (``roofline.blocks_bound_s``,
from the graph's block shapes), over the device time of the K4 kernel
(``mbconv_kernel``) a window."""

from perfbench import roofline


def read(trace, ctx):
    n = trace.count("forward")
    s = trace.device_s("forward", name_has="mbconv_kernel")
    if not n or s <= 0:
        return None
    batch = ctx.size("window", ctx.traffic["window"])
    return 100.0 * roofline.blocks_bound_s(ctx.cfg, batch) / (s / n)
