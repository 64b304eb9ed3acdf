"""HRNet-W32's forward against its roofline, in %: the least time of the
forward at the window's batch (``roofline_hrnet.forward_bound_s``: every
convolution's bytes or operations, the exchanges' and the softmax's bytes)
over the device time of the ``forward`` span a window, whatever kernels
implement it."""

from perfbench import roofline_hrnet


def read(trace, ctx):
    n = trace.count("forward")
    s = trace.device_s("forward")
    if not n or s <= 0:
        return None
    batch = ctx.size("window", ctx.traffic["window"])
    return 100.0 * roofline_hrnet.forward_bound_s(ctx.cfg, batch) / (s / n)
