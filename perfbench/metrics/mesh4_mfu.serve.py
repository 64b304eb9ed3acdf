"""The served model's share of the peak of every card of the cell, in %:
2 x MACs a frame (``roofline.model_macs``) times the frames forwarded in
the traced stretch, over the stretch's seconds times the configuration's
precision's peak (int8 1,979 TOP/s, 700 W) times the cell's cards."""

from perfbench import roofline


def read(trace, ctx):
    n = trace.count("forward")
    if not n or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    frames = n * ctx.size("window", ctx.traffic["window"])
    ops = 2 * roofline.model_macs(ctx.cfg) * frames
    peak = roofline.PEAK_OPS_S[ctx.cfg["precision"]] * int(ctx.cell["chips"])
    return 100.0 * ops / trace.window_s / peak
