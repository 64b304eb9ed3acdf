"""HRNet-W32's share of the card's bf16 peak while serving, in %: 2 x its
MACs a frame (``roofline_hrnet.model_macs``) times the frames forwarded in
the traced stretch, over the stretch's seconds times 989 TFLOP/s (700 W)."""

from perfbench import roofline, roofline_hrnet


def read(trace, ctx):
    n = trace.count("forward")
    if not n or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    frames = n * ctx.size("window", ctx.traffic["window"])
    ops = 2 * roofline_hrnet.model_macs(ctx.cfg) * frames
    return 100.0 * ops / trace.window_s / roofline.PEAK_OPS_S[ctx.cfg["precision"]]
