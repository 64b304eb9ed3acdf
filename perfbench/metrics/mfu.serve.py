"""The served model's share of the card's peak, in %: 2 x MACs a frame
(``roofline.model_macs``) times the frames forwarded in the traced stretch,
over the stretch's seconds times the peak of the configuration's precision
(int8 1,979 TOP/s, bf16 989 TFLOP/s, at 700 W)."""

from perfbench import roofline


def read(trace, ctx):
    n = trace.count("forward")
    if not n or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    frames = n * ctx.size("window", ctx.traffic["window"])
    ops = 2 * roofline.model_macs(ctx.cfg) * frames
    return 100.0 * ops / trace.window_s / roofline.PEAK_OPS_S[ctx.cfg["precision"]]
