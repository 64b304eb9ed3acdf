"""The training step's share of the card's peak, in %: 3 x 2 x MACs a frame
(forward, and backward at twice the forward) times the frames stepped in
the traced stretch, over its seconds times the bf16 peak (989 TFLOP/s at
700 W)."""

from perfbench import roofline


def read(trace, ctx):
    n = trace.count("step")
    if not n or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    frames = n * ctx.size("batch", ctx.traffic["batch"])
    ops = 3 * 2 * roofline.model_macs(ctx.cfg) * frames
    return 100.0 * ops / trace.window_s / roofline.PEAK_OPS_S[ctx.cfg["precision"]]
