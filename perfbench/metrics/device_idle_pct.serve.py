"""The share of the traced stretch in which no kernel or copy runs on the
card, in %, while serving."""


def read(trace, ctx):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
