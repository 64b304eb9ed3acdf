"""Device time of the forward (``StagedPredict.launch``: normalization or
the stem's folding, the backbone, the head), in ms a window."""


def read(trace, ctx):
    n = trace.count("forward")
    s = trace.device_s("forward")
    return s / n * 1e3 if n and s > 0 else None
