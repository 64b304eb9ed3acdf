"""Device time of ``StagedPredict.finish`` (the softmaxes and the soft-class
decode, ``eigh`` included), in ms a window."""


def read(trace, ctx):
    n = trace.count("decode")
    s = trace.device_s("decode")
    return s / n * 1e3 if n and s > 0 else None
