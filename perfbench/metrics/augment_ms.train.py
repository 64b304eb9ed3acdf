"""Device time of ``data/augment.py::train_augment``, in ms a step."""


def read(trace, ctx):
    n = trace.count("step")
    s = trace.device_s("augment")
    return s / n * 1e3 if n and s > 0 else None
