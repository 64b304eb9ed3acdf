"""Device time of ``train/step.py::train_update`` (forward, loss, backward,
Adam), in ms a step."""


def read(trace, ctx):
    n = trace.count("step")
    s = trace.device_s("step")
    return s / n * 1e3 if n and s > 0 else None
