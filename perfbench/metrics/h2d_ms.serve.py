"""Device time of the host-to-device copies of the windows, in ms a window:
the HtoD copies in the traced stretch over the windows forwarded in it."""


def read(trace, ctx):
    n = trace.count("forward")
    s = trace.device_s(kinds=("gpu_memcpy",), name_has="HtoD")
    return s / n * 1e3 if n and s > 0 else None
