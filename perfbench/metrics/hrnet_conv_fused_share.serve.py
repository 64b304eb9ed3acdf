"""The share of the forward's eval-mode ``ConvBnAct`` calls that ran a
fused conv kernel, over the traced stretch: the program's counters
``forward.conv_fused`` / (``forward.conv_fused`` + ``forward.conv_plain``)."""

from perfbench.metrics import _program


def read(trace, ctx):
    if trace.window_s <= 0:
        return None
    c = _program.counters()
    fused, plain = c.get("forward.conv_fused", 0), c.get("forward.conv_plain", 0)
    return fused / (fused + plain) if fused + plain else None
