"""Host synchronizations a step while training: blocking CUDA runtime calls
the main thread makes inside the program's ``spef.`` spans (the train
step's, augmentation's and the per-step metrics' decode), over the steps."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.host_syncs(trace, "step")
