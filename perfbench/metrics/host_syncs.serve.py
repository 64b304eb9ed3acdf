"""Host synchronizations a window while serving: blocking CUDA runtime
calls (stream and device synchronizations, synchronous copies) that the
trace puts on the dispatching thread inside the program's ``spef.`` spans
(the decode's ``eigh``, the float forward's scalar), plus the dispatcher's
waits for a window in flight, which it counts itself
(``serve.event_syncs``), over the windows forwarded.  Event
synchronizations are not taken from the trace: the staging thread's wait
for a copy makes the same call, and the trace gives it the dispatching
thread's id."""

from perfbench.metrics import _program


def read(trace, ctx):
    return _program.host_syncs(trace, "forward", _program.BLOCKING_BUT_EVENTS,
                               "serve.event_syncs")
