"""wkv6_idle_ms: device-idle ms a profiled step whose gap falls inside the
program's ``model.wkv6`` spans or ``model.wkv6.backward`` intervals
(``spantrace``): the time the scan's host code (the custom op's dispatch
under autograd) keeps the card waiting. Read under the profiler, which
slows the host's launches. Layer: the RWKV scan
(``models/recurrent.py`` ``_scan``, ``kernels/recurrence/``)."""
from perfbench import scanwork, spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    if a is None or not a.kernel_ms(*scanwork.SPANS):
        return None
    return a.idle_ms(*scanwork.SPANS)
