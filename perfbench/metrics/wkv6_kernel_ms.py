"""wkv6_kernel_ms: kernel ms a step launched inside the program's
``model.wkv6`` spans (the RWKV-6 scan's forward: the ``wkv6_scan`` kernel
and its zero state) or ``model.wkv6.backward`` intervals (its backward on
the autograd thread), by ``spantrace``. Layer: the RWKV scan
(``models/recurrent.py`` ``_scan``, ``kernels/recurrence/``)."""
from perfbench import scanwork, spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    return None if a is None else a.kernel_ms(*scanwork.SPANS) or None
