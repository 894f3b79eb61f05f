"""optimizer_kernel_ms: kernel ms a step launched inside the program's
``train.optimizer`` span (AdamW, the gradients' global norm and the
clipping included), by ``spantrace``. Layer: the optimizer
(``optim/adamw.py``)."""
from perfbench import spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    return None if a is None else a.kernel_ms(*spantrace.OPTIMIZER)
