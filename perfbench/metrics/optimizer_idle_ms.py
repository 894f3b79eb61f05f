"""optimizer_idle_ms: device-idle ms a profiled step whose gap falls
inside the program's ``train.optimizer`` span (``spantrace``): the time
AdamW's host code keeps the card waiting. Read under the profiler, which
slows the host's launches, as the result line's ``idle_gaps`` are. Layer:
the optimizer (``optim/adamw.py``)."""
from perfbench import spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    return None if a is None else a.idle_ms(*spantrace.OPTIMIZER)
