"""mixer_kernel_ms: kernel ms a step launched inside the program's
``model.mixer`` spans (the token mixer's forward: projections, RoPE, the
chunked attention) or ``model.mixer.backward`` intervals (its backward on
the autograd thread, the checkpointed chunk pairs' recomputation
included), by ``spantrace``. Layer: the token mixer
(``models/attention.py``)."""
from perfbench import spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    return None if a is None else a.kernel_ms(*spantrace.MIXER)
