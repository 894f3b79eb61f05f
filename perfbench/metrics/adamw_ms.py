"""adamw_ms: kernel ms a step after the last backward kernel: the
gradients' global norm, the clipping and the AdamW update. Layer: the
optimizer (``optim/adamw.py``)."""
MOVES = "step_ms"


def read(ctx):
    t = ctx.trace
    us = None if t is None else t.phase_us("after")
    if not us:
        return None
    return us / 1e3 / t.n_steps
