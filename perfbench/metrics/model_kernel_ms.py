"""model_kernel_ms: kernel ms a step from the first forward kernel to the
last backward kernel (``devtrace`` splits each step by the thread that
launched its kernels). Layer: model forward and backward
(``models/transformer.py``, ``models/attention.py``,
``models/common.py``)."""
MOVES = "step_ms"


def read(ctx):
    t = ctx.trace
    us = None if t is None else t.phase_us("forward", "between", "backward")
    if not us:
        return None
    return us / 1e3 / t.n_steps
