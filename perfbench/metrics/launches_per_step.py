"""launches_per_step: kernels launched a step, the profiler's kernel count
over the profiled steps divided by those steps. Layer: the train loop
(``launch/train.py``, ``launch/steps.py``, ``data/tokens.py``)."""
MOVES = "step_ms"


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not t.n_steps:
        return None
    return len(t.kernels) / t.n_steps
