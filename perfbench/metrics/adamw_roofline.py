"""adamw_roofline: the least time an AdamW update can take, over
``adamw_ms``, in %. The bound reads every parameter, gradient and moment
once and writes every parameter and moment once, in the dtypes the step
holds them in (``yardstick.adamw_bytes``: 22 B a bf16 parameter), over
the card's 3.35 TB/s. Layer: the optimizer."""
MOVES = "step_ms"


def read(ctx):
    t = ctx.trace
    us = None if t is None else t.phase_us("after")
    if not us:
        return None
    bound_s = ctx.yard.adamw_bytes(ctx.specs) / ctx.yard.H100["hbm_bps"]
    return 100.0 * bound_s / (us * 1e-6 / t.n_steps)
