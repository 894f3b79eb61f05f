"""step_mfu: the model FLOPs of a step, 6 N D (N the parameters, D the
tokens a step; ``yardstick.train_flops``), over the unprofiled ms a step
on the host clock times 989.4 TFLOP/s bf16, in %. Layer: the model step,
whole."""
MOVES = "step_ms"


def read(ctx):
    if not ctx.cuda or not ctx.timed_steps:
        return None
    step_s = ctx.timed_s / ctx.timed_steps
    flops = ctx.yard.train_flops(ctx.specs, ctx.tokens_per_step)
    return 100.0 * flops / (step_s * ctx.yard.H100["bf16_flops"])
