"""alloc_retries: the caching allocator's retries a step (its
``num_alloc_retries``: a request it met only after freeing its cache)
over the unprofiled steps. Layer: the caching allocator (expandable
segments, ``launch/train._grow_segments``)."""
MOVES = "step_ms"


def read(ctx):
    if not ctx.cuda or not ctx.timed_steps:
        return None
    return ctx.alloc_retries / ctx.timed_steps
