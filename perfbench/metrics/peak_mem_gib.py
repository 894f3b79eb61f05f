"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the unprofiled
window, reset at its start, in GiB. Layer: the device."""
MOVES = "step_ms"


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
