"""wkv6_roofline: the least time a step's RWKV-6 scans need, over
``wkv6_kernel_ms``, in %. The bound is one call a layer, forward and
backward, counted from the cell's shapes alone (``scanwork.py``): the
bytes over 3.35 TB/s against the operations over 67 TFLOP/s float32, the
larger. Layer: the RWKV scan (``kernels/recurrence/``)."""
from perfbench import scanwork, spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    ms = None if a is None else a.kernel_ms(*scanwork.SPANS)
    if not ms:
        return None
    return 100.0 * scanwork.step_bound_s(ctx.model, ctx.traffic) * 1e3 / ms
