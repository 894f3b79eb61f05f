"""idle_share: the share of an unprofiled step in which no operation runs
on the device, in %: 1 - (device-busy ms a profiled step) / (the
window's ms a step on the host clock). The profiler slows the host's
launches, not the device's work, so the busy time comes from the trace
and the step from the unprofiled window; the traced stretch's own idle
share is the result line's ``busy_s`` against ``window_s``. Layer: the
device."""
MOVES = "step_ms"


def read(ctx):
    t = ctx.trace
    if t is None or t.window is None or not t.ops or not ctx.timed_steps:
        return None
    busy_s = t.busy_us() * 1e-6 / t.n_steps
    return 100.0 * (1.0 - busy_s / (ctx.timed_s / ctx.timed_steps))
