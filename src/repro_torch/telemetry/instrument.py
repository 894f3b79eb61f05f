"""Instrumentation glue between telemetry and the serving stack.

The counterpart of ``repro.telemetry.instrument``. ``instrument_forward``
wraps the callable ``ExecutionPlan.make_forward`` returns and does three
things at its Python boundary:

  1. opens a ``plan.forward`` span tagged with the plan's
     setting/backend/clusters and closes it only after ``device_sync`` —
     the asynchronous kernel launches are billed to the span that made
     them;
  2. bills wire bytes onto zero-duration *accounting spans* computed from
     the plan's own ``measured_traffic`` report — the same executed
     send/recv tables ``distributed.halo`` hands to the exchange.  Span-tree
     byte totals therefore equal ``TrafficReport.total_bytes()`` exactly,
     by construction;
  3. increments the ``halo.shipped_bytes`` counter so byte totals survive
     span-ring eviction.

The traffic report is computed lazily on the first *traced* call and
cached — with telemetry disabled the wrapper is a flag check plus the
undecorated forward. The bucketed runtimes open their own ``halo.gather``
/ ``halo.mvm`` spans inside it (``distributed.halo``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from . import get_registry, get_tracer

__all__ = ["instrument_forward", "record_commit", "record_streaming_traffic"]


def instrument_forward(plan, cfg, mode: str, fwd: Callable) -> Callable:
    """Wrap a plan forward with span + exact bytes accounting."""
    state: Dict[str, Any] = {}

    def run(params):
        tracer = get_tracer()
        if not tracer.enabled:
            return fwd(params)
        billing = state.get("billing")
        if billing is None:
            rep = plan.measured_traffic(cfg, mode=mode)
            tier0 = int(rep.tier0_bytes().sum())
            per_layer = [int(b) for b in rep.tier1_bytes().sum(axis=1)]
            billing = state["billing"] = (tier0, per_layer, tier0 + sum(per_layer))
        tier0, per_layer, total = billing
        with tracer.span("plan.forward", setting=plan.setting,
                         backend=plan.backend, clusters=plan.n_clusters):
            if tier0:
                with tracer.span("halo.tier0_upload") as s0:
                    s0.add_bytes(tier0)
            out = fwd(params)
            for layer, nbytes in enumerate(per_layer):
                if nbytes:
                    with tracer.span("halo.exchange", layer=layer) as sl:
                        sl.add_bytes(nbytes)
            if total:
                get_registry().counter("halo.shipped_bytes",
                                       setting=plan.setting).inc(total)
            tracer.device_sync(out, name="plan.forward.sync")
        return out

    return run


def record_streaming_traffic(traffic, setting: str) -> None:
    """Bill one incremental tick's wire bytes (counter + current span)."""
    reg = get_registry()
    if not reg.enabled or traffic is None:
        return
    total = int(traffic.total_bytes())
    reg.counter("streaming.shipped_bytes", setting=setting).inc(total)
    cur = get_tracer().current()
    if cur is not None:
        cur.add_bytes(total)


def record_commit(update, setting: str) -> None:
    """Fold one StreamingUpdate's accounting into the registry."""
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter("server.commits").inc()
    if update.full:
        reg.counter("server.full_refreshes").inc()
    reg.histogram("server.commit_seconds").observe(float(update.seconds))
    reg.gauge("streaming.recompute_fraction").set(
        float(update.recompute_fraction))
    record_streaming_traffic(update.traffic, setting)
