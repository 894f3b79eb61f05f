"""Runtime telemetry: span tracing, metrics, drift accounting (DESIGN.md §14).

The counterpart of ``repro.telemetry``, with the port's own process-wide
tracer + registry pair, disabled by default. Hot paths instrument
unconditionally —

    from repro_torch import telemetry as tel
    with tel.span("server.commit", policy=policy):
        ...
    tel.counter("streaming.rows_recomputed").inc(rows)

— and pay one flag check per call when telemetry is off (``span`` returns a
shared null singleton; metric mutations no-op).  ``enable()`` turns on span
trees, span-duration histograms (``span_seconds{span=...}``), counters,
gauges, audit events, and the ``device_sync`` billing points (a
``torch.cuda.synchronize`` of every CUDA device the synced tensors live
on). While a ``torch.profiler`` session records, the process tracer
records span trees too (nothing else), as ``record_function`` ranges
would: each span's times convert to the trace's clock
(``Span.wall_ns``), so the profile's kernels and idle gaps can be put
down to the spans open at the time.

Exporters: ``export_metrics(path)`` (JSONL), ``export_trace(path)``
(JSONL span trees), ``prometheus_text()``. ``snapshot()`` returns the
JSON-ready summary (span aggregates, metric totals, event count).

The predicted-vs-measured layer lives in :mod:`repro_torch.telemetry.drift`
(:class:`CommitSample` / :class:`DriftLedger`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, default_buckets
from .spans import NULL_SPAN, Span, SpanTracer

_REGISTRY = MetricsRegistry()
_TRACER = SpanTracer(registry=_REGISTRY)


def get_tracer() -> SpanTracer:
    return _TRACER


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _TRACER.enabled


def recording() -> bool:
    """Whether spans are being made now: telemetry is enabled, or a
    ``torch.profiler`` session records."""
    return _TRACER.recording


def enable() -> None:
    """Turn telemetry on process-wide (spans, metrics, sync points)."""
    _TRACER.enabled = True
    _REGISTRY.enabled = True


def disable() -> None:
    _TRACER.enabled = False
    _REGISTRY.enabled = False


def reset() -> None:
    """Drop all recorded spans/metrics/events (enabled flag unchanged)."""
    _TRACER.reset()
    _REGISTRY.reset()


# -- hot-path API (delegates to the process singletons) --------------------

def span(name: str, **attrs: Any):
    return _TRACER.span(name, **attrs)


def record(name: str, t_start: float, t_end: float, **attrs: Any) -> None:
    """A closed interval of this thread (``SpanTracer.record``)."""
    _TRACER.record(name, t_start, t_end, **attrs)


def device_sync(x: Any, name: str = "device_sync") -> Any:
    return _TRACER.device_sync(x, name=name)


def counter(name: str, **labels: Any) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, bounds=None, **labels: Any) -> Histogram:
    return _REGISTRY.histogram(name, bounds=bounds, **labels)


def event(name: str, **fields: Any) -> None:
    _REGISTRY.event(name, **fields)


# -- reporting -------------------------------------------------------------

def snapshot() -> Dict[str, Any]:
    """JSON-ready state: span summary + metric totals + event count."""
    out = _REGISTRY.snapshot()
    out["spans"] = _TRACER.summary()
    return out


def export_metrics(path: str) -> int:
    """Write all metrics + audit events as JSONL; returns line count."""
    return _REGISTRY.export_jsonl(path)


def export_trace(path: str) -> int:
    """Write retained span trees as JSONL; returns tree count."""
    return _TRACER.export_trace(path)


def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()


# Imported last: instrument.py pulls get_tracer/get_registry from here.
from .drift import CommitSample, DriftLedger, commit_sample          # noqa: E402
from .instrument import (instrument_forward, record_commit,          # noqa: E402
                         record_streaming_traffic)

__all__ = [
    "Span", "SpanTracer", "NULL_SPAN",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_buckets",
    "CommitSample", "DriftLedger", "commit_sample",
    "get_tracer", "get_registry", "enabled", "recording", "enable",
    "disable", "reset", "span", "record", "device_sync", "counter", "gauge",
    "histogram", "event",
    "snapshot", "export_metrics", "export_trace", "prometheus_text",
    "instrument_forward", "record_commit", "record_streaming_traffic",
]
