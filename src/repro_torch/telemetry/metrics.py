"""Metrics registry: counters, gauges, log-bucket histograms, audit events.

A copy of ``repro.telemetry.metrics`` (pure Python), so that the port
needs nothing of the JAX package.

Metric instances are created on first use and keyed by ``(name, labels)``;
repeated ``registry.counter("halo.shipped_bytes", setting="semi")`` calls
return the same object, so hot paths may look metrics up per call without
caching handles.  Every mutation is gated on ``registry.enabled`` so a
disabled registry costs one flag check per operation.

Histograms use fixed log-spaced buckets (default 4/decade over
1 µs … 100 s — wide enough for both a single query dispatch and a cold
kernel build) and report p50/p95/p99 by log-linear interpolation inside the
matched bucket.  Fixed buckets keep ``observe`` O(log n_buckets) with zero
allocation, and make histograms mergeable across exports.

Exporters: ``export_jsonl`` (one JSON object per metric/event line) and
``prometheus_text`` (text exposition format; histograms emit cumulative
``_bucket{le=...}`` lines).
"""

from __future__ import annotations

import json
import math
import re
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "default_buckets"]

_LabelKey = Tuple[str, Tuple[Tuple[str, Any], ...]]


def default_buckets(lo: float = 1e-6, hi: float = 100.0,
                    per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    n_dec = math.log10(hi / lo)
    n = int(round(n_dec * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


_DEFAULT_BOUNDS = default_buckets()


class _Metric:
    __slots__ = ("name", "labels", "_reg")

    def __init__(self, name: str, labels: Tuple[Tuple[str, Any], ...],
                 reg: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._reg = reg


class Counter(_Metric):
    """Monotonically increasing value."""

    __slots__ = ("value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if self._reg.enabled:
            self.value += n


class Gauge(_Metric):
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self.value = 0.0

    def set(self, v: float) -> None:
        if self._reg.enabled:
            self.value = float(v)


class Histogram(_Metric):
    """Fixed log-spaced-bucket histogram with interpolated percentiles."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, name, labels, reg, bounds: Tuple[float, ...] = _DEFAULT_BOUNDS):
        super().__init__(name, labels, reg)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1 overflow bucket
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """q in [0, 1]; log-linear interpolation inside the matched bucket."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                # Bucket i spans (lower, upper]; interpolate in log space.
                if i >= len(self.bounds):  # overflow bucket
                    return self.vmax
                upper = self.bounds[i]
                lower = self.bounds[i - 1] if i > 0 else upper / 10.0
                frac = (rank - prev) / c
                lo = max(lower, self.vmin if self.vmin > 0 else lower)
                hi = min(upper, self.vmax) if self.vmax >= lo else upper
                if lo <= 0 or hi <= lo:
                    return hi
                return lo * (hi / lo) ** frac
        return self.vmax  # pragma: no cover - unreachable

    def quantiles(self) -> Dict[str, float]:
        return {
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def summary(self) -> Dict[str, float]:
        d: Dict[str, float] = {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
        }
        d.update(self.quantiles())
        return d


class _NullMetric:
    """Shared no-op metric returned by a disabled registry.

    Handles are looked up per call site, not cached, so a metric fetched
    while disabled simply resolves to the real instance after ``enable()``.
    """

    __slots__ = ()
    value = 0.0
    count = 0
    total = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def quantiles(self) -> Dict[str, float]:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0,
                **self.quantiles()}


_NULL_METRIC = _NullMetric()


def _label_key(name: str, labels: Dict[str, Any]) -> _LabelKey:
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: Tuple[Tuple[str, Any], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_SANITIZE.sub("_", name)


class MetricsRegistry:
    """Holds all metric instances plus an ordered audit-event log."""

    def __init__(self, enabled: bool = False, max_events: int = 4096):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self._metrics: Dict[_LabelKey, _Metric] = {}
        self.events: List[Dict[str, Any]] = []

    # -- creation / lookup ------------------------------------------------
    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        if not self.enabled:
            return _NULL_METRIC
        key = _label_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], self, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r}{dict(key[1])} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Histogram:
        if bounds is None:
            return self._get(Histogram, name, labels)
        return self._get(Histogram, name, labels, bounds=bounds)

    def event(self, name: str, **fields: Any) -> None:
        """Append a structured audit record (planner decisions, replans)."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            del self.events[: self.max_events // 2]
        self.events.append({"event": name, **fields})

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view: counter/gauge totals + histogram summaries."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, float]] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _label_str(labels)
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = m.value
            elif isinstance(m, Histogram):
                hists[key] = m.summary()
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "n_events": len(self.events),
        }

    def export_jsonl(self, path: str) -> int:
        """One JSON line per metric and per event; returns line count."""
        n = 0
        with open(path, "w") as fh:
            for (name, labels), m in sorted(self._metrics.items()):
                rec: Dict[str, Any] = {"name": name, "labels": dict(labels)}
                if isinstance(m, Histogram):
                    rec["type"] = "histogram"
                    rec.update(m.summary())
                else:
                    rec["type"] = type(m).__name__.lower()
                    rec["value"] = m.value
                fh.write(json.dumps(rec, default=str) + "\n")
                n += 1
            for ev in self.events:
                fh.write(json.dumps({"type": "event", **ev}, default=str) + "\n")
                n += 1
        return n

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (counters/gauges/histograms)."""
        lines: List[str] = []
        seen_types: Dict[str, str] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            pname = _prom_name(name)
            lstr = _label_str(labels)
            if isinstance(m, Counter):
                if seen_types.setdefault(pname, "counter") == "counter":
                    if f"# TYPE {pname} counter" not in lines:
                        lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname}{lstr} {m.value:g}")
            elif isinstance(m, Gauge):
                if f"# TYPE {pname} gauge" not in lines:
                    lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname}{lstr} {m.value:g}")
            elif isinstance(m, Histogram):
                if f"# TYPE {pname} histogram" not in lines:
                    lines.append(f"# TYPE {pname} histogram")
                cum = 0
                base = dict(labels)
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    ls = _label_str(tuple(sorted({**base, "le": f"{bound:g}"}.items())))
                    lines.append(f"{pname}_bucket{ls} {cum}")
                ls = _label_str(tuple(sorted({**base, "le": "+Inf"}.items())))
                lines.append(f"{pname}_bucket{ls} {m.count}")
                lines.append(f"{pname}_sum{lstr} {m.total:g}")
                lines.append(f"{pname}_count{lstr} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        self._metrics.clear()
        self.events.clear()
