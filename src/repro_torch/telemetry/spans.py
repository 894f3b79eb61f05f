"""Low-overhead span tracer producing nested span trees (DESIGN.md §14).

The counterpart of ``repro.telemetry.spans``. A span is one timed node:
``with tracer.span("halo.gather", bucket=3):``. Spans nest lexically via a
per-tracer stack; completed top-level spans are retained in a bounded ring
so long serving runs cannot grow without bound, while a per-name aggregate
(count/total/max) survives ring eviction.

Design constraints:

- When the tracer is disabled, ``span()`` returns a shared immutable
  ``NULL_SPAN`` singleton whose enter/exit/set/add_bytes are no-ops — the
  disabled cost of an instrumented call site is one attribute load and one
  method call, no allocation.
- Spans never force device synchronisation by themselves. CUDA launches
  are asynchronous, so a span around a kernel call measures its *launch*
  only; call sites that want the device work billed to a span use
  ``tracer.device_sync(x)``, which synchronises every CUDA device ``x``
  lives on inside a dedicated child span — and only when tracing is
  enabled, so disabling telemetry also removes the sync points.
- With ``profiler_annotations=True`` each span also enters a
  ``torch.profiler.record_function`` of its name, so spans land as ranges
  in ``torch.profiler`` traces beside the kernels they launched.

Bytes accounting: ``Span.add_bytes`` attaches wire bytes to a span and
``Span.total_bytes()`` sums a subtree. The instrumentation layer
(telemetry/instrument.py) bills bytes from the same send/recv tables that
``distributed.traffic`` uses, so span-tree totals equal
``ExecutionPlan.measured_traffic`` exactly — by construction.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "SpanTracer", "NULL_SPAN"]


class Span:
    """One timed node of a span tree (also its own context manager)."""

    __slots__ = ("name", "attrs", "t_start", "t_end", "children", "_tracer", "_ann")

    def __init__(self, name: str, tracer: "Optional[SpanTracer]" = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.t_start = 0.0
        self.t_end = 0.0
        self.children: List[Span] = []
        self._tracer = tracer
        self._ann = None

    # -- attribute / bytes helpers -------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_bytes(self, n: int) -> "Span":
        self.attrs["bytes"] = int(self.attrs.get("bytes", 0)) + int(n)
        return self

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def total_bytes(self) -> int:
        """Sum of ``bytes`` attrs over this span and all descendants."""
        return int(self.attrs.get("bytes", 0)) + sum(
            c.total_bytes() for c in self.children
        )

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "t_start": self.t_start,
            "duration_s": self.duration_s,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    # -- context manager -----------------------------------------------
    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr is not None:
            if tr._stack:
                tr._stack[-1].children.append(self)
            tr._stack.append(self)
            if tr.profiler_annotations:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t_end = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            finally:
                self._ann = None
        tr = self._tracer
        if tr is not None:
            tr._close(self)
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
            f"children={len(self.children)}, attrs={self.attrs})"
        )


class _NullSpan:
    """Shared no-op span returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def add_bytes(self, n: int) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def _cuda_devices(x: Any, out: set) -> None:
    """Collect the indices of the CUDA devices the tensors of ``x`` (a
    tensor, or a list, tuple or dict of them) live on."""
    if isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    else:
        dev = getattr(x, "device", None)
        if getattr(dev, "type", None) == "cuda":
            out.add(dev.index if dev.index is not None else 0)


class SpanTracer:
    """Produces span trees; keeps a bounded ring of completed root spans.

    Parameters
    ----------
    enabled:
        When False (default) ``span()`` returns ``NULL_SPAN`` and
        ``device_sync`` is an identity — the instrumented hot paths pay
        only a flag check.
    profiler_annotations:
        Mirror every span into ``torch.profiler.record_function`` so spans
        show up as ranges in ``torch.profiler`` traces.
    max_roots:
        Ring-buffer capacity for completed top-level span trees.
    registry:
        Optional ``MetricsRegistry``; on span exit the duration is recorded
        into a ``span_seconds{span=<name>}`` histogram so p50/p95/p99 per
        span name fall out of tracing with no second instrumentation pass.
    """

    def __init__(self, enabled: bool = False,
                 profiler_annotations: bool = False,
                 max_roots: int = 256, registry: Any = None):
        self.enabled = bool(enabled)
        self.profiler_annotations = bool(profiler_annotations)
        self.registry = registry
        self.roots: deque = deque(maxlen=int(max_roots))
        self._stack: List[Span] = []
        # name -> [count, total_s, max_s]; survives ring eviction.
        self._agg: Dict[str, List[float]] = {}

    # -- span creation ---------------------------------------------------
    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            return NULL_SPAN
        return Span(name, tracer=self, attrs=attrs or None)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def _close(self, sp: Span) -> None:
        # With-blocks guarantee LIFO order per thread; tolerate a foreign
        # top-of-stack (e.g. tracer reset mid-span) by searching.
        stack = self._stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # pragma: no cover - defensive
            stack.remove(sp)
        if not stack:
            self.roots.append(sp)
        agg = self._agg.get(sp.name)
        dur = sp.duration_s
        if agg is None:
            self._agg[sp.name] = [1, dur, dur]
        else:
            agg[0] += 1
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
        reg = self.registry
        if reg is not None:
            reg.histogram("span_seconds", span=sp.name).observe(dur)

    # -- device sync -------------------------------------------------------
    def device_sync(self, x: Any, name: str = "device_sync") -> Any:
        """Wait until the device work behind ``x`` is done, inside a span.

        ``x`` is a tensor or a list, tuple or dict of them (nested); every
        CUDA device a tensor of ``x`` lives on is synchronised once, and
        CPU tensors pass through. Returns ``x``. CUDA launches are
        asynchronous: without the sync, device time leaks out of the span
        that launched it. No-op pass-through when the tracer is disabled,
        so disabling telemetry also removes the serialization points.
        """
        if not self.enabled:
            return x
        with self.span(name):
            devices = set()
            _cuda_devices(x, devices)
            if devices:
                import torch

                for dev in sorted(devices):
                    torch.cuda.synchronize(dev)
            return x

    # -- reporting ---------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregate over every completed span (incl. evicted)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, (count, total, mx) in sorted(self._agg.items()):
            out[name] = {
                "count": int(count),
                "total_s": float(total),
                "mean_s": float(total / count) if count else 0.0,
                "max_s": float(mx),
            }
        return out

    def export_trace(self, path: str) -> int:
        """Write retained root span trees as JSONL; returns tree count."""
        n = 0
        with open(path, "w") as fh:
            for root in self.roots:
                fh.write(json.dumps(root.to_dict()) + "\n")
                n += 1
        return n

    def reset(self) -> None:
        self.roots.clear()
        self._stack.clear()
        self._agg.clear()
