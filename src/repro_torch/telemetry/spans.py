"""Low-overhead span tracer producing nested span trees (DESIGN.md §14).

The counterpart of ``repro.telemetry.spans``. A span is one timed node:
``with tracer.span("halo.gather", bucket=3):``. Spans nest lexically via a
stack per thread; completed top-level spans are retained in a bounded
ring so long serving runs cannot grow without bound, while a per-name
aggregate (count/total/max) survives ring eviction.

Design constraints:

- When the tracer is not recording, ``span()`` returns a shared immutable
  ``NULL_SPAN`` singleton whose enter/exit/set/add_bytes are no-ops — the
  disabled cost of an instrumented call site is one flag check and one
  method call, no allocation.
- Spans never force device synchronisation by themselves. CUDA launches
  are asynchronous, so a span around a kernel call measures its *launch*
  only; call sites that want the device work billed to a span use
  ``tracer.device_sync(x)``, which synchronises every CUDA device ``x``
  lives on inside a dedicated child span — and only when tracing is
  enabled, so disabling telemetry also removes the sync points.
- The tracer records while it is ``enabled`` and, unless
  ``follow_profiler`` is cleared, while a ``torch.profiler`` session
  records, as a ``record_function`` range would; ``device_sync`` stays
  off unless ``enabled``.

Threads: each thread has its own stack, so a span opened on the autograd
engine's thread never nests under what the main thread holds. A thread
with nothing open nests its spans under the tracer's ``anchor``, the span
that called ``anchor()`` and is still open (the training step's
``train.backward``), and so do the closed intervals that ``record()``
takes from hooks that do not nest lexically (a gradient hook opens, a
later one closes). Every span records its parent, the step id of its root
(the root's ``step`` attribute), and its thread's native id and
``threading.get_ident()``.

Clock: ``t_start`` / ``t_end`` are ``time.perf_counter()`` seconds; each
root also takes one (``perf_counter``, ``time.time_ns``) pair as it opens,
so ``Span.wall_ns(t)`` puts any time of its tree on the wall clock, the
clock of ``torch.profiler``'s trace (an event's ``ts`` plus the trace's
``baseTimeNanoseconds``).

Bytes accounting: ``Span.add_bytes`` attaches wire bytes to a span and
``Span.total_bytes()`` sums a subtree. The instrumentation layer
(telemetry/instrument.py) bills bytes from the same send/recv tables that
``distributed.traffic`` uses, so span-tree totals equal
``ExecutionPlan.measured_traffic`` exactly — by construction.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch.autograd.profiler as _torch_profiler

__all__ = ["Span", "SpanTracer", "NULL_SPAN"]


class Span:
    """One timed node of a span tree (also its own context manager)."""

    __slots__ = ("name", "attrs", "t_start", "t_end", "children", "parent",
                 "step", "tid", "ident", "clock", "_anchors", "_tracer")

    def __init__(self, name: str, tracer: "Optional[SpanTracer]" = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.t_start = 0.0
        self.t_end = 0.0
        self.children: List[Span] = []
        self.parent: Optional[Span] = None
        self.step = None
        self.tid = 0
        self.ident = 0
        self.clock = None
        self._anchors = False
        self._tracer = tracer

    # -- attribute / bytes helpers -------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_bytes(self, n: int) -> "Span":
        self.attrs["bytes"] = int(self.attrs.get("bytes", 0)) + int(n)
        return self

    def anchor(self) -> "Span":
        """Make this span, while it is open, the tracer's anchor: the
        parent of the spans and intervals of threads with nothing open.
        Returns the span."""
        self._anchors = True
        return self

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def root(self) -> "Span":
        sp = self
        while sp.parent is not None:
            sp = sp.parent
        return sp

    def wall_ns(self, t: float) -> int:
        """``t`` (``perf_counter`` seconds of this span's tree) on the wall
        clock, ``time.time_ns()``, by the pair its root took as it
        opened."""
        perf, wall = self.root().clock
        return wall + round((t - perf) * 1e9)

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
            "tid": self.tid,
        }
        if self.root().clock is not None:
            d["wall_ns"] = self.wall_ns(self.t_start)
        if self.step is not None:
            d["step"] = self.step
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    # -- context manager -----------------------------------------------
    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr is not None:
            tr._open(self)
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t_end = time.perf_counter()
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
    """Shared no-op span returned by a tracer that is not recording."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def add_bytes(self, n: int) -> "_NullSpan":
        return self

    def anchor(self) -> "_NullSpan":
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
        When False (default) ``span()`` returns ``NULL_SPAN`` unless a
        ``torch.profiler`` session records, and ``device_sync`` is an
        identity — the instrumented hot paths pay only a flag check.
        While a profiler records, spans are made (``follow_profiler``,
        an attribute, set), so a profile can be put down to the spans
        open as its kernels were launched.
    max_roots:
        Ring-buffer capacity for completed top-level span trees.
    registry:
        Optional ``MetricsRegistry``; on span exit the duration is recorded
        into a ``span_seconds{span=<name>}`` histogram so p50/p95/p99 per
        span name fall out of tracing with no second instrumentation pass.
    """

    def __init__(self, enabled: bool = False, max_roots: int = 256,
                 registry: Any = None):
        self.enabled = bool(enabled)
        self.follow_profiler = True
        self.registry = registry
        self.roots: deque = deque(maxlen=int(max_roots))
        self.anchor: Optional[Span] = None
        self._local = threading.local()
        # name -> [count, total_s, max_s]; survives ring eviction. Spans
        # close on more than one thread (the autograd engine's too).
        self._agg: Dict[str, List[float]] = {}
        self._agg_lock = threading.Lock()

    @property
    def recording(self) -> bool:
        """Whether ``span()`` and ``record()`` make spans now."""
        return self.enabled or (self.follow_profiler
                                and _torch_profiler._is_profiler_enabled)

    # -- span creation ---------------------------------------------------
    def span(self, name: str, **attrs: Any):
        if not self.recording:
            return NULL_SPAN
        return Span(name, tracer=self, attrs=attrs or None)

    def record(self, name: str, t_start: float, t_end: float,
               **attrs: Any) -> None:
        """A closed interval (``perf_counter`` seconds) of this thread, as
        a span under what this thread holds open, else under the anchor:
        for hooks that open and close a span in separate calls."""
        if not self.recording:
            return
        sp = Span(name, tracer=self, attrs=attrs or None)
        self._adopt(sp)
        sp.t_start, sp.t_end = t_start, t_end
        self._finish(sp)

    def _thread(self) -> threading.local:
        """This thread's stack and ids (the native id read once: it is a
        system call)."""
        here = self._local
        if not hasattr(here, "stack"):
            here.stack = []
            here.tid = threading.get_native_id()
            here.ident = threading.get_ident()
        return here

    def _stack(self) -> List[Span]:
        return self._thread().stack

    def current(self) -> Optional[Span]:
        """The innermost span this thread holds open."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _adopt(self, sp: Span) -> None:
        here = self._thread()
        parent = (here.stack[-1] if here.stack else None) or self.anchor
        sp.parent = parent
        sp.tid = here.tid
        sp.ident = here.ident
        if parent is None:
            sp.step = sp.attrs.get("step")
            sp.clock = (time.perf_counter(), time.time_ns())
        else:
            sp.step = parent.step
            parent.children.append(sp)

    def _open(self, sp: Span) -> None:
        self._adopt(sp)
        self._stack().append(sp)
        if sp._anchors:
            self.anchor = sp

    def _close(self, sp: Span) -> None:
        # With-blocks guarantee LIFO order per thread; tolerate a foreign
        # top-of-stack (e.g. tracer reset mid-span) by searching.
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # pragma: no cover - defensive
            stack.remove(sp)
        if self.anchor is sp:
            self.anchor = None
        self._finish(sp)

    def _finish(self, sp: Span) -> None:
        if sp.parent is None:
            self.roots.append(sp)
        dur = sp.duration_s
        with self._agg_lock:
            agg = self._agg.get(sp.name)
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
        self.anchor = None
        self._local = threading.local()
        self._agg.clear()
