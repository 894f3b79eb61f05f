"""Device time and idle time of the profiled steps, put down to the
program's spans.

While ``torch.profiler`` records, the program's tracer
(``repro_torch.telemetry``) records its span trees: each training step's
``train.step`` and its phases on the main thread, ``model.mixer`` inside
the forward, and the ``model.mixer.backward`` intervals on the autograd
engine's thread. A span's times convert to the wall clock by the
(steady, wall) pair its root took (``Span.wall_ns``). The trace's times are
microseconds after its ``baseTimeNanoseconds``, which Kineto takes as the
wall clock rounded down to ``KINETO_BASE_S`` seconds: the base is that
multiple nearest to the first root's wall time less the trace's first
marker. The marker launches witness the join: each lies between the end
of one step's root and the start of the next.

- A kernel belongs to the innermost span open on its launch's thread at
  the launch's ``ts`` (the launch found by the correlation id); where none
  is open there, to the innermost open on the thread that holds the steps'
  roots.
- An idle gap (no device operation, inside the markers' window) belongs to
  the innermost span open at its middle on a thread other than the roots'
  (the autograd thread's), else on the roots' thread.

The trace's ``tid`` of a CUDA call is its thread's ``pthread_self()``
cut to a signed 32-bit integer and written without its sign (``trace_tid``;
seen on the card: the main thread's 2,982,937,344 as 1,312,029,952, the
autograd thread's 92,272,320 as itself); the profiler's own host events
carry the native id. A span records both of its thread's.
"""
from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass

from . import devtrace

KINETO_BASE_S = 7_889_238
MIXER = ("model.mixer", "model.mixer.backward")
OPTIMIZER = ("train.optimizer",)
ROOT = "train.step"


@dataclass(frozen=True)
class Rec:
    """One span in the trace's microseconds: its thread (the trace's tid)
    and the names from its root down to it."""
    name: str
    start: float
    end: float
    thread: int
    path: tuple

    @property
    def depth(self) -> int:
        return len(self.path)


def _walk(span, path=()):
    path = path + (span.name,)
    yield span, path
    for c in span.children:
        yield from _walk(c, path)


def trace_tid(ident: int) -> int:
    """The trace's ``tid`` of the thread whose ``threading.get_ident()``
    is ``ident``: its ``pthread_self()`` cut to a signed 32-bit integer,
    written without its sign."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def _thread_ids(span) -> tuple:
    return (trace_tid(getattr(span, "ident", 0) or 0),
            getattr(span, "tid", 0))


def marker_launches(trace: "devtrace.Trace") -> list:
    """The launch calls of the markers, by time: the kernel launches whose
    correlation id no device operation of the trace carries (``Trace``
    leaves the markers out of its operations)."""
    ops = {e.get("args", {}).get("correlation") for e in trace.ops}
    return sorted((e for e in trace.calls if "LaunchKernel" in e["name"]
                   and e.get("args", {}).get("correlation") not in ops),
                  key=lambda e: e["ts"])


def program_records(trace: "devtrace.Trace", roots: list) -> list:
    """``roots`` (the program's span trees) as ``Rec`` in the trace's
    microseconds, those that overlap the markers' window; [] where the
    trees carry no clock (a program whose tracer has none) or the trace no
    window."""
    roots = [r for r in roots if getattr(r, "clock", None) is not None]
    marks = marker_launches(trace)
    if not roots or trace.window is None or not marks:
        return []
    period = KINETO_BASE_S * 10 ** 9
    first = min(roots, key=lambda r: r.t_start)
    guess = first.wall_ns(first.t_start) - marks[0]["ts"] * 1e3
    base = round(guess / period) * period
    tids = {e["tid"] for e in trace.calls}
    out = []
    for root in roots:
        for sp, path in _walk(root):
            thread = next((t for t in _thread_ids(sp) if t in tids),
                          sp.tid)
            out.append(Rec(sp.name, (sp.wall_ns(sp.t_start) - base) / 1e3,
                           (sp.wall_ns(sp.t_end) - base) / 1e3, thread,
                           path))
    return [r for r in out
            if r.end > marks[0]["ts"] and r.start < trace.window[1]]


class _Thread:
    """The innermost span open at any time on one thread."""

    def __init__(self, recs: list):
        self.points = sorted({r.start for r in recs} | {r.end for r in recs})
        self.inner = []
        for a, b in zip(self.points, self.points[1:]):
            mid = (a + b) / 2
            live = [r for r in recs if r.start <= mid < r.end]
            self.inner.append(max(live, key=lambda r: (r.depth, r.start))
                              if live else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.points, t) - 1
        return self.inner[i] if 0 <= i < len(self.inner) else None


class Attribution:
    """Kernel and idle microseconds of a trace by the innermost span, over
    ``n_steps`` profiled steps."""

    def __init__(self, trace: "devtrace.Trace", recs: list):
        self.trace, self.recs, self.n = trace, recs, trace.n_steps
        threads = {}
        for r in recs:
            threads.setdefault(r.thread, []).append(r)
        self.threads = {t: _Thread(rs) for t, rs in threads.items()}
        roots = [r.thread for r in recs if r.depth == 1 and r.name == ROOT]
        self.root_thread = max(set(roots), key=roots.count) if roots \
            else None
        launch = {e["args"]["correlation"]: e for e in trace.calls
                  if "correlation" in e.get("args", {})}
        self.kernel = []        # [(Rec or None, us)]
        for k in trace.kernels:
            src = launch.get(k.get("args", {}).get("correlation"))
            rec = None if src is None else self._at(src["tid"], src["ts"])
            if rec is None and src is not None:
                rec = self._at(self.root_thread, src["ts"])
            self.kernel.append((rec, k["dur"]))
        self.idle = []          # [(Rec or None, us)]
        lo, hi = trace.window
        busy = devtrace._merged([(e["ts"], e["ts"] + e["dur"])
                                 for e in trace.ops])
        edges = [lo] + [x for s in busy for x in s] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                self.idle.append((self._idle_at((a + b) / 2), b - a))

    def _at(self, thread, t):
        th = self.threads.get(thread)
        return None if th is None else th.at(t)

    def _idle_at(self, t):
        others = [self._at(th, t) for th in self.threads
                  if th != self.root_thread]
        others = [r for r in others if r is not None]
        if others:
            return max(others, key=lambda r: r.depth)
        return self._at(self.root_thread, t)

    @staticmethod
    def _sum_ms(pairs, names, n) -> float:
        return sum(us for rec, us in pairs
                   if rec is not None and set(rec.path) & set(names)) \
            / 1e3 / n

    def kernel_ms(self, *names) -> float:
        """Kernel ms a step launched inside a span of ``names`` (or one of
        its descendants)."""
        return self._sum_ms(self.kernel, names, self.n)

    def idle_ms(self, *names) -> float:
        """Device-idle ms a profiled step whose gap falls inside a span of
        ``names`` (or one of its descendants)."""
        return self._sum_ms(self.idle, names, self.n)

    def by_span(self) -> list:
        """[[innermost span's name, kernel ms a step, idle ms a step]],
        most idle first; ``(no span)`` for what no span holds."""
        by = {}
        for i, pairs in enumerate((self.kernel, self.idle)):
            for rec, us in pairs:
                key = "(no span)" if rec is None else rec.name
                by.setdefault(key, [0.0, 0.0])[i] += us / 1e3 / self.n
        return sorted(([k, v[0], v[1]] for k, v in by.items()),
                      key=lambda x: -x[2])

    def step_share(self) -> float:
        """The share of all kernel time launched inside a step's root or
        its descendants."""
        total = sum(us for _, us in self.kernel)
        inside = sum(us for rec, us in self.kernel
                     if rec is not None and rec.path[0] == ROOT)
        return inside / total if total else 0.0

    def join_witness(self):
        """(marker launches inside their bracket, all of them, the largest
        distance in us by which one falls outside, the narrowest bracket's
        room in us): marker i's launch lies between the end of root i - 1
        and the start of root i, on the roots' thread."""
        marks = marker_launches(self.trace)
        roots = sorted((r for r in self.recs
                        if r.depth == 1 and r.name == ROOT),
                       key=lambda r: r.start)
        if len(marks) != len(roots) + 1:
            return None
        inside, worst, room = 0, 0.0, float("inf")
        for i, m in enumerate(marks):
            lo = roots[i - 1].end if i else -float("inf")
            hi = roots[i].start if i < len(roots) else float("inf")
            out = max(lo - m["ts"], m["ts"] + m["dur"] - hi, 0.0)
            inside += out == 0.0
            worst = max(worst, out)
            room = min(room, hi - lo - m["dur"])
        return inside, len(marks), worst, room


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def of(ctx):
    """The ``Attribution`` of a traced run's profiled steps, made once per
    run and logged to standard error; None on the CPU, without a trace, or
    where the program recorded no span there. ``ctx.spans``, where given,
    holds the ``Rec`` in place of the program's tracer."""
    t = ctx.trace
    if not ctx.cuda or t is None or t.window is None or not t.kernels:
        return None
    cached = getattr(ctx, "span_attribution", None)
    if cached is not None and cached[0] is t:
        return cached[1]
    recs = getattr(ctx, "spans", None)
    if recs is None:
        from repro_torch import telemetry
        recs = program_records(t, list(telemetry.get_tracer().roots))
    a = Attribution(t, recs) if recs else None
    ctx.span_attribution = (t, a)
    if a is not None:
        _report(a)
    return a


def _report(a: Attribution) -> None:
    rows = "; ".join(f"{name} {k:.3f} / {i:.3f}"
                     for name, k, i in a.by_span())
    _log(f"by span, kernel ms / idle ms a profiled step: {rows}")
    _log(f"kernel time inside {ROOT} and its spans: "
         f"{100 * a.step_share():.3f} %")
    w = a.join_witness()
    if w is None:
        _log("clock join: the markers do not bracket the steps' roots")
    else:
        _log(f"clock join: {w[0]} of {w[1]} marker launches inside their "
             f"bracket, the worst {w[2]:.3f} us outside, the narrowest "
             f"bracket {w[3]:.3f} us of room")
