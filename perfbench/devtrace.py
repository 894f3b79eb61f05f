"""What the profiler saw over the profiled steps of a traced run.

The steps run under ``torch.profiler`` with its CUDA activity alone
(kernels, copies and the host's CUDA calls; recording every host op as
well doubles a step), a marker kernel on the stream before the first
step and after each. The trace is exported to a temporary file under
``TMPDIR``, read and deleted.

Each kernel is matched to its launch by the trace's correlation id, and
so to the host thread that launched it. Within a step, the main thread's
kernels launched before the autograd thread's first launch are the
forward, the autograd thread's are the backward, and the main thread's
after the autograd thread's last launch are what follows the backward:
for a training step the optimizer (the split of the port's
``chip_smoke.py`` ``phase_ms``, copied).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def export_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def _merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The profiled stretch: its window, device operations, and each
    kernel's step and phase. Times in microseconds of the trace.

    The stretch is bounded on the stream by marker kernels (``MARKER``),
    one before the first step and one after each: the window runs from
    the first marker's start to the last one's end, and step i's host
    launches lie between the launches of markers i and i + 1, on the
    thread that launched the markers."""

    def __init__(self, events: list, n_steps: int):
        self.n_steps = n_steps
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        self.calls = [e for e in events
                      if e.get("cat") in LAUNCH_CATS and "dur" in e]
        ops = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        marks = sorted((e for e in ops if e["cat"] == "kernel"
                        and MARKER in e["name"]), key=lambda e: e["ts"])
        self.ops = [e for e in ops if MARKER not in e["name"]]
        self.kernels = [e for e in self.ops if e["cat"] == "kernel"]
        self.window = None
        self.phase = {}
        hosts = [launch.get(m.get("args", {}).get("correlation"))
                 for m in marks]
        if len(marks) < 2 or None in hosts:
            return
        self.window = (marks[0]["ts"], marks[-1]["ts"] + marks[-1]["dur"])
        main = hosts[0]["tid"]
        for i, (lo, hi) in enumerate(zip(hosts, hosts[1:])):
            mine = []
            for k in self.kernels:
                src = launch.get(k.get("args", {}).get("correlation"))
                if src is not None and lo["ts"] < src["ts"] < hi["ts"]:
                    mine.append((src["ts"], src["tid"], k))
            other = [ts for ts, t, _ in mine if t != main]
            if not other:
                continue
            first, last = min(other), max(other)
            for ts, t, k in mine:
                self.phase[id(k)] = (i, "backward" if t != main else
                                     "forward" if ts < first else
                                     "after" if ts > last else "between")

    def phase_us(self, *phases: str):
        """Kernel microseconds in ``phases`` over the profiled steps, or
        None where no step could be split."""
        if not self.phase:
            return None
        return sum(k["dur"] for k in self.kernels
                   if self.phase.get(id(k), (0, None))[1] in phases)

    def busy_us(self) -> float:
        """Microseconds of the window in which a device operation ran."""
        lo, hi = self.window
        spans = _merged([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                         for e in self.ops])
        return sum(max(0.0, b - a) for a, b in spans)

    def top_ops(self, n: int = 10) -> list:
        """[[kernel or copy name, seconds]] of the device operations that
        took most time over the stretch."""
        by = {}
        for e in self.ops:
            key = kernel_name(e["name"])
            by[key] = by.get(key, 0.0) + e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """[[what the host was doing, idle seconds]]: every gap in the
        window with no device operation, named by the CUDA call that a
        host thread was in at its middle (``host code`` where none was:
        Python and PyTorch's dispatch), summed by that name."""
        lo, hi = self.window
        spans = _merged([(e["ts"], e["ts"] + e["dur"]) for e in self.ops])
        edges = [lo] + [x for s in spans for x in s] + [hi]
        calls = sorted(self.calls, key=lambda e: e["ts"])
        starts = [e["ts"] for e in calls]
        longest = max((e["dur"] for e in calls), default=0.0)
        by = {}
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid)
            name = "host code"
            while j > 0 and starts[j - 1] >= mid - longest:
                j -= 1
                if calls[j]["ts"] + calls[j]["dur"] >= mid:
                    name = calls[j]["name"]
                    break
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]
