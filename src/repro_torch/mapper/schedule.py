"""Pass schedules: turn per-core allocations into an executable timeline.

A copy of ``repro.mapper.schedule``, so that the port needs nothing of
the JAX package.

A ``PassSchedule`` is the ordered crossbar-pass program of one inference on
one device: per pipeline stage (traversal → aggregation → feature
extraction), how many serialized pass rounds run and how long one round
takes. Two latency views:

  * ``t_serial``    — stages back-to-back, Σ rounds_i x t_pass_i. This is
    the Eq. 1-compatible number the cost model's calibrated path also
    computes, so it is the cross-validation anchor.
  * ``t_pipelined`` — stages overlapped wave-by-wave (the paper's cores
    form a pipeline, Fig. 1): bottleneck-stage drain plus one fill pass of
    every other stage. Always <= t_serial; the gap is the pipelining
    headroom the mapper exposes.

Round counts can reach millions on big graphs (LiveJournal centralized), so
the timeline is generated lazily — ``slots(limit)`` enumerates the first
``limit`` concrete passes and summarizes the tail.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: a core's serialized pass rounds."""
    name: str
    rounds: int
    t_pass: float           # seconds per serialized round
    arrays_busy: int        # arrays active in a full round

    @property
    def latency(self) -> float:
        return self.rounds * self.t_pass


@dataclasses.dataclass(frozen=True)
class PassSlot:
    """One concrete pass in the serialized timeline."""
    step: int
    stage: str
    round_index: int
    t_start: float
    t_end: float


@dataclasses.dataclass(frozen=True)
class PassSchedule:
    stages: tuple

    @property
    def total_rounds(self) -> int:
        return sum(s.rounds for s in self.stages)

    @property
    def t_serial(self) -> float:
        return sum(s.latency for s in self.stages)

    @property
    def t_pipelined(self) -> float:
        live = [s for s in self.stages if s.rounds > 0]
        if not live:
            return 0.0
        bottleneck = max(s.latency for s in live)
        fill = sum(s.t_pass for s in live) - max(
            s.t_pass for s in live if s.latency == bottleneck)
        return bottleneck + fill

    def slots(self, limit: int = 64) -> Iterator[PassSlot]:
        """Lazily enumerate the serial timeline's first ``limit`` passes."""
        t = 0.0
        step = 0
        for s in self.stages:
            for r in range(s.rounds):
                if step >= limit:
                    return
                yield PassSlot(step, s.name, r, t, t + s.t_pass)
                t += s.t_pass
                step += 1

    def describe(self, limit: int = 8) -> str:
        lines = [f"{'stage':14s} {'rounds':>10s} {'t_pass':>11s} "
                 f"{'latency':>11s} {'arrays':>7s}"]
        for s in self.stages:
            lines.append(f"{s.name:14s} {s.rounds:10d} {s.t_pass:11.3e} "
                         f"{s.latency:11.3e} {s.arrays_busy:7d}")
        lines.append(f"serial {self.t_serial:.3e} s, "
                     f"pipelined {self.t_pipelined:.3e} s "
                     f"({self.total_rounds} rounds)")
        shown = list(self.slots(limit))
        if shown:
            lines.append(f"first {len(shown)} passes: " + ", ".join(
                f"{p.stage}[{p.round_index}]@{p.t_start:.2e}s"
                for p in shown[:limit]))
            tail = self.total_rounds - len(shown)
            if tail > 0:
                lines.append(f"... {tail} more rounds")
        return "\n".join(lines)


def build_schedule(allocations, t_passes) -> PassSchedule:
    """Zip per-core ``CoreAllocation``s with per-round latencies.

    ``allocations``: iterable of CoreAllocation in pipeline order;
    ``t_passes``: matching per-round latencies [s].
    """
    stages = tuple(
        Stage(a.core, a.rounds, t, a.arrays_used)
        for a, t in zip(allocations, t_passes))
    return PassSchedule(stages)
