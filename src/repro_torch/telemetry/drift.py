"""Typed predicted-vs-measured drift accounting (DESIGN.md §14).

A copy of ``repro.telemetry.drift`` (pure Python), so that the port needs
nothing of the JAX package.

The planner's recommendation is a prediction (costmodel latency,
traffic-evaluator bytes); serving is the measurement.  This module is the
typed boundary between the two: a :class:`CommitSample` captures what one
committed tick actually did, and a :class:`DriftLedger` accumulates samples,
maintains the early-commit baseline, and answers the two drift questions —
"is recent latency out of band?" and "are recent bytes out of band?" —
that ``planner.replan.ReplanMonitor`` used to compute from raw float lists.

Keeping the ledger here (rather than in planner/) means the serving stack
can do drift *accounting* with telemetry alone, and the planner layer only
adds the *decision* (re-plan + swap) on top.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CommitSample", "commit_sample", "DriftLedger"]


@dataclasses.dataclass(frozen=True)
class CommitSample:
    """What one committed tick measurably did.

    ``full`` marks cold starts / param swaps / bit-accurate degradations —
    ledgers skip these (they are not representative ticks; folding their
    wall-clock into the baseline would mask real drift) but count them.
    """

    seconds: float                    # commit wall-clock
    shipped_bytes: float              # incremental wire traffic this commit
    churn_frac: float                 # level-0 dirty frontier fraction
    full: bool = False                # full refresh (skipped by ledgers)
    queries: int = 0                  # lookups served since last commit
    policy: Optional[str] = None      # refresh policy the server ran under


def commit_sample(server, update) -> CommitSample:
    """Build a :class:`CommitSample` from a ``StreamingUpdate`` commit."""
    traffic = getattr(update, "traffic", None)
    frontier = getattr(update, "frontier", None)
    return CommitSample(
        seconds=float(update.seconds),
        shipped_bytes=float(traffic.total_bytes()) if traffic is not None else 0.0,
        churn_frac=float(frontier.masks[0].mean()) if frontier is not None else 0.0,
        full=bool(update.full),
        policy=getattr(server, "policy", None),
    )


class DriftLedger:
    """Rolling predicted-vs-measured ledger over commit samples.

    ``window`` controls both the baseline (median of the first ``window``
    samples) and the recency median (last ``window`` samples); drift
    checks return ``None`` until ``2 * window`` samples exist so baseline
    and recent windows never overlap.

    ``predicted_seconds`` / ``predicted_bytes`` are the model-side
    references when the planner priced them; the latency check still
    anchors to the measured early baseline (modeled crossbar/radio time
    and host wall-clock are different clocks) but both predictions are
    surfaced in :meth:`report` so the model error itself is observable.
    """

    def __init__(self, window: int = 8,
                 predicted_seconds: Optional[float] = None,
                 predicted_bytes: Optional[float] = None):
        self.window = max(int(window), 2)
        self.predicted_seconds = predicted_seconds
        self.predicted_bytes = predicted_bytes
        self.seconds: List[float] = []
        self.bytes: List[float] = []
        self.churn: List[float] = []
        self.policy: Optional[str] = None
        self.full_skipped = 0
        self._baseline_s: Optional[float] = None

    # ---- accumulation ---------------------------------------------------

    def record(self, sample: CommitSample) -> bool:
        """Fold one sample in; returns False when skipped (full refresh)."""
        if sample.full:
            self.full_skipped += 1
            return False
        self.seconds.append(float(sample.seconds))
        self.bytes.append(float(sample.shipped_bytes))
        self.churn.append(float(sample.churn_frac))
        if sample.policy is not None:
            self.policy = sample.policy
        if self._baseline_s is None and len(self.seconds) >= self.window:
            self._baseline_s = statistics.median(self.seconds[: self.window])
        return True

    @property
    def n(self) -> int:
        return len(self.seconds)

    @property
    def baseline_s(self) -> Optional[float]:
        return self._baseline_s

    # ---- drift checks ---------------------------------------------------

    def latency_drift(self, tol: float) -> Optional[Tuple[float, float]]:
        """(measured, reference) when the recent latency median exceeds
        ``tol`` x the early-commit baseline, else None."""
        if len(self.seconds) < 2 * self.window or not self._baseline_s:
            return None
        recent = statistics.median(self.seconds[-self.window:])
        if recent > tol * self._baseline_s:
            return (recent, self._baseline_s)
        return None

    def bytes_drift(self, tol: float,
                    reference: Optional[float] = None
                    ) -> Optional[Tuple[float, float]]:
        """(measured, reference) when recent shipped bytes exceed ``tol`` x
        the reference — caller-supplied (e.g. predicted bytes_per_tick
        scaled to the commit cadence), else ``predicted_bytes``, else the
        early-commit median."""
        if len(self.bytes) < 2 * self.window:
            return None
        ref = reference if reference else self.predicted_bytes
        if not ref:
            ref = statistics.median(self.bytes[: self.window])
        recent = statistics.median(self.bytes[-self.window:])
        if ref and recent > tol * ref:
            return (recent, ref)
        return None

    # ---- reporting ------------------------------------------------------

    def median_recent(self, series: List[float]) -> float:
        return statistics.median(series[-self.window:]) if series else 0.0

    def report(self) -> Dict[str, Any]:
        """Predicted-vs-measured accounting snapshot (JSON-ready)."""
        out: Dict[str, Any] = {
            "commits": self.n,
            "full_skipped": self.full_skipped,
            "baseline_s": self._baseline_s,
            "recent_s": self.median_recent(self.seconds),
            "recent_bytes": self.median_recent(self.bytes),
            "recent_churn": self.median_recent(self.churn),
        }
        if self.predicted_seconds:
            out["predicted_s"] = self.predicted_seconds
            if out["recent_s"]:
                out["latency_vs_predicted"] = out["recent_s"] / self.predicted_seconds
        if self.predicted_bytes:
            out["predicted_bytes"] = self.predicted_bytes
            if out["recent_bytes"]:
                out["bytes_vs_predicted"] = out["recent_bytes"] / self.predicted_bytes
        return out

    def reset(self) -> None:
        """Restart accounting (e.g. after a plan swap: old baselines
        describe the old plan)."""
        self.seconds.clear()
        self.bytes.clear()
        self.churn.clear()
        self.full_skipped = 0
        self._baseline_s = None
