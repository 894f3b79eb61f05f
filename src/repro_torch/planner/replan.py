"""Online re-planning: watch a StreamingGNNServer, re-plan on drift.

The planner's recommendation is a prediction; serving is the measurement.
``ReplanMonitor`` attaches to a ``StreamingGNNServer`` through its commit
observer hook and folds every committed tick into a typed
``telemetry.DriftLedger`` (one :class:`~repro_torch.telemetry.CommitSample` per
commit — DESIGN.md §14).  Drift is declared when either signal's recent
median leaves the tolerance band around its reference:

  * latency  — reference is the rolling baseline established over the
    first ``window`` commits (modeled crossbar/radio time and host
    wall-clock are different clocks, so the latency prediction is
    anchored to the candidate's own early measurements);
  * traffic  — reference is the planner's predicted ``bytes_per_tick``
    when the traffic evaluator priced it, else the early-commit baseline.

On drift the monitor re-estimates the workload from what the stream
actually did (measured churn from the ledger's frontier series, measured
query rate from the server's counters), re-runs ``plan`` on the live
graph, and — when the recommendation's (setting, n_clusters, backend)
differs from the serving config — builds the new ``ExecutionPlan`` and
swaps it in via ``server.update_plan``. Every decision is appended to
``self.events`` (and mirrored as a ``planner.replan`` telemetry audit
event) so the load harness can report re-plan behaviour.

``observe(sample, server=None)`` is the typed entry point: without a
server the monitor runs in *shadow mode* — drift is detected and recorded
(``swapped=False``, ``new == old``) but no re-plan/swap is attempted, so
drift accounting can run against recorded samples or remote streams.

The counterpart of ``repro.planner.replan``. The drift signals are host
wall-clock commit seconds and the commits' billed bytes; a swap rebuilds
the server's engine on the server's own device with the same parameter
tensors, and its first commit is a full refresh, which the ledger skips.
"""
from __future__ import annotations

import dataclasses
import statistics

from ..telemetry import CommitSample, DriftLedger, commit_sample, event

from .plan import PlannerResult, plan
from .space import Candidate, WorkloadProfile


@dataclasses.dataclass
class ReplanEvent:
    tick: int
    reason: str                     # "latency" | "traffic"
    measured: float
    reference: float
    old: Candidate
    new: Candidate
    swapped: bool
    workload: WorkloadProfile       # the measured profile the re-plan used


class ReplanMonitor:
    """Commit observer: drift detection + re-plan for a streaming server.

    ``tol`` is the multiplicative drift band (median of the last
    ``window`` commits vs the reference); ``cooldown`` commits must pass
    between re-plans so one burst cannot thrash the partition.
    """

    def __init__(self, result: PlannerResult, window: int = 8,
                 tol: float = 3.0, cooldown: int = 16,
                 shortlist: int = 0):
        self.result = result
        self.window = max(int(window), 2)
        self.tol = float(tol)
        self.cooldown = max(int(cooldown), 1)
        self.shortlist = shortlist
        self.ledger = DriftLedger(
            window=self.window,
            predicted_bytes=result.recommended.metrics.get("bytes_per_tick"))
        self.queries_seen = 0
        self.events: list = []
        self._last_replan = -(10 ** 9)

    # ---- wiring ---------------------------------------------------------

    def attach(self, server) -> "ReplanMonitor":
        server.add_observer(self)
        return self

    @property
    def serving(self) -> Candidate:
        return self.result.recommended.candidate

    # legacy views of the ledger's series — load harnesses and tests read
    # these; the ledger is the single source of truth
    @property
    def seconds(self) -> list:
        return self.ledger.seconds

    @property
    def bytes(self) -> list:
        return self.ledger.bytes

    @property
    def churn(self) -> list:
        return self.ledger.churn

    @property
    def _baseline_s(self) -> float | None:
        return self.ledger.baseline_s

    @property
    def _server_policy(self) -> str | None:
        """The policy the observed server actually commits under (refreshed
        on every commit): drift scaling must follow the real cadence, not
        the recommendation's, should the two ever diverge."""
        return self.ledger.policy

    # ---- observation ----------------------------------------------------

    def __call__(self, server, update) -> None:
        self.observe(commit_sample(server, update), server=server)

    def observe(self, sample: CommitSample,
                server=None) -> ReplanEvent | None:
        """Fold one typed commit sample in; re-plan (or shadow-record) on
        drift. Returns the ReplanEvent when this sample tripped one.

        Full refreshes are skipped by the ledger: cold starts, param
        swaps, and bit-accurate degradations are not representative ticks
        — folding their wall-clock/traffic into the baseline would mask
        real drift.
        """
        if not self.ledger.record(sample):
            return None
        if sample.queries:
            self.queries_seen += int(sample.queries)
        drift = self._drift()
        if drift is None or self.ledger.n - self._last_replan < self.cooldown:
            return None
        self._last_replan = self.ledger.n
        if server is not None:
            return self._replan(server, *drift)
        # shadow mode: record the detection without a server to swap
        reason, measured, reference = drift
        ev = ReplanEvent(self.ledger.n, reason, measured, reference,
                         self.serving, self.serving, False,
                         self.measured_workload())
        self.events.append(ev)
        event("planner.drift", reason=reason, measured=measured,
              reference=reference, serving=self.serving.key, shadow=True)
        return ev

    def _drift(self) -> tuple | None:
        """(reason, measured, reference) when out of band, else None."""
        lat = self.ledger.latency_drift(self.tol)
        if lat is not None:
            return ("latency", *lat)
        predicted = self.result.recommended.metrics.get("bytes_per_tick")
        # the measured series is per *commit*; the prediction is per tick —
        # scale it up by the serving policy's commit interval or every
        # non-eager policy would look like steady-state drift
        ref_b = (predicted * max(self._commit_ticks(), 1)
                 if predicted else None)
        byt = self.ledger.bytes_drift(self.tol, reference=ref_b)
        if byt is not None:
            return ("traffic", *byt)
        return None

    # ---- decision -------------------------------------------------------

    def _commit_ticks(self) -> int:
        """Ticks per commit under the policy the server really runs."""
        policy = self._server_policy or self.serving.policy
        return max(self.result.workload.commit_interval(policy), 1)

    def measured_workload(self) -> WorkloadProfile:
        """The workload the stream actually presented, in per-*tick* units:
        a commit's level-0 frontier accumulates ``commit_interval`` ticks
        of churn (and its query counter that many ticks of lookups), so
        both measurements are divided back down before they parameterize
        the re-plan — feeding per-commit rates in would make every
        non-eager policy look like an extreme-churn workload."""
        wl = self.result.workload
        ticks = self._commit_ticks()
        recent = self.churn[-self.window:] or [wl.churn * ticks]
        commits = max(self.ledger.n, 1)
        return dataclasses.replace(
            wl, churn=min(1.0, statistics.median(recent) / ticks),
            queries_per_tick=max(self.queries_seen / (commits * ticks),
                                 wl.queries_per_tick))

    def note_queries(self, n: int) -> None:
        """Load generators report served lookups here so the re-planned
        workload sees the real query mix."""
        self.queries_seen += int(n)

    def _replan(self, server, reason: str, measured: float,
                reference: float) -> ReplanEvent:
        old = self.serving
        at_commit = self.ledger.n
        measured_wl = self.measured_workload()
        new_result = plan(server.plan.graph, self.result.objective,
                          workload=measured_wl,
                          hw=self.result.ctx.hw,
                          inventory=self.result.ctx.inventory,
                          shortlist=self.shortlist)
        new = new_result.recommended.candidate
        swap = (new.setting, new.n_clusters, new.backend) != \
            (old.setting, old.n_clusters, old.backend)
        if swap:
            server.update_plan(new_result.build_plan(server.plan.graph))
            # the recommendation is (plan, policy) — install both, and the
            # measured workload's policy knobs with it, so the server
            # commits on the cadence the scores assumed
            server.policy = new.policy
            server.interval = measured_wl.interval
            server.max_staleness = measured_wl.max_staleness
            server.max_dirty_frac = measured_wl.max_dirty_frac
        self.result = new_result
        self.ledger.predicted_bytes = \
            new_result.recommended.metrics.get("bytes_per_tick")
        # the serving config changed: measured baselines describe the old
        # plan, so restart drift detection (and the cooldown clock, which
        # counts the same series — leaving it at the pre-clear count would
        # silently double the effective cooldown) from fresh observations
        if swap:
            self.ledger.reset()
            self.queries_seen = 0
            self._last_replan = 0
        ev = ReplanEvent(at_commit, reason, measured, reference, old, new,
                         swap, measured_wl)
        self.events.append(ev)
        event("planner.replan", reason=reason, measured=measured,
              reference=reference, old=old.key, new=new.key, swapped=swap)
        return ev
