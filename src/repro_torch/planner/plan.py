"""The planner core: search the space, keep the Pareto frontier, recommend.

``plan(graph_or_stats, ...)`` enumerates the candidate grid
(``space.candidate_space``), prices every candidate through the evaluator
chain (``evaluate.evaluate``), scores it under the requested objective
(``objective.score``), and returns a ``PlannerResult``:

  * ``scored``      — every candidate with its metric dict and score
    (deterministically ordered: score, then backend rank, then key), so an
    exhaustive sweep of the planner's own evaluators is just
    ``result.scored[0]`` — the self-consistency contract
    ``benchmarks/planner_sweep.py`` gates on;
  * ``frontier``    — the Pareto non-dominated set over (per-inference
    latency, per-device energy incl. the semi spoke storage tier,
    per-tick serving cost, modeled per-device working-set bytes, modeled
    p99 variation error): the configs worth keeping when the objective
    weighting is uncertain — the memory axis is what keeps the bucketed
    layouts on the frontier (time/energy models cannot separate layouts),
    the accuracy axis what keeps quiet-but-slow technologies on it;
  * ``recommended`` — the argmin under the objective, materializable via
    ``result.build_plan(graph)``.

When a concrete ``Graph`` is passed, a second *measurement* phase runs the
traffic evaluator over the ``shortlist`` best candidates — partitioning
the graph and counting bytes on the executed exchange tables. Its keys
(``bytes_full_refresh`` / ``bytes_per_tick``) feed no objective, so the
ranking is unchanged by construction (the exhaustive-sweep gate compares
against model-only scoring); they exist to ground the result in measured
wire traffic — the drift reference ``ReplanMonitor`` checks serving
against, and the artifact rows the sweep benchmark records. Keeping the
phase to a shortlist keeps partition-building off the full grid.

The counterpart of ``repro.planner.plan``: the same sort key and the same
frontier slack, so that candidates order and tie as the reference's do.
"""
from __future__ import annotations

import dataclasses

from ..telemetry import event as telemetry_event

from .evaluate import (DEFAULT_EVALUATORS, PlanContext, evaluate,
                       traffic_evaluator)
from .objective import OBJECTIVES, score, tick_costs
from .space import (BACKEND_RANK, LAYOUT_RANK, NEIGHBOR_RANK, Candidate,
                    WorkloadProfile, candidate_space)


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    candidate: Candidate
    metrics: dict
    score: float

    @property
    def sort_key(self) -> tuple:
        return (self.score, BACKEND_RANK.get(self.candidate.backend, 9),
                LAYOUT_RANK.get(self.candidate.layout, 9),
                NEIGHBOR_RANK.get(self.candidate.neighbor_mode, 9),
                self.candidate.key)

    def as_record(self) -> dict:
        """JSON-ready row (the sweep benchmark's artifact format)."""
        c = self.candidate
        return dict(setting=c.setting, backend=c.backend,
                    n_clusters=c.n_clusters,
                    xbar="paper" if c.xbar_size is None else c.xbar_size,
                    policy=c.policy, layout=c.layout,
                    technology=c.tech_key,
                    neighbor_mode=c.neighbor_mode, score=self.score,
                    **{k: v for k, v in self.metrics.items()
                       if isinstance(v, (int, float))})


# per-device energy (not bare crossbar energy — the semi spoke storage tier
# bills here too) and the modeled variation bound are the DESIGN.md §13
# axes; a same-technology space is degenerate on the noise axis
_PARETO_AXES = ("t_net", "energy_per_device_j", "t_tick", "device_bytes",
                "noise_p99_model")


def _dominates(a: dict, b: dict) -> bool:
    """a Pareto-dominates b: no worse on every axis, better on one."""
    no_worse = all(a.get(ax, 0.0) <= b.get(ax, 0.0) * (1 + 1e-12)
                   for ax in _PARETO_AXES)
    better = any(a.get(ax, 0.0) < b.get(ax, 0.0) * (1 - 1e-12)
                 for ax in _PARETO_AXES)
    return no_worse and better


def pareto_frontier(scored: list) -> list:
    """Non-dominated subset over ``_PARETO_AXES``, stable order."""
    out = []
    for sc in scored:
        if not any(_dominates(o.metrics, sc.metrics) for o in scored
                   if o is not sc):
            out.append(sc)
    return out


@dataclasses.dataclass
class PlannerResult:
    objective: str
    workload: WorkloadProfile
    ctx: PlanContext
    scored: list                    # every ScoredCandidate, best first
    frontier: list                  # Pareto subset of scored

    @property
    def recommended(self) -> ScoredCandidate:
        return self.scored[0]

    def best(self, setting: str) -> ScoredCandidate | None:
        """Best-scored candidate of one setting (the pure baselines the
        hybrid recommendation is judged against)."""
        for sc in self.scored:
            if sc.candidate.setting == setting:
                return sc
        return None

    def build_plan(self, graph, seed: int = 0):
        """Materialize the recommendation as a runnable ExecutionPlan."""
        return self.recommended.candidate.build_plan(
            graph, self.workload.sample, seed=seed,
            spokes_per_head=self.ctx.spokes_per_head)

    def summary(self, top: int = 5) -> str:
        rec = self.recommended
        lines = [
            f"planner[{self.objective}] over {len(self.scored)} candidates "
            f"({len(self.frontier)} on the Pareto frontier):",
            f"  recommended: {rec.candidate.key}  score {rec.score:.3e} s",
        ]
        for sc in self.scored[1:top]:
            lines.append(f"  runner-up:   {sc.candidate.key}  "
                         f"score {sc.score:.3e} s")
        for setting in ("centralized", "decentralized", "semi"):
            b = self.best(setting)
            if b is not None and b is not rec:
                lines.append(f"  best pure {setting}: {b.candidate.key}  "
                             f"score {b.score:.3e} s "
                             f"({b.score / max(rec.score, 1e-30):.2f}x "
                             f"recommended)")
        return "\n".join(lines)


def score_candidate(cand: Candidate, ctx: PlanContext, objective: str,
                    evaluators: tuple = DEFAULT_EVALUATORS
                    ) -> ScoredCandidate:
    """Price + score one candidate — the unit the exhaustive sweep replays."""
    metrics = evaluate(cand, ctx, evaluators)
    if objective == "throughput" or ctx.workload.mutating:
        metrics = dict(metrics, **tick_costs(cand, ctx, metrics))
    return ScoredCandidate(cand, metrics,
                           score(cand, ctx, metrics, objective))


def plan(graph_or_stats, objective: str = "latency",
         workload: WorkloadProfile | None = None,
         hw=None, inventory=None,
         evaluators: tuple = DEFAULT_EVALUATORS,
         space: list | None = None,
         shortlist: int = 4,
         spokes_per_head: int = 4,
         **space_kw) -> PlannerResult:
    """Search the configuration space and recommend an execution plan.

    ``graph_or_stats``: a concrete ``Graph`` (enables the measured-traffic
    phase — see module docstring: it attaches measured bytes to the top
    candidates without changing the ranking) or bare ``GraphStats``
    (model-only). ``space`` overrides the enumerated grid; ``space_kw``
    (``backends``, ``cluster_counts``, ``xbar_sizes``, ``policies``) tune
    the default one. ``shortlist`` bounds the measurement phase (0
    disables it).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    workload = workload or WorkloadProfile()
    graph = None if not hasattr(graph_or_stats, "stats") else graph_or_stats
    stats = graph.stats("planner") if graph is not None else graph_or_stats
    ctx = PlanContext(stats, workload, hw=hw, inventory=inventory,
                      graph=graph, spokes_per_head=spokes_per_head)
    cands = (space if space is not None
             else candidate_space(stats, workload=workload, **space_kw))
    if not cands:
        raise ValueError("empty candidate space")
    scored = sorted((score_candidate(c, ctx, objective, evaluators)
                     for c in cands), key=lambda s: s.sort_key)
    if graph is not None and shortlist > 0:
        refined = [score_candidate(sc.candidate, ctx, objective,
                                   (*evaluators, traffic_evaluator))
                   for sc in scored[:shortlist]]
        scored = sorted(refined + scored[shortlist:],
                        key=lambda s: s.sort_key)
    result = PlannerResult(objective, workload, ctx, scored,
                           pareto_frontier(scored))
    # planner decision audit record (telemetry no-ops when disabled):
    # enough to reconstruct *why* this plan is serving from an exported
    # metrics dump alone (DESIGN.md §14)
    telemetry_event(
        "planner.plan", objective=objective,
        recommended=result.recommended.candidate.key,
        score=result.recommended.score, candidates=len(scored),
        frontier=len(result.frontier), measured=graph is not None,
        shortlist=shortlist, churn=workload.churn,
        queries_per_tick=workload.queries_per_tick)
    return result
