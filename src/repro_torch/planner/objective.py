"""Objectives: fold a candidate's metric dict into one comparable score.

Three objectives (DESIGN.md §10):

  * ``latency``    — the paper's per-inference ``T_net = T_compute +
    T_communicate`` (Eq. 1), with the mapper-derived compute latency when
    the mapper evaluator priced the candidate's geometry.
  * ``energy``     — per-device energy of one inference: the mapper's
    crossbar read energy plus the radio's ``P_comm × T_comm``.
  * ``throughput`` — the serving objective the ROADMAP's heavy-traffic
    story needs: the per-tick makespan ``t_tick`` of the mixed
    churn+query workload; its inverse is the sustainable tick rate. An
    optional per-query SLO marks candidates whose worst-case query wait
    exceeds it infeasible.

``tick_costs`` is the combined model behind ``throughput``: one commit
every ``commit_interval`` ticks pays a dirty-frontier refresh (compute
scaled by the modeled recompute fraction, communication by the
dirty-rows-only exchange — ``costmodel.refresh_communicate_latency``),
amortized per tick, plus the query drain: each device answers its share of
the tick's lookups serially over its link (one concurrent response per
radio), so centralized serializes everything behind one inter-network
link, semi spreads the drain over its cluster heads, and decentralized
over every node. That asymmetry is exactly the paper's tension made
decidable: query-heavy mixes reward device parallelism, churn-heavy mixes
reward cheap collection, and the hybrid setting trades the two.

The counterpart of ``repro.planner.objective``: the same float arithmetic
in the same order, so that the port's scores equal the reference's with
``==``. Every time here is a modeled time of the paper's edge devices,
not of the card.
"""
from __future__ import annotations

from .evaluate import PlanContext
from .space import Candidate

OBJECTIVES = ("latency", "energy", "throughput")

# a candidate violating the SLO stays comparable (ranked by how badly it
# misses) but never beats a feasible one
_INFEASIBLE = 1e6


def effective_compute(metrics: dict) -> float:
    """Per-inference compute latency: mapper-derived when priced (it sees
    the candidate's crossbar geometry), calibrated otherwise."""
    return metrics.get("t_compute_derived", metrics.get("t_compute", 0.0))


def tick_costs(cand: Candidate, ctx: PlanContext, metrics: dict) -> dict:
    """The combined per-tick serving model for one candidate.

    Returns refresh/query components, the per-tick makespan ``t_tick``,
    the worst-case per-query latency ``t_query_worst`` (refresh blocking
    plus the device's full drain), and the modeled recompute fraction —
    the quantities the planner records and the drift monitor later checks
    against measurements.
    """
    from ..core.costmodel import refresh_communicate_latency
    wl, stats, hw = ctx.workload, ctx.stats, ctx.hw
    commit_ticks = wl.commit_interval(cand.policy)
    frac = wl.recompute_fraction(stats, commit_ticks)
    refresh_compute = frac * effective_compute(metrics)
    refresh_comm = (refresh_communicate_latency(
        cand.setting, stats, hw, cand.n_clusters, frac)
        if wl.mutating else 0.0)
    # per-commit neighbor/membership pass at the candidate's neighbor_mode
    # (evaluate.neighbor_evaluator); a static graph never pays one
    refresh_neighbor = (metrics.get("t_neighbor_s", 0.0)
                        if wl.mutating else 0.0)

    if cand.setting == "centralized":
        n_serving, t_link = 1, hw.t_ln
    elif cand.setting == "semi":
        n_serving, t_link = max(cand.n_clusters, 1), hw.t_ln
    else:
        n_serving, t_link = max(stats.n_nodes, 1), hw.t_lc
    query_drain = wl.queries_per_tick / n_serving * t_link

    t_tick = ((refresh_compute + refresh_comm + refresh_neighbor)
              / commit_ticks + query_drain)
    t_query_worst = (refresh_compute + refresh_comm + refresh_neighbor
                     + query_drain + t_link)
    return {
        "commit_ticks": float(commit_ticks),
        "recompute_frac": frac,
        "refresh_compute_s": refresh_compute,
        "refresh_comm_s": refresh_comm,
        "refresh_neighbor_s": refresh_neighbor,
        "query_drain_s": query_drain,
        "t_tick": t_tick,
        "t_query_worst": t_query_worst,
        "n_serving": float(n_serving),
    }


def score(cand: Candidate, ctx: PlanContext, metrics: dict,
          objective: str) -> float:
    """Scalar score (lower is better) of one candidate under ``objective``.

    Pure in its inputs: the exhaustive-sweep validation in
    ``benchmarks/planner_sweep.py`` re-derives every candidate's score
    through this very function and asserts the planner's recommendation
    is its argmin."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    if objective == "latency":
        s = effective_compute(metrics) + metrics.get("t_comm", 0.0)
    elif objective == "energy":
        base = metrics.get(
            "energy_j",
            metrics.get("p_compute", 0.0) * metrics.get("t_compute", 0.0))
        s = base + metrics.get("p_comm", 0.0) * metrics.get("t_comm", 0.0)
    else:
        costs = tick_costs(cand, ctx, metrics)
        s = costs["t_tick"]
        slo = ctx.workload.slo_s
        if slo is not None and costs["t_query_worst"] > slo:
            s += _INFEASIBLE * (costs["t_query_worst"] - slo)
    # accuracy gate (all objectives): a technology whose modeled p99 MVM
    # error exceeds the workload's noise tolerance stays comparable but
    # never beats a feasible candidate — same shape as the SLO penalty
    tol = ctx.workload.noise_tolerance
    p99 = metrics.get("noise_p99_model", 0.0)
    if tol is not None and p99 > tol:
        s += _INFEASIBLE * (p99 - tol)
    return s
