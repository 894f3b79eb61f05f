"""Evaluator plug-ins: Candidate × PlanContext → metric dict.

The planner never prices a candidate itself — it folds the metric dicts of
a list of *evaluators* (DESIGN.md §10). The contract:

    evaluator(candidate: Candidate, ctx: PlanContext) -> dict[str, float]

  * pure in its inputs (same candidate + ctx ⇒ same dict) — the planner's
    recommendation must be reproducible and exhaustively sweepable;
  * returns ``{}`` when it cannot price the candidate (e.g. the traffic
    evaluator without a concrete graph) — never raises for "not my job";
  * later evaluators override earlier keys — a custom evaluator may
    replace a modeled quantity with a measured one. The built-ins emit
    disjoint key sets on purpose: the modeled keys decide the ranking,
    the measured traffic keys ground it (drift reference, artifacts)
    without perturbing it.

The counterpart of ``repro.planner.evaluate``, over the port's own copies
of the cost model, the mapper, the device technologies and the traffic
accounting. Nothing here launches a kernel or builds one: the accuracy
evaluator reads ``CrossbarNumerics`` only for its geometry.

Built-ins:

  * ``cost_evaluator``    — the calibrated Eqs. 1-7 network model
    (``core.costmodel.predict``): ``t_compute`` / ``t_comm`` / power.
  * ``mapper_evaluator``  — the first-principles crossbar rollup
    (``mapper.compile_mapping``) at the candidate's geometry:
    ``t_compute_derived`` / ``energy_j`` / occupancy. The only evaluator
    that can see ``xbar_size``.
  * ``memory_evaluator`` — modeled per-device working-set bytes for the
    candidate's data-plane layout (``device_bytes``): the Pareto memory
    axis that separates dense from bucketed candidates. Closed-form, no
    partition built.
  * ``accuracy_evaluator`` — modeled p99 relative MVM error of the
    candidate's technology under conductance variation
    (``noise_p99_model``): the Pareto accuracy axis and the quantity the
    ``noise_tolerance`` infeasibility gate reads (DESIGN.md §13).
  * ``neighbor_evaluator`` — the per-commit neighbor/membership pass at
    the candidate's ``neighbor_mode`` on the traversal-CAM geometry
    (``t_neighbor_s`` — DESIGN.md §15): associative dirty-id search for
    ``cam``, serial table drain for the ``topk`` fallback. Folded into the
    serving model by ``objective.tick_costs`` for mutating workloads only.
  * ``traffic_evaluator`` — measured wire bytes on a *concrete* graph
    (``distributed.traffic.measure_execution`` / ``measure_incremental``):
    what a full refresh ships and what one policy-committed incremental
    tick ships, plus the measured layout accounting
    (``padding_ratio`` / ``peak_device_bytes``). Requires ``ctx.graph``;
    skipped otherwise.
"""
from __future__ import annotations

import dataclasses

from .space import Candidate, WorkloadProfile


@dataclasses.dataclass
class PlanContext:
    """Everything an evaluator may read: the workload statistics, the
    device inventory family, the demand profile, and (optionally) a
    concrete graph for measured evaluators. ``plan_cache`` memoizes built
    ExecutionPlans per (setting, n_clusters, layout) so the measured
    evaluators do not re-partition for every xbar/policy variant."""
    stats: object                      # core.graph.GraphStats
    workload: WorkloadProfile
    hw: object = None                  # core.costmodel.HardwareParams
    inventory: object = None           # base XbarInventory (None = paper's)
    graph: object = None               # concrete core.graph.Graph, optional
    spokes_per_head: int = 4
    plan_cache: dict = dataclasses.field(default_factory=dict)
    # built-in evaluators memoize here on the candidate fields they read
    # (the policy/backend axes multiply candidates without changing their
    # outputs — one compile_mapping per geometry, not three)
    memo: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.hw is None:
            from ..core.costmodel import DEFAULT_HW
            self.hw = DEFAULT_HW

    def inventory_for(self, cand: Candidate):
        """The candidate's device inventory: the setting's base inventory
        re-geometried to the candidate's crossbar size and rebuilt from
        its compute-tier technology (the head tier is what the crossbar
        mapper prices; the spoke storage tier only enters the per-device
        energy model — see ``mapper_evaluator``)."""
        from ..mapper import XbarInventory
        inv = self.inventory or XbarInventory.from_hardware(self.hw,
                                                            cand.setting)
        if cand.xbar_size is not None:
            inv = inv.with_xbar_size(cand.xbar_size)
        if cand.head_technology != inv.technology:
            inv = inv.with_technology(cand.head_technology)
        return inv

    def concrete_plan(self, cand: Candidate):
        """Build (and memoize) the candidate's ExecutionPlan on the
        concrete graph; None when no graph was supplied."""
        if self.graph is None:
            return None
        key = (cand.setting, cand.n_clusters, cand.layout)
        if key not in self.plan_cache:
            self.plan_cache[key] = cand.build_plan(
                self.graph, self.workload.sample,
                spokes_per_head=self.spokes_per_head)
        return self.plan_cache[key]


def cost_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """Calibrated network model (Eqs. 1-7): per-inference compute and
    communication latency plus per-device power for the setting.
    Memoized per (setting, n_clusters) — it reads nothing else."""
    key = ("cost", cand.setting, cand.n_clusters)
    if key in ctx.memo:
        return ctx.memo[key]
    from ..core import costmodel
    m = costmodel.predict(cand.setting, ctx.stats, ctx.hw,
                          n_clusters=cand.n_clusters,
                          gnn_layers=ctx.workload.gnn_layers,
                          sample=ctx.workload.sample)
    ctx.memo[key] = {
        "t_compute": m.t_compute,
        "t_comm": m.t_communicate,
        "t_net": m.t_net,
        "p_compute": m.p_compute,
        "p_comm": m.p_communicate,
    }
    return ctx.memo[key]


def mapper_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """First-principles crossbar rollup at the candidate's geometry
    (DESIGN.md §8): derived compute latency, per-inference read energy,
    and fx schedule occupancy. Layer dims default to the calibration
    workload (feature_len → 128) exactly as ``costmodel`` does.
    Memoized per (setting, n_clusters, xbar_size, technology) — the
    compile is the planner's most expensive model evaluation.

    ``energy_per_device_j`` is the technology-aware per-device energy
    axis: the head tier's crossbar read energy plus — for semi, where the
    spoke tier stores the features — one pass over the spoke's stored
    feature cells at the *spoke* technology's read energy (how a
    ``(reram, sram)`` pair gets billed for both of its tiers)."""
    key = ("mapper", cand.setting, cand.n_clusters, cand.xbar_size,
           cand.tech_key)
    if key in ctx.memo:
        return ctx.memo[key]
    from ..devices.bank import resolve_technology
    from ..mapper.compile import compile_mapping
    dims = (max(ctx.stats.feature_len, 1), 128)
    m = compile_mapping(dims, ctx.stats, ctx.hw, ctx.inventory_for(cand),
                        cand.setting, cand.n_clusters,
                        sample=ctx.workload.sample)
    energy_dev = m.energy_j
    if cand.setting == "semi":
        spoke = resolve_technology(cand.spoke_technology)
        rows = -(-max(ctx.stats.n_nodes, 1) // max(cand.n_clusters, 1))
        cells_per_elem = -(-8 // max(spoke.cell_bits, 1))
        energy_dev += (rows * max(ctx.stats.feature_len, 1)
                       * cells_per_elem * spoke.read_energy_j)
    ctx.memo[key] = {
        "t_compute_derived": m.t_compute,
        "t_compute_pipelined": m.t_compute_pipelined,
        "energy_j": m.energy_j,
        "energy_per_device_j": energy_dev,
        "fx_occupancy": m.array_utilization[2],
        "weight_arrays": float(m.weight_arrays),
    }
    return ctx.memo[key]


def memory_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """Modeled per-device working-set bytes for the candidate's data-plane
    layout — the Pareto memory axis (DESIGN.md §12). Deliberately a coarse
    closed-form model (no partition is built, so the full grid stays
    partition-free): the worst device holds ``rows`` padded feature rows
    (double-buffered activations), their sampled halo, and the int32
    neighbor/weight tables. Dense padding is priced at the modeled skew of
    the worst cluster (~2x the mean on the power-law graphs the paper
    serves); bucketed padding at the pow2-capacity average (~4/3x). The
    measured counterpart (``peak_device_bytes`` from
    ``ExecutionPlan.layout_stats``) is attached by ``traffic_evaluator``
    on the shortlist. Memoized per (n_clusters, layout)."""
    key = ("mem", cand.n_clusters, cand.layout)
    if key in ctx.memo:
        return ctx.memo[key]
    wl = ctx.workload
    f = max(int(ctx.stats.feature_len), 1)
    mean_rows = max(ctx.stats.n_nodes, 1) / max(cand.n_clusters, 1)
    if cand.n_clusters == 1:
        rows, halo = mean_rows, 0.0
    else:
        rows = mean_rows * (4.0 / 3.0 if cand.layout == "bucketed" else 2.0)
        halo = min(rows * min(ctx.stats.avg_cs, float(wl.sample)),
                   float(ctx.stats.n_nodes) - mean_rows)
        halo = max(halo, 0.0)
    ctx.memo[key] = {"device_bytes":
                     4.0 * (2 * rows * f + halo * f + 2 * rows * wl.sample)}
    return ctx.memo[key]


def accuracy_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """Modeled accuracy bound of the candidate's compute-tier technology
    under conductance variation (DESIGN.md §13): the closed-form p99
    relative MVM output error at the candidate's aggregation geometry
    (``devices.variation.modeled_p99_error`` — zero for noiseless SRAM).
    The axis that pulls noisy-but-cheap technologies off the frontier and
    the quantity ``WorkloadProfile.noise_tolerance`` gates on; the
    Monte-Carlo bounds of ``benchmarks/tech_sweep.py`` ground it.
    Memoized per (technology, xbar_size)."""
    key = ("acc", cand.tech_key, cand.xbar_size)
    if key in ctx.memo:
        return ctx.memo[key]
    from ..devices.variation import modeled_p99_error
    from ..kernels.crossbar_mvm import CrossbarNumerics
    inv = ctx.inventory_for(cand)
    cfg = CrossbarNumerics(rows_per_xbar=inv.agg_rows)
    ctx.memo[key] = {"noise_p99_model": modeled_p99_error(
        cand.head_technology, max(ctx.stats.feature_len, 1), cfg)}
    return ctx.memo[key]


def neighbor_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """Price one commit's neighbor/membership pass on the traversal CAM
    (DESIGN.md §15).

    The device's sampled neighbor table — ``rows × sample`` flat column
    indices — is the associative state; one commit must test it against
    the commit's dirty ids (``streaming.frontier``). The table occupies
    ``ceil(entries / cam_rows)`` CAM arrays, drained in
    ``serial = ceil(arrays / cam_arrays)`` rounds:

      * ``cam``  — each dirty id is one match-line-parallel search across
        every resident array: ``queries × serial × t_cam``.
      * ``topk`` — no associative path: the membership test reads the
        table out row-serially per array round, ``serial × cam_rows ×
        t_cam`` — so the CAM wins exactly when the dirty-id count stays
        under one array's depth, and loses on full-graph churn.

    Both are handed to ``objective.tick_costs`` via ``t_neighbor_s`` and
    billed per commit for mutating workloads (a static graph never pays a
    membership pass — the modes then tie and ``NEIGHBOR_RANK`` breaks it).
    Memoized per (setting, n_clusters, xbar_size, technology, policy,
    neighbor_mode)."""
    import math
    key = ("nbr", cand.setting, cand.n_clusters, cand.xbar_size,
           cand.tech_key, cand.policy, cand.neighbor_mode)
    if key in ctx.memo:
        return ctx.memo[key]
    from ..mapper.compile import PassPrimitives, items_per_device
    wl = ctx.workload
    inv = ctx.inventory_for(cand)
    prim = PassPrimitives.derive(ctx.hw, inv, tech=cand.head_technology)
    rows = items_per_device(cand.setting, max(ctx.stats.n_nodes, 1),
                            cand.n_clusters)
    entries = rows * max(wl.sample, 1)
    arrays = math.ceil(entries / max(inv.cam_rows, 1))
    serial = math.ceil(arrays / max(inv.cam_arrays, 1))
    frac = wl.recompute_fraction(ctx.stats, wl.commit_interval(cand.policy))
    queries = max(int(math.ceil(frac * rows)), 1)
    if cand.neighbor_mode == "cam":
        t = queries * serial * prim.t_cam
    else:
        t = serial * inv.cam_rows * prim.t_cam
    ctx.memo[key] = {"t_neighbor_s": t,
                     "neighbor_rounds": float(serial),
                     "neighbor_queries": float(queries)}
    return ctx.memo[key]


def traffic_evaluator(cand: Candidate, ctx: PlanContext) -> dict:
    """Measured wire traffic on the concrete graph: bytes a full refresh
    exchanges, and bytes one policy-committed incremental tick ships (the
    commit's dirty frontier over the executed send tables, amortized back
    to per-tick). Skipped (``{}``) without a concrete graph."""
    plan = ctx.concrete_plan(cand)
    if plan is None:
        return {}
    from ..distributed.traffic import measure_execution
    # per full refresh: the tier-1 halo repeats every layer, the semi
    # tier-0 spoke upload ships the input features exactly once
    full = measure_execution(plan, mode="alltoall")
    out = {"bytes_full_refresh":
           float(full.tier0_bytes().sum())
           + float(full.tier1_bytes().sum()) * ctx.workload.gnn_layers}
    # measured layout accounting for the concrete partition: grounds the
    # modeled ``device_bytes`` axis without touching it (disjoint keys —
    # the ranking/frontier must not depend on whether measurement ran)
    ls = plan.layout_stats()
    out["padding_ratio"] = float(ls["padding_ratio"])
    out["peak_device_bytes"] = float(ls["peak_device_bytes"])
    wl = ctx.workload
    if wl.mutating and plan.part is not None:
        import types
        from ..distributed.halo import build_halo_plan
        from ..distributed.traffic import (measure_incremental,
                                               modeled_frontier)
        ticks = wl.commit_interval(cand.policy)
        frac = wl.recompute_fraction(ctx.stats, ticks)
        levels = modeled_frontier(plan.part, min(1.0, wl.churn * ticks),
                                  frac, wl.gnn_layers)
        # bill every layer's exchange against its frontier level (a
        # cfg-shaped dims carrier: input-dim features per layer, matching
        # the bytes_full_refresh convention above)
        dims_cfg = types.SimpleNamespace(
            dims=(ctx.stats.feature_len,) * (wl.gnn_layers + 1))
        rep = measure_incremental(plan, build_halo_plan(plan.part),
                                  levels, cfg=dims_cfg, mode="alltoall")
        out["bytes_per_tick"] = float(rep.total_bytes()) / max(ticks, 1)
    elif not wl.mutating:
        out["bytes_per_tick"] = 0.0
    return out


DEFAULT_EVALUATORS = (cost_evaluator, mapper_evaluator, memory_evaluator,
                      accuracy_evaluator, neighbor_evaluator)


def evaluate(cand: Candidate, ctx: PlanContext,
             evaluators: tuple = DEFAULT_EVALUATORS) -> dict:
    """Fold every evaluator's metric dict (later evaluators win ties)."""
    metrics: dict = {}
    for ev in evaluators:
        metrics.update(ev(cand, ctx))
    return metrics
