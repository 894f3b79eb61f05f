"""The planner's configuration space: candidates and workload profiles.

A ``Candidate`` is one point of the discrete space the planner searches —
``setting × backend × cluster count × crossbar size × refresh policy ×
data-plane layout`` —
i.e. everything that must be decided *before* an ``ExecutionPlan`` can be
built and a ``StreamingGNNServer`` brought up. ``WorkloadProfile`` is the
demand side: how much of the graph churns per tick, how many embedding
lookups arrive alongside, and the serving knobs (sample size, GNN depth,
refresh-policy parameters) the combined-objective model needs.

The counterpart of ``repro.planner.space``. Dependency-light by design
(standard library only): the evaluators pull in ``repro_torch.core`` /
``repro_torch.mapper`` lazily, so the space can be enumerated and
serialized without pricing or partitioning anything.
``Candidate.build_plan`` returns a
host ``ExecutionPlan`` and takes no device: the device is given to
``make_forward`` and the servers.
"""
from __future__ import annotations

import dataclasses
import math

SETTINGS = ("centralized", "decentralized", "semi")
BACKENDS = ("jnp", "pallas", "fused")
POLICIES = ("eager", "interval", "bounded-staleness")
LAYOUTS = ("dense", "bucketed")
# neighbor-selection paths (kept in sync with
# repro_torch.neighbors.NEIGHBOR_MODES — this module stays import-light):
# ``cam`` runs membership/k-NN scoring on the traversal CAM, ``topk`` on
# the host sort/top-k fallback
NEIGHBOR_MODES = ("topk", "cam")

# deterministic tie-break: when two candidates score identically the planner
# prefers the faster measured backend (fused keeps Z on chip — DESIGN.md §5)
BACKEND_RANK = {"fused": 0, "pallas": 1, "jnp": 2}
# second tie-break: bucketed before dense — the modeled time/energy
# evaluators cannot distinguish the layouts (same partition, same math),
# and at equal score the bucketed layout strictly reduces device memory
# (it Pareto-dominates its dense twin on the ``device_bytes`` axis, so
# ranking it first keeps the recommendation on the frontier)
LAYOUT_RANK = {"bucketed": 0, "dense": 1}
# third tie-break: cam before topk — when the serving model cannot separate
# the modes (non-mutating workloads pay no per-commit membership pass) the
# CAM path is the in-memory one the paper argues for, at no modeled cost
NEIGHBOR_RANK = {"cam": 0, "topk": 1}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the planner's search space.

    ``n_clusters`` is the device-side parallelism knob: 1 for centralized
    (by construction), cluster heads for semi, runtime clusters for
    decentralized (the paper's decentralized setting is one node per
    device; the cost model prices it that way regardless, so decentralized
    candidates carry a single representative cluster count for the
    concrete runtime). ``xbar_size`` re-geometries the MVM crossbars via
    ``XbarInventory.with_xbar_size`` (None = the paper's geometry).
    ``layout`` picks the partition data plane: ``dense`` is the uniform
    n_max padding, ``bucketed`` the capacity-bucketed ragged layout
    (DESIGN.md §12) — numerically identical, cheaper device memory.
    ``neighbor_mode`` picks where neighbor selection / dirty-frontier
    membership runs (DESIGN.md §15): ``cam`` on the traversal core's
    search CAM, ``topk`` on the host sort/top-k fallback — result-identical
    by the kernel contract, so the axis is purely a hardware/pricing
    decision (``evaluate.neighbor_evaluator``).
    ``technology`` is the device-technology axis (DESIGN.md §13): a
    registered name (``repro_torch.devices.bank``) builds every tier from
    that technology; a ``(spoke_tech, head_tech)`` pair — semi only —
    builds the spoke storage tier and the compute-head tier from different
    ones (e.g. dense ReRAM spokes under fast SRAM heads). Names are validated
    lazily by the evaluators (``compile_mapping`` raises the registry's
    named error), keeping this module dependency-light.
    """
    setting: str
    backend: str = "fused"
    n_clusters: int = 1
    xbar_size: int | None = None
    policy: str = "eager"
    layout: str = "dense"
    technology: str | tuple = "sot-mram"
    neighbor_mode: str = "topk"

    def __post_init__(self):
        if self.setting not in SETTINGS:
            raise ValueError(f"unknown setting {self.setting!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.neighbor_mode not in NEIGHBOR_MODES:
            raise ValueError(f"unknown neighbor mode {self.neighbor_mode!r}")
        if self.n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {self.n_clusters}")
        if self.setting == "centralized" and self.n_clusters != 1:
            raise ValueError("centralized implies n_clusters == 1")
        if isinstance(self.technology, (tuple, list)):
            object.__setattr__(self, "technology", tuple(self.technology))
            if len(self.technology) != 2:
                raise ValueError("a technology pair must be "
                                 "(spoke_tech, head_tech)")
            if self.setting != "semi":
                raise ValueError("per-tier technology pairs require the "
                                 "semi setting (spokes + heads)")
        if not self.technology or not all(
                isinstance(t, str) and t
                for t in ((self.technology,)
                          if isinstance(self.technology, str)
                          else self.technology)):
            raise ValueError(f"technology must be a non-empty name or a "
                             f"pair of names, got {self.technology!r}")

    @property
    def spoke_technology(self) -> str:
        """Storage-tier technology (= the single name when not a pair)."""
        return (self.technology[0] if isinstance(self.technology, tuple)
                else self.technology)

    @property
    def head_technology(self) -> str:
        """Compute-tier technology — what the crossbar mapper prices."""
        return (self.technology[1] if isinstance(self.technology, tuple)
                else self.technology)

    @property
    def tech_key(self) -> str:
        return ("+".join(self.technology)
                if isinstance(self.technology, tuple) else self.technology)

    @property
    def key(self) -> str:
        xb = "paper" if self.xbar_size is None else str(self.xbar_size)
        return (f"{self.setting}/{self.backend}/k{self.n_clusters}"
                f"/xb{xb}/{self.policy}/{self.layout}/{self.tech_key}"
                f"/{self.neighbor_mode}")

    def build_plan(self, graph, sample: int, seed: int = 0,
                   spokes_per_head: int = 4):
        """Materialize this candidate as a runnable ``ExecutionPlan``."""
        from ..core.partition import plan_execution
        k = None if self.setting == "centralized" else self.n_clusters
        buckets = "auto" if self.layout == "bucketed" else None
        return plan_execution(graph, self.setting, backend=self.backend,
                              sample=sample, n_clusters=k, seed=seed,
                              spokes_per_head=spokes_per_head,
                              buckets=buckets)


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """The demand profile the combined objective prices a candidate under.

    ``churn`` — fraction of node feature rows mutated per stream tick;
    ``edge_churn`` — structural edge events per tick;
    ``queries_per_tick`` — embedding lookups arriving per tick;
    ``gnn_layers`` / ``sample`` — model depth and the runtime's neighbor
    sample (bounds how far dirt propagates per layer);
    ``interval`` / ``max_staleness`` / ``max_dirty_frac`` — the refresh
    policies' parameters, mirroring ``StreamingGNNServer``'s;
    ``slo_s`` — optional per-query latency bound for the throughput
    objective (a candidate whose queue wait exceeds it is infeasible);
    ``noise_tolerance`` — optional bound on the modeled p99 relative MVM
    error under conductance variation (``devices.variation``): a
    candidate whose technology's ``noise_p99_model`` exceeds it is
    infeasible — how the planner rejects technologies whose noise breaks
    the bit-accurate contract.
    """
    churn: float = 0.0
    edge_churn: int = 0
    queries_per_tick: float = 0.0
    gnn_layers: int = 2
    sample: int = 8
    interval: int = 4
    max_staleness: int = 8
    max_dirty_frac: float = 0.25
    slo_s: float | None = None
    noise_tolerance: float | None = None

    def __post_init__(self):
        if not 0.0 <= self.churn <= 1.0:
            raise ValueError(f"churn must be in [0, 1], got {self.churn}")
        if self.queries_per_tick < 0 or self.edge_churn < 0:
            raise ValueError("negative workload rates")
        if self.gnn_layers < 1 or self.sample < 1:
            raise ValueError("gnn_layers and sample must be >= 1")
        if self.noise_tolerance is not None and self.noise_tolerance < 0:
            raise ValueError("noise_tolerance must be >= 0")

    @property
    def mutating(self) -> bool:
        return self.churn > 0 or self.edge_churn > 0

    def commit_interval(self, policy: str) -> int:
        """Ticks between refresh commits under ``policy`` (>= 1).

        ``eager`` commits every tick; ``interval`` every ``interval``
        ticks; ``bounded-staleness`` when the buffered dirty fraction
        reaches ``max_dirty_frac`` (or ``max_staleness`` ticks, whichever
        comes first) — the same triggers ``StreamingGNNServer`` applies.
        """
        if policy == "eager" or not self.mutating:
            return 1
        if policy == "interval":
            return max(int(self.interval), 1)
        assert policy == "bounded-staleness", policy
        if self.churn <= 0:
            return max(int(self.max_staleness), 1)
        return max(min(int(math.ceil(self.max_dirty_frac / self.churn)),
                       int(self.max_staleness)), 1)

    def recompute_fraction(self, stats, ticks: int = 1) -> float:
        """Modeled fraction of rows a commit covering ``ticks`` ticks must
        recompute: ``ticks × churn`` seed rows, each dirtying the rows that
        read it through L layers of the *sampled* adjacency (fan-out per
        hop is bounded by both the average degree and the sample cut —
        DESIGN.md §9's frontier masks are the measured counterpart)."""
        seed = min(1.0, self.churn * max(ticks, 1)
                   + self.edge_churn * max(ticks, 1) / max(stats.n_nodes, 1))
        if seed <= 0.0:
            return 0.0
        fan = 1.0 + min(stats.avg_cs, float(self.sample))
        return min(1.0, seed * fan ** self.gnn_layers)


def candidate_space(stats,
                    settings: tuple = SETTINGS,
                    backends: tuple = ("fused",),
                    cluster_counts: tuple = (4, 8, 16),
                    xbar_sizes: tuple = (None, 128, 256),
                    policies: tuple | None = None,
                    workload: WorkloadProfile | None = None,
                    layouts: tuple = LAYOUTS,
                    technologies: tuple = ("sot-mram",),
                    neighbor_modes: tuple | None = None) -> list:
    """Enumerate the candidate grid for one workload.

    Per-setting structure is respected: centralized pins ``n_clusters=1``;
    decentralized carries one representative cluster count (the cost model
    prices it per node regardless — see ``Candidate``); semi sweeps the
    cluster-head counts (capped at the node count — a head must front at
    least one node). Refresh policies only differentiate mutating
    workloads, so a query-only profile collapses them to ``eager``.
    Layouts only differentiate partitioned settings — centralized has one
    cluster and therefore one bucket, so it stays dense.

    ``technologies`` entries are registered names or ``(spoke, head)``
    pairs; pairs only make sense with two tiers, so they enumerate under
    the semi setting only.

    Like refresh policies, neighbor modes only differentiate mutating
    workloads (the membership pass is billed per commit), so a query-only
    profile collapses ``neighbor_modes`` to the ``topk`` fallback.
    """
    if policies is None:
        policies = (POLICIES if workload is not None and workload.mutating
                    else ("eager",))
    if neighbor_modes is None:
        neighbor_modes = (NEIGHBOR_MODES
                          if workload is not None and workload.mutating
                          else ("topk",))
    counts = sorted({max(1, min(int(k), max(stats.n_nodes, 1)))
                     for k in cluster_counts})
    out = []
    for setting in settings:
        if setting == "centralized":
            ks = (1,)
        elif setting == "decentralized":
            ks = (counts[len(counts) // 2],)
        else:
            ks = tuple(counts)
        lys = ("dense",) if setting == "centralized" else tuple(layouts)
        techs = tuple(t for t in technologies
                      if setting == "semi" or isinstance(t, str))
        for backend in backends:
            for k in ks:
                for size in xbar_sizes:
                    for policy in policies:
                        for layout in lys:
                            for tech in techs:
                                for nm in neighbor_modes:
                                    out.append(Candidate(setting, backend,
                                                         k, size, policy,
                                                         layout, tech, nm))
    return out
