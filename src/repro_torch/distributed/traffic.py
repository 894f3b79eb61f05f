"""Measured communication-volume accounting for ExecutionPlans.

A copy of ``repro.distributed.traffic`` (numpy), so that the port needs
nothing of the JAX package. The paper's Eqs. 4/5 price a setting; this
module reports what the runtime's exchanges actually move:
rows and bytes per device per layer, counted on the *executed* send/recv
tables (the very tables ``distributed.halo`` hands to the collectives /
emulated exchange), at the runtime's padded shapes. "Measured" therefore
means derived from the execution plan's wire schedule, not estimated from
graph statistics — for the ``alltoall`` mode the per-pair row counts equal
the pruned ``Partition.comm_volume`` e_ij by construction (DESIGN.md §7).

Tier structure:

  * decentralized — one tier: per-layer halo exchange rows between peers.
  * semi          — tier 0: each spoke uploads its owned feature rows to its
    region head once per inference (the input features); tier 1: per-layer
    head<->head halo rows, identical accounting to decentralized but over
    the region partition.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ITEMSIZE = 4  # float32 features on the wire


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Measured wire traffic of one ExecutionPlan.

    ``tier1_rows[i, j]`` is the number of feature rows device i *receives*
    from peer j in one halo exchange (one exchange per GNN layer);
    ``tier0_rows[r, p]`` is the number of rows spoke p of region r uploads
    to its head (semi only — empty [0, 0] otherwise). Bytes follow from the
    per-layer feature dims: tier 0 moves input features once, tier 1 moves
    the layer's input dim every layer.
    """
    setting: str
    mode: str
    layer_dims: tuple          # feature dim entering each layer's exchange
    tier0_rows: np.ndarray     # [R, P] int64
    tier1_rows: np.ndarray     # [K, K] int64
    itemsize: int = ITEMSIZE

    @property
    def n_devices(self) -> int:
        return self.tier1_rows.shape[0]

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims)

    def tier0_bytes(self) -> np.ndarray:
        """[R, P] bytes each spoke uploads (input features, once)."""
        f = self.layer_dims[0] if self.layer_dims else 0
        return self.tier0_rows * f * self.itemsize

    def tier1_bytes(self) -> np.ndarray:
        """[L, K] bytes each device receives per layer."""
        dims = np.asarray(self.layer_dims, np.int64)
        per_dev = self.tier1_rows.sum(axis=1)           # rows/exchange
        return dims[:, None] * per_dev[None, :] * self.itemsize

    def total_bytes(self) -> int:
        return int(self.tier0_bytes().sum() + self.tier1_bytes().sum())

    def summary(self) -> str:
        t0 = int(self.tier0_bytes().sum())
        t1 = int(self.tier1_bytes().sum())
        return (f"{self.setting}/{self.mode}: tier0 {t0 / 1e6:.3f} MB "
                f"(once), tier1 {t1 / 1e6:.3f} MB over {self.n_layers} "
                f"layers, total {(t0 + t1) / 1e6:.3f} MB")


def exchange_rows(plan, mode: str, n_max: int) -> np.ndarray:
    """[K, K] rows device i receives from peer j in one halo exchange.

    ``plan`` is a ``distributed.halo.HaloPlan``. ``allgather`` ships every
    peer's full padded table; ``alltoall`` ships exactly the send-list rows
    (== the pruned comm_volume e_ij).
    """
    k = plan.src_cluster.shape[0]
    if mode == "allgather":
        rows = np.full((k, k), n_max, np.int64)
        np.fill_diagonal(rows, 0)
        return rows
    assert mode == "alltoall", mode
    return plan.recv_mask.sum(axis=2).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class StreamingTrafficReport:
    """Measured wire traffic of one *incremental* refresh tick.

    Unlike ``TrafficReport`` (whose tier-1 rows repeat every layer), the
    incremental exchange ships a different row set per layer — only rows
    whose cached value changed (the dirty frontier at that level), plus
    send slots structural churn newly created. ``tier1_rows[l, i, j]`` is
    the number of feature rows device i receives from peer j in layer l's
    exchange; ``tier0_rows[r, p]`` is the number of mutated feature rows
    spoke p re-uploads to its head this tick (semi only).
    """
    setting: str
    mode: str
    layer_dims: tuple          # feature dim entering each layer's exchange
    tier0_rows: np.ndarray     # [R, P] int64
    tier1_rows: np.ndarray     # [L, K, K] int64
    itemsize: int = ITEMSIZE

    @property
    def n_devices(self) -> int:
        return self.tier1_rows.shape[1]

    @property
    def n_layers(self) -> int:
        return self.tier1_rows.shape[0]

    def tier0_bytes(self) -> np.ndarray:
        """[R, P] bytes each spoke re-uploads (mutated input rows, once)."""
        f = self.layer_dims[0] if self.layer_dims else 0
        return self.tier0_rows * f * self.itemsize

    def tier1_bytes(self) -> np.ndarray:
        """[L, K] bytes each device receives per layer."""
        dims = np.asarray(self.layer_dims, np.int64)
        per_dev = self.tier1_rows.sum(axis=2)           # [L, K]
        return dims[:, None] * per_dev * self.itemsize

    def total_bytes(self) -> int:
        return int(self.tier0_bytes().sum() + self.tier1_bytes().sum())

    def summary(self) -> str:
        t0 = int(self.tier0_bytes().sum())
        t1 = int(self.tier1_bytes().sum())
        return (f"{self.setting}/{self.mode} incremental: tier0 "
                f"{t0 / 1e6:.3f} MB, tier1 {t1 / 1e6:.3f} MB over "
                f"{self.n_layers} layers, total {(t0 + t1) / 1e6:.3f} MB")


def incremental_exchange_rows(halo_plan, dirty_local: np.ndarray, mode: str,
                              new_send: np.ndarray | None = None
                              ) -> np.ndarray:
    """[K, K] rows device i receives from peer j in one incremental halo
    exchange.

    ``dirty_local``: [K, n_max] bool — owned rows whose value changed since
    the peers last cached them. ``allgather`` re-broadcasts exactly the
    dirty rows (its peers cache *entire* tables from the cold-start
    broadcast, so a row structural churn newly exposes is already cached —
    ``new_send`` does not apply); ``alltoall`` ships the send-list slots
    whose source row is dirty, plus ``new_send`` slots (send-table entries
    created by structural churn — those peers have never cached, clean or
    not).
    """
    k = halo_plan.src_cluster.shape[0]
    if mode == "allgather":
        counts = dirty_local.sum(axis=1).astype(np.int64)   # [K]
        rows = np.tile(counts[None, :], (k, 1))
        np.fill_diagonal(rows, 0)
        return rows
    assert mode == "alltoall", mode
    ship = halo_plan.send_mask.copy()                       # [K, K, s_max]
    src_dirty = np.take_along_axis(
        dirty_local[:, None, :].repeat(k, axis=1),
        halo_plan.send_slot.astype(np.int64), axis=2)
    ship &= src_dirty if new_send is None else (src_dirty | new_send)
    return ship.sum(axis=2).T.astype(np.int64)              # recv view


def measure_incremental(plan, halo_plan, dirty_locals: np.ndarray,
                        cfg=None, mode: str = "alltoall",
                        new_send: np.ndarray | None = None
                        ) -> StreamingTrafficReport:
    """Bill one incremental tick of an ExecutionPlan's exchanges.

    ``dirty_locals``: [L+1, K, n_max] bool — the frontier masks in
    owned-row layout (level 0 = mutated input rows; level l = recomputed
    rows of h^l). Layer l's exchange ships level-l values, so its rows are
    counted against ``dirty_locals[l]``; tier 0 (semi) re-uploads only the
    level-0 mutations, attributed to the owning spoke via the hierarchy's
    gather tables.
    """
    dims = (tuple(cfg.dims[:-1]) if cfg is not None
            else (plan.graph.feature_len,))
    n_layers = len(dims)
    tier1 = np.stack([
        incremental_exchange_rows(halo_plan, dirty_locals[l], mode,
                                  new_send=new_send)
        for l in range(n_layers)])
    tier0 = np.zeros((0, 0), np.int64)
    if plan.setting == "semi":
        hier = plan.hier
        r, p = hier.n_heads, hier.spokes_per_region
        tier0 = np.zeros((r, p), np.int64)
        for reg in range(r):
            spokes = hier.gather_spoke[reg][dirty_locals[0][reg]]
            np.add.at(tier0[reg], spokes, 1)
    return StreamingTrafficReport(plan.setting, mode, dims, tier0, tier1)


def modeled_frontier(part, seed_frac: float, frac: float,
                     n_layers: int) -> np.ndarray:
    """Deterministic pseudo-frontier in owned-row layout for modeled
    incremental billing: level 0 covers the first ``ceil(seed_frac * n)``
    owned rows of each device (the churn seeds), levels 1..L the first
    ``ceil(frac * n)`` (the expanded dirty share). The planner's traffic
    evaluator feeds this to ``measure_incremental`` when it has a concrete
    partition but only a *modeled* churn profile (DESIGN.md §10); the
    streaming engine's measured masks supersede it at serve time."""
    k, n_max = part.local_mask.shape
    n_rows = part.local_mask.sum(axis=1)
    levels = np.zeros((n_layers + 1, k, n_max), bool)
    for level in range(n_layers + 1):
        f = min(max(seed_frac if level == 0 else frac, 0.0), 1.0)
        for c in range(k):
            take = int(np.ceil(n_rows[c] * f))
            levels[level, c, :take] = part.local_mask[c, :take]
    return levels


def measure_execution(plan, cfg=None, mode: str = "alltoall") -> TrafficReport:
    """Build the TrafficReport for an ExecutionPlan (any setting).

    ``cfg`` (a GNNConfig) supplies the per-layer feature dims; without it a
    single exchange at the graph's input feature dim is assumed.
    """
    from .halo import build_halo_plan
    dims = (tuple(cfg.dims[:-1]) if cfg is not None
            else (plan.graph.feature_len,))
    no_spokes = np.zeros((0, 0), np.int64)
    if plan.setting == "centralized":
        return TrafficReport(plan.setting, mode, dims, no_spokes,
                             np.zeros((1, 1), np.int64))
    halo_plan = build_halo_plan(plan.part)
    tier1 = exchange_rows(halo_plan, mode, plan.part.n_max)
    tier0 = (plan.hier.spoke_mask.sum(axis=2).astype(np.int64)
             if plan.setting == "semi" else no_spokes)
    return TrafficReport(plan.setting, mode, dims, tier0, tier1)
