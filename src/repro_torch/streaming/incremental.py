"""Incremental GNN forward over an ExecutionPlan: recompute only the dirty
frontier, reuse cached per-layer activations for everything else.

The counterpart of ``repro.streaming.incremental``. ``IncrementalEngine``
wraps an ``ExecutionPlan`` (any setting × any backend) and maintains:

  * the evolving ``Graph`` (mutated via ``streaming.delta``),
  * cached per-layer activations on the device, in the plan's owned-row
    layout ``[K, n_max, F_l]`` for levels 0..L (level 0 is the input table
    — for semi this is the tier-0-assembled region table),
  * the plan's structural tables, rebuilt in place on edge deltas with the
    *same* cluster assignment (nodes never migrate mid-stream, so the
    caches stay row-aligned; only the halo/send tables change).

Per tick, ``apply_delta`` commits the mutation buffer, expands the k-hop
dirty frontier (``streaming.frontier``), and re-runs each layer only on its
dirty rows — through the same per-device layer step
(``core.gnn.layer_step``, the ``_layer_step`` of ``distributed.halo``)
every backend-setting combination uses, so incremental output matches a
full recompute to fp32 tolerance. The recomputed rows are written into the
device-resident cache in place (``index_copy_``, real rows only), level l
before layer l + 1 reads it. Halo inputs for dirty rows are gathered from
the cached level-(l-1) owned tables; the wire traffic a real deployment
would ship for that gather — only rows whose value changed, plus send
slots structural churn newly created — is billed by
``distributed.traffic.measure_incremental``.

With a ``launch.mesh.Mesh`` of ``n_clusters`` ranks on a dense
decentralized or semi plan, a full refresh runs on the SPMD runtime: each
rank computes its own cluster's rows of every level, exchanging halos by
collectives, and each level is all-gathered, so every rank holds the full
caches the dirty-row steps read; those steps stay as they are, the same
on every rank.

Degradation to full refresh: bit-accurate crossbar numerics
(``cfg.numerics.ideal=False``) quantize against a *global* DAC scale
``max|Z|``, so a subset recompute would see a different scale than a full
pass and drift; the engine detects this and falls back to a full refresh
(``StreamingUpdate.full=True``) rather than serve non-reproducible
embeddings.

Dirty row counts vary every tick; the engine pads each recompute batch to
the next power of two (padded rows are sliced off), so at most
O(log n_max) launch shapes per (layer, cluster shape) ever occur — the
unit of the ``streaming.recompile_estimate`` counter, kept equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import telemetry as tel
from .._device import resolve_device
from ..core.partition import (ExecutionPlan, _from_assignment,
                              bucket_partition, build_bucketed_subgraphs,
                              build_local_subgraphs, gather_bucketed_features,
                              gather_features, gather_spoke_features)
from ..distributed.halo import (HaloPlan, _bucket_layer, _flat_rows,
                                _gather_halo, _layer_step, _plan_consts,
                                _spmd_layers, build_bucketed_halo_plan,
                                build_halo_plan)
from ..distributed.traffic import StreamingTrafficReport, measure_incremental
from .delta import DeltaResult, GraphDelta, apply_deltas
from .frontier import FRONTIER_MODES, FrontierMasks, expand_frontier

_MIN_BUCKET = 8


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n (>= _MIN_BUCKET), capped at the table size."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, cap)


def _pad_rows(rows: np.ndarray, cap: int) -> np.ndarray:
    """Bucket-pad a dirty-row batch by repeating its first row, so the
    launch shapes repeat across ticks (pad rows recompute the same value
    and are sliced off before the cache is written)."""
    padded = np.full(_bucket(len(rows), cap), rows[0], np.int64)
    padded[:len(rows)] = rows
    return padded


@dataclasses.dataclass
class StreamingUpdate:
    """Outcome of one committed tick."""
    frontier: FrontierMasks
    traffic: StreamingTrafficReport | None   # None for centralized
    seconds: float                           # wall-clock of the commit
    full: bool                               # True => degraded to full refresh

    @property
    def recompute_fraction(self) -> float:
        return 1.0 if self.full else self.frontier.recompute_fraction()


class IncrementalEngine:
    """Streaming counterpart of ``ExecutionPlan.make_forward``.

    ``params`` are the port's ``[{"w", "b"}, ...]`` tensors on ``device``,
    which defaults to CUDA and raises without it unless ``device="cpu"``.
    ``mesh``: full refreshes on the SPMD runtime where the plan takes it
    (``device`` must then name the mesh's).
    """

    def __init__(self, plan: ExecutionPlan, cfg, params,
                 mode: str = "alltoall", frontier_mode: str = "numpy",
                 device="cuda", mesh=None):
        if frontier_mode not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode {frontier_mode!r}; "
                             f"one of {FRONTIER_MODES}")
        if mesh is not None:
            from ..launch.mesh import mesh_device
            device = mesh_device(mesh, device)
        self.device = resolve_device(device)
        self._mesh = mesh
        self.plan = plan
        self.cfg = plan.gnn_config(cfg)
        self.params = params
        self.mode = mode
        self.frontier_mode = frontier_mode
        self.graph = plan.graph
        self.n_layers = len(params)
        self.sample = plan.sample
        # global padded sample of the live graph: frontier expansion +
        # the centralized runtime read the same truncated edge set
        self._gnbr, self._gwts = self.graph.neighbor_sample(self.sample)
        self._halo_plan: HaloPlan | None = None
        if plan.part is not None:
            self._bind_halo_tables(build_halo_plan(plan.part))
        # bucketed ragged layout: values move through the bucketed flat
        # gather; the dense _halo_plan above stays the billing source of
        # truth for the traffic accountant
        self._bp = plan.bucketed
        if self._bp is not None:
            self._bind_bucketed_tables()
        self._new_send: np.ndarray | None = None  # send slots churn created
        self._acts: list | None = None            # [K, n_max, F_l] per level
        #                                 (bucketed: per level a LIST of
        #                                  per-bucket [K_b, n_cap, F_l])
        self.last_update: StreamingUpdate | None = None
        self.ticks = 0
        # (layer, table_rows, padded_rows) triples seen by the dirty-rows
        # recompute — each new triple is a new launch shape, the telemetry
        # recompile-estimate counter's unit
        self._compiled_keys: set = set()

    # ---- layout helpers -------------------------------------------------

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A contiguous copy of host array ``a`` on the engine's device
        (a copy on the CPU too: the caches are patched in place and must
        not alias the graph's tables)."""
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=self.device)

    def _bind_halo_tables(self, hp: HaloPlan) -> None:
        self._halo_plan = hp
        self._hsrc_c = self._tensor(hp.src_cluster, torch.int64)
        self._hsrc_s = self._tensor(hp.src_slot, torch.int64)
        self._hmask = self._tensor(hp.halo_mask, torch.float32)

    def _bind_bucketed_tables(self) -> None:
        self._bhalo = build_bucketed_halo_plan(self._bp)
        self._bfidx = tuple(self._tensor(i, torch.int64)
                            for i in self._bhalo.flat_src)
        self._bfmask = tuple(self._tensor(m) for m in self._bhalo.halo_mask)

    @property
    def _k(self) -> int:
        return self.plan.n_clusters

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_local(self, gmask: np.ndarray) -> np.ndarray:
        """[N] global bool -> [K, n_max] owned-row bool."""
        if self.plan.part is None:
            return gmask[None].copy()
        part = self.plan.part
        return gmask[part.local_nodes] & part.local_mask

    def _owned_features(self):
        """[K, n_max, F0] level-0 table (semi: the tier-0 assembled region
        tables — same rows the spoke gather produces). Bucketed plans
        return the per-bucket tuple instead."""
        if self._bp is not None:
            return gather_bucketed_features(self.graph, self._bp)
        if self.plan.part is None:
            return self.graph.features[None].astype(np.float32, copy=False)
        return gather_features(self.graph, self.plan.part)

    def _halo_table(self, owned: torch.Tensor) -> torch.Tensor | None:
        """[K, h_max, F] halo rows gathered from the stacked owned tables
        (the emulated exchange's value semantics; what a real deployment
        ships to keep this table fresh is billed separately)."""
        if self._halo_plan is None:
            return None
        return owned[self._hsrc_c, self._hsrc_s] * self._hmask[..., None]

    # ---- full refresh ---------------------------------------------------

    def full_refresh(self) -> float:
        """(Re)compute every cached level from scratch; returns seconds.

        Caches are kept on the device so incremental ticks patch dirty
        rows in place instead of re-uploading whole tables."""
        with tel.span("engine.full_refresh"):
            return self._full_refresh_impl()

    @torch.no_grad()
    def _full_refresh_impl(self) -> float:
        t0 = time.perf_counter()
        nbr, wts = self.plan.neighbors, self.plan.weights
        if self._bp is not None:
            acts = [[self._tensor(f) for f in self._owned_features()]]
            nbrs = [self._tensor(a) for a in nbr]
            wtss = [self._tensor(a) for a in wts]
            for l in range(self.n_layers):
                act = l < self.n_layers - 1 or self.cfg.final_activation
                flat = _flat_rows(acts[l])
                acts.append([
                    _bucket_layer(acts[l][b],
                                  _gather_halo(flat, self._bfidx[b],
                                               self._bfmask[b]),
                                  nbrs[b], wtss[b], self.params[l], self.cfg,
                                  act)
                    for b in range(self._bp.n_buckets)])
            self._sync_device()
            self._acts = acts
            return time.perf_counter() - t0
        acts = [self._tensor(self._owned_features())]
        if self.plan._spmd(self._mesh):
            self._acts = self._spmd_levels(acts, nbr, wts)
            self._sync_device()
            return time.perf_counter() - t0
        nbr_t, wts_t = self._tensor(nbr), self._tensor(wts)
        for l in range(self.n_layers):
            act = l < self.n_layers - 1 or self.cfg.final_activation
            halo = self._halo_table(acts[l])
            outs = []
            for c in range(self._k):
                table = (acts[l][c] if halo is None
                         else torch.cat([acts[l][c], halo[c]], dim=0))
                outs.append(_layer_step(table, nbr_t[c], wts_t[c],
                                        self.params[l], self.cfg, act))
            acts.append(torch.stack(outs))
        self._sync_device()
        self._acts = acts
        return time.perf_counter() - t0

    def _spmd_levels(self, acts: list, nbr, wts) -> list:
        """Levels 1..L appended to ``acts`` by the SPMD layer loop: this
        rank's cluster rows, every level all-gathered to [K, n_max, F_l]."""
        r = self._mesh.rank
        _spmd_layers(self.params, acts[0][r], self._tensor(nbr[r]),
                     self._tensor(wts[r]), self.cfg,
                     _plan_consts(self._halo_plan, self.device, r),
                     self.mode, self._halo_plan.src_cluster.shape[1],
                     self._mesh, levels=acts)
        return acts

    def _sync_plan_feats(self, dirty0_local: np.ndarray | None = None
                         ) -> None:
        """The engine mutates the shared ExecutionPlan in place; keep its
        ``feats`` tables consistent with the live graph so a later
        ``plan.make_forward`` (or a fresh server on the same plan) sees
        current features. ``dirty0_local`` patches only mutated rows; None
        rebuilds wholesale."""
        g, plan = self.graph, self.plan
        # feature-only commits never route through _rebuild_structure, so
        # the live graph must be re-bound here too — a consumer reading
        # plan.graph would otherwise see cold-start features forever
        plan.graph = g
        if plan.part is None:
            plan.feats = g.features[None]                # view, O(1)
            return
        if plan.bucketed is not None and plan.setting != "semi":
            bp = plan.bucketed
            if dirty0_local is None:
                plan.feats = gather_bucketed_features(g, bp)
                return
            for c in range(self._k):
                rows = np.nonzero(dirty0_local[c])[0]
                if len(rows):
                    plan.feats[bp.bucket_of[c]][bp.index_in[c], rows] = \
                        g.features[plan.part.local_nodes[c][rows]]
            return
        if plan.setting == "semi":
            hier = plan.hier
            if dirty0_local is None:
                plan.feats = gather_spoke_features(g, hier)
                return
            for r in range(self._k):
                rows = np.nonzero(dirty0_local[r])[0]
                if len(rows):
                    plan.feats[r, hier.gather_spoke[r, rows],
                               hier.gather_slot[r, rows]] = \
                        g.features[plan.part.local_nodes[r][rows]]
            return
        if dirty0_local is None:
            plan.feats = gather_features(g, plan.part)
            return
        for c in range(self._k):
            rows = np.nonzero(dirty0_local[c])[0]
            if len(rows):
                plan.feats[c][rows] = \
                    g.features[plan.part.local_nodes[c][rows]]

    # ---- structural rebuild --------------------------------------------

    def _rebuild_structure(self) -> None:
        """Re-derive the plan's tables from the mutated graph, keeping the
        node->cluster assignment (owned rows stay put; halo/send tables and
        the global sample change)."""
        g = self.graph
        plan = self.plan
        self._gnbr, self._gwts = g.neighbor_sample(self.sample)
        plan.graph = g
        if plan.part is None:
            plan.neighbors = self._gnbr[None]
            plan.weights = self._gwts[None]
            return
        part = _from_assignment(g, plan.part.assignment, self._k,
                                sample=self.sample)
        old = self._halo_plan
        new = build_halo_plan(part)
        self._new_send = _new_send_slots(old, new)
        self._bind_halo_tables(new)
        plan.part = part
        if self._bp is not None:
            # re-bucket with the previous grouping and never-shrinking caps
            # (same assignment => same cluster sizes => same groups), so
            # the cached activations keep their shapes and only the
            # halo/neighbor tables change
            bp = bucket_partition(part, g, self.sample, like=self._bp)
            nbrs, wtss = build_bucketed_subgraphs(g, bp)
            self._bp = bp
            plan.bucketed = bp
            self._bind_bucketed_tables()
            plan.sub = None
            plan.neighbors = nbrs
            plan.weights = wtss
        else:
            sub = build_local_subgraphs(g, part, self.sample)
            plan.sub = sub
            plan.neighbors = sub.neighbors
            plan.weights = sub.weights
        if plan.hier is not None:
            plan.hier = dataclasses.replace(plan.hier, region=part)

    # ---- incremental tick ----------------------------------------------

    def apply_delta(self, delta: GraphDelta) -> StreamingUpdate:
        """Commit a mutation buffer and refresh only the dirty frontier.

        The buffer is cleared on success. Requires a prior ``full_refresh``
        (the caches must exist before they can be patched).
        """
        if self._acts is None:
            raise RuntimeError("call full_refresh() before apply_delta()")
        t0 = time.perf_counter()
        with tel.span("engine.apply_deltas"):
            res = apply_deltas(self.graph, delta)
            self.graph = res.graph
            if res.structure_dirty.any():
                self._rebuild_structure()
        update = self._refresh_dirty(res, t0)
        delta.clear()
        self.ticks += 1
        self.last_update = update
        return update

    def _expand(self, fd: np.ndarray, sd: np.ndarray) -> FrontierMasks:
        with tel.span("engine.frontier", mode=self.frontier_mode):
            return expand_frontier(self._gnbr, self._gwts, fd, sd,
                                   self.n_layers, mode=self.frontier_mode,
                                   device=self.device)

    def _refresh_dirty(self, res: DeltaResult, t0: float) -> StreamingUpdate:
        l_total = self.n_layers
        fr = self._expand(res.feature_dirty, res.structure_dirty)
        if not self.cfg.numerics.ideal:
            # global DAC scale couples every row — subset recompute would
            # quantize against a stale max|Z|: degrade
            self._sync_plan_feats()
            secs = self.full_refresh()
            self._new_send = None
            return StreamingUpdate(fr, self._full_traffic(), secs, full=True)
        dirty_locals = np.stack([self._to_local(fr.masks[l])
                                 for l in range(l_total + 1)])
        self._note_frontier(fr, dirty_locals)
        # level 0: patch mutated feature rows into the cached input table
        # (and the shared plan's feats tables, which track the live graph)
        self._sync_plan_feats(dirty_locals[0])
        with tel.span("engine.dirty_rows"), torch.no_grad():
            self._patch_inputs(dirty_locals[0])
            if self._bp is not None:
                self._refresh_dirty_bucketed(dirty_locals, l_total)
            else:
                self._refresh_dirty_dense(dirty_locals, l_total)
            self._sync_device()
        traffic = None
        if self._halo_plan is not None:
            traffic = measure_incremental(
                self.plan, self._halo_plan, dirty_locals, self.cfg,
                mode=self.mode, new_send=self._new_send)
        self._new_send = None
        return StreamingUpdate(fr, traffic, time.perf_counter() - t0,
                               full=False)

    def _patch_inputs(self, dirty0: np.ndarray) -> None:
        """Write the mutated input rows of each cluster into the level-0
        cache, in place."""
        part = self.plan.part
        for c in range(self._k):
            rows = np.nonzero(dirty0[c])[0]
            if not len(rows):
                continue
            ids = rows if part is None else part.local_nodes[c][rows]
            vals = self._tensor(self.graph.features[ids])
            rows_t = self._tensor(rows, torch.int64)
            if self._bp is not None:
                b, j = int(self._bp.bucket_of[c]), int(self._bp.index_in[c])
                self._acts[0][b][j].index_copy_(0, rows_t, vals)
            else:
                self._acts[0][c].index_copy_(0, rows_t, vals)

    def _note_frontier(self, fr: FrontierMasks,
                       dirty_locals: np.ndarray) -> None:
        """Dirty-fraction / cache-reuse accounting for one tick."""
        reg = tel.get_registry()
        if not reg.enabled:
            return
        recomputed = int(dirty_locals[1:].sum())
        owned = (int(self.plan.part.local_mask.sum())
                 if self.plan.part is not None else self.graph.n_nodes)
        reg.counter("streaming.rows_recomputed").inc(recomputed)
        reg.counter("streaming.rows_cached").inc(
            max(self.n_layers * owned - recomputed, 0))
        reg.gauge("streaming.dirty_fraction").set(
            float(fr.recompute_fraction()))

    def _note_compile(self, key: tuple) -> None:
        """Count first-seen (layer, table_rows, padded_rows) shape triples —
        each is one new launch shape of the dirty-rows step."""
        if key not in self._compiled_keys:
            self._compiled_keys.add(key)
            tel.counter("streaming.recompile_estimate").inc()

    def _step_rows(self, l: int, table: torch.Tensor, sub_nbr: np.ndarray,
                   sub_wts: np.ndarray, act: bool, span_kw: dict
                   ) -> torch.Tensor:
        """Layer ``l`` on the padded dirty rows of one cluster."""
        with tel.get_tracer().span("halo.mvm", layer=l, **span_kw):
            return _layer_step(table, self._tensor(sub_nbr),
                               self._tensor(sub_wts), self.params[l],
                               self.cfg, act)

    def _refresh_dirty_dense(self, dirty_locals: np.ndarray,
                             l_total: int) -> None:
        tracer = tel.get_tracer()
        nbr, wts = self.plan.neighbors, self.plan.weights
        n_max = dirty_locals.shape[2]
        for l in range(l_total):
            act = l < l_total - 1 or self.cfg.final_activation
            d = dirty_locals[l + 1]
            if not d.any():
                continue
            for c in range(self._k):
                rows = np.nonzero(d[c])[0]
                if not len(rows):
                    continue
                padded = _pad_rows(rows, d.shape[1])
                sub_nbr, sub_wts = nbr[c][padded], wts[c][padded]
                table = self._acts[l][c]
                if self._halo_plan is not None and (sub_nbr >= n_max).any():
                    # only pay the halo gather when a dirty row reads one
                    with tracer.span("halo.gather", layer=l, cluster=c):
                        halo = (self._acts[l][self._hsrc_c[c],
                                              self._hsrc_s[c]]
                                * self._hmask[c][:, None])
                        table = torch.cat([table, halo], dim=0)
                self._note_compile((l, int(table.shape[0]), len(padded)))
                out = self._step_rows(l, table, sub_nbr, sub_wts, act,
                                      dict(cluster=c, rows=len(rows)))
                with tracer.span("cache.scatter", layer=l + 1, cluster=c):
                    self._acts[l + 1][c].index_copy_(
                        0, self._tensor(rows, torch.int64), out[:len(rows)])

    def _refresh_dirty_bucketed(self, dirty_locals: np.ndarray,
                                l_total: int) -> None:
        """Per-bucket dirty-row patch: same dirty-row indices as the dense
        layout (owned rows are the members prefix in both), halo values via
        the bucketed flat gather, caches patched in place."""
        bp = self._bp
        tracer = tel.get_tracer()
        nbrs, wtss = self.plan.neighbors, self.plan.weights
        for l in range(l_total):
            act = l < l_total - 1 or self.cfg.final_activation
            d = dirty_locals[l + 1]
            if not d.any():
                continue
            flat = None
            for c in range(self._k):
                rows = np.nonzero(d[c])[0]
                if not len(rows):
                    continue
                b, j = int(bp.bucket_of[c]), int(bp.index_in[c])
                padded = _pad_rows(rows, bp.n_caps[b])
                sub_nbr = nbrs[b][j][padded]
                sub_wts = wtss[b][j][padded]
                table = self._acts[l][b][j]
                if (sub_nbr >= bp.n_caps[b]).any():
                    # only pay the flat build + halo gather when a dirty
                    # row actually reads a halo slot this layer
                    with tracer.span("halo.gather", layer=l, bucket=b,
                                     cluster=c):
                        if flat is None:
                            flat = _flat_rows(self._acts[l])
                        halo = _gather_halo(flat, self._bfidx[b][j],
                                            self._bfmask[b][j])
                        table = torch.cat([table, halo], dim=0)
                self._note_compile((l, b, int(table.shape[0]), len(padded)))
                out = self._step_rows(l, table, sub_nbr, sub_wts, act,
                                      dict(bucket=b, cluster=c,
                                           rows=len(rows)))
                with tracer.span("cache.scatter", layer=l + 1, bucket=b):
                    self._acts[l + 1][b][j].index_copy_(
                        0, self._tensor(rows, torch.int64), out[:len(rows)])

    def commit_full(self, delta: GraphDelta | None = None) -> StreamingUpdate:
        """Apply a buffer (optional) and rebuild every cache level — the
        full-refresh path param swaps, cold starts, and the bit-accurate
        degradation route through. Unlike ``apply_delta`` it needs no
        existing caches."""
        t0 = time.perf_counter()
        n = self.graph.n_nodes
        fd = np.zeros(n, bool)
        sd = np.zeros(n, bool)
        if delta is not None and len(delta):
            with tel.span("engine.apply_deltas"):
                res = apply_deltas(self.graph, delta)
                self.graph = res.graph
                if res.structure_dirty.any():
                    self._rebuild_structure()
            fd, sd = res.feature_dirty, res.structure_dirty
            delta.clear()
            self._sync_plan_feats()
        self.full_refresh()
        fr = self._expand(fd, sd)
        self._new_send = None
        self.ticks += 1
        self.last_update = StreamingUpdate(
            fr, self._full_traffic(), time.perf_counter() - t0, full=True)
        return self.last_update

    def _full_traffic(self) -> StreamingTrafficReport | None:
        """Per-layer billing of a full refresh (the degraded path ships
        everything every layer)."""
        if self._halo_plan is None:
            return None
        part = self.plan.part
        all_dirty = np.stack([part.local_mask] * (self.n_layers + 1))
        return measure_incremental(self.plan, self._halo_plan, all_dirty,
                                   self.cfg, mode=self.mode, new_send=None)

    # ---- outputs --------------------------------------------------------

    def embeddings(self) -> np.ndarray:
        """[N, out_dim] current embeddings in global node order."""
        if self._acts is None:
            raise RuntimeError("call full_refresh() first")
        return self.plan.scatter(self._acts[-1])


def _new_send_slots(old: HaloPlan, new: HaloPlan) -> np.ndarray | None:
    """Bool mask over ``new``'s send table marking slots absent from
    ``old`` — rows an alltoall must ship after structural churn even when
    their source value is clean (the peer has never cached them)."""
    if old is None:
        return None
    base = np.int64(max(int(old.send_slot.max(initial=0)),
                        int(new.send_slot.max(initial=0))) + 1)

    def keys(plan: HaloPlan) -> np.ndarray:
        k = plan.send_slot.shape[0]
        c = np.arange(k, dtype=np.int64)[:, None, None]
        j = np.arange(k, dtype=np.int64)[None, :, None]
        return (c * k + j) * base + plan.send_slot

    have = keys(old)[old.send_mask]
    return new.send_mask & ~np.isin(keys(new), have)
