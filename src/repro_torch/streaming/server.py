"""StreamingGNNServer: batched serving over a dynamic graph.

The counterpart of ``repro.streaming.server``, and the streaming
counterpart of ``launch.gnn.GNNServer``: a tick stream
(``core.taxi.synthetic_stream``-style feature maps, plus optional edge
events) flows in through ``ingest``, mutations buffer into a
``streaming.delta.GraphDelta``, and a refresh *policy* decides when the
buffer commits through the ``IncrementalEngine`` — so serving cost scales
with the churn, not the graph:

  * ``eager``             — commit on every tick (freshest embeddings,
    one incremental refresh per tick).
  * ``interval``          — commit every ``interval`` ticks (amortizes the
    k-hop frontier over several ticks' mutations).
  * ``bounded-staleness`` — commit when the buffered ticks exceed
    ``max_staleness`` or the pending dirty-node fraction exceeds
    ``max_dirty_frac`` — the knob the ROADMAP's heavy-traffic serving
    story needs: embeddings are at most that stale, and refresh work is
    triggered by how much of the graph actually moved.

``query`` is batched: ids are validated against the served embedding
table and gathered in one fancy index (inherited from ``GNNServer`` — see
``launch.gnn``). Between commits, queries serve the policy-bounded stale
embeddings; ``flush()`` forces a commit.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import telemetry as tel
from ..core.partition import ExecutionPlan
from ..launch.gnn import GNNServer
from .delta import GraphDelta
from .incremental import IncrementalEngine, StreamingUpdate

POLICIES = ("eager", "interval", "bounded-staleness")

_LOG = logging.getLogger(__name__)


class StreamingGNNServer(GNNServer):
    """GNNServer over an IncrementalEngine with buffered ingest, on
    ``device`` (CUDA by default; raises without it unless ``"cpu"``).
    ``mesh`` goes to ``GNNServer`` and the engine: full refreshes run on
    the SPMD runtime where the plan takes it."""

    def __init__(self, plan: ExecutionPlan, cfg, params=None, mesh=None,
                 seed: int = 0, mode: str = "alltoall",
                 policy: str = "eager", interval: int = 4,
                 max_staleness: int = 8, max_dirty_frac: float = 0.25,
                 frontier_mode: str = "numpy", device="cuda"):
        if policy not in POLICIES:
            raise ValueError(f"unknown refresh policy {policy!r}; one of "
                             f"{POLICIES}")
        super().__init__(plan, cfg, params=params, mesh=mesh, seed=seed,
                         mode=mode, device=device)
        self.policy = policy
        self.interval = interval
        self.max_staleness = max_staleness
        self.max_dirty_frac = max_dirty_frac
        self.frontier_mode = frontier_mode
        self.engine = IncrementalEngine(plan, cfg, self.params, mode=mode,
                                        frontier_mode=frontier_mode,
                                        device=self.device, mesh=mesh)
        self.updates: list[StreamingUpdate] = []
        self.commits = 0
        self.full_refreshes = 0
        # commit observers: fn(server, update), called after every commit —
        # the planner's online re-plan hook and load harnesses subscribe
        # here
        self.observers: list = []
        self._reset_buffers()

    def add_observer(self, fn) -> None:
        """Subscribe ``fn(server, update)`` to every committed tick.

        Observer exceptions are isolated: a raising observer is logged and
        skipped, never aborting the commit (the embeddings are already
        swapped by the time observers run)."""
        self.observers.append(fn)

    def remove_observer(self, fn) -> bool:
        """Unsubscribe a commit observer; returns False when absent."""
        try:
            self.observers.remove(fn)
            return True
        except ValueError:
            return False

    def _reset_buffers(self) -> None:
        n = self.engine.graph.n_nodes
        self._pending = GraphDelta(n)
        self._pending_ticks = 0
        self._pending_dirty = np.zeros(n, bool)
        # the stream's live view of node features: committed features plus
        # every buffered update, so tick diffs are against what the *next*
        # commit will see (a node reverting to its committed value between
        # commits still needs its revert recorded)
        self._live_feats = self.engine.graph.features.copy()

    # ---- ingest ---------------------------------------------------------

    def ingest(self, x_t=None, *, nodes=None, rows=None,
               add_edges=None, remove_edges=None) -> StreamingUpdate | None:
        """Consume one stream tick; commit per the refresh policy.

        ``x_t``: full [N, F] tick (synthetic_stream-style) — changed rows
        are diffed out automatically. ``nodes``/``rows``: sparse update of
        ``rows[i]`` at ``nodes[i]``. ``add_edges``/``remove_edges``:
        (dst, src) array pairs of edge events. Returns the
        ``StreamingUpdate`` when this tick triggered a commit, else None.
        """
        with tel.span("server.ingest", policy=self.policy):
            return self._ingest(x_t, nodes=nodes, rows=rows,
                                add_edges=add_edges,
                                remove_edges=remove_edges)

    def _ingest(self, x_t=None, *, nodes=None, rows=None,
                add_edges=None, remove_edges=None) -> StreamingUpdate | None:
        if x_t is not None:
            x_t = np.asarray(x_t, np.float32).reshape(self._live_feats.shape)
            changed = np.nonzero(np.any(x_t != self._live_feats, axis=1))[0]
            if len(changed):
                self._record_features(changed, x_t[changed])
        if nodes is not None:
            nodes = np.asarray(nodes, np.int64).reshape(-1)
            rows = np.asarray(rows, np.float32).reshape(len(nodes), -1)
            self._record_features(nodes, rows)
        if add_edges is not None:
            dst, src = add_edges
            self._pending.add_edges(dst, src)
            self._pending_dirty[np.asarray(dst, np.int64)] = True
        if remove_edges is not None:
            dst, src = remove_edges
            self._pending.remove_edges(dst, src)
            self._pending_dirty[np.asarray(dst, np.int64)] = True
        self._pending_ticks += 1
        if self._should_commit():
            return self._commit()
        return None

    def _record_features(self, nodes: np.ndarray, rows: np.ndarray) -> None:
        self._pending.update_features(nodes, rows)
        self._pending_dirty[nodes] = True
        self._live_feats[nodes] = rows

    def _should_commit(self) -> bool:
        if self.policy == "eager":
            return True
        if self.policy == "interval":
            return self._pending_ticks >= self.interval
        return (self._pending_ticks >= self.max_staleness
                or float(self._pending_dirty.mean()) >= self.max_dirty_frac)

    def flush(self) -> StreamingUpdate | None:
        """Force-commit whatever is buffered (no-op when nothing is)."""
        if self._pending_ticks or len(self._pending):
            return self._commit()
        return None

    @property
    def pending_ticks(self) -> int:
        return self._pending_ticks

    # ---- commit / refresh ----------------------------------------------

    def _commit(self) -> StreamingUpdate:
        eng = self.engine
        with tel.span("server.commit", policy=self.policy) as sp:
            if eng._acts is None or self._served_version != self.version:
                # cold start or params/plan moved: every cache level is
                # invalid
                eng.params = self.params
                upd = eng.commit_full(self._pending)
                self.full_refreshes += 1
            else:
                upd = eng.apply_delta(self._pending)
                if upd.full:
                    self.full_refreshes += 1
            sp.set(full=upd.full)
            tel.record_commit(upd, self.plan.setting)
            self._pending_ticks = 0
            self._pending_dirty[:] = False
            self._live_feats = eng.graph.features.copy()
            self.embeddings = eng.embeddings()
        self.commits += 1
        self.refreshes += 1
        self._served_version = self.version
        self.updates.append(upd)
        for fn in list(self.observers):
            # observer isolation: a raising observer must not abort the
            # commit — embeddings are already swapped; log and continue
            try:
                fn(self, upd)
            except Exception:
                _LOG.exception("commit observer %r raised; continuing", fn)
        return upd

    def refresh(self) -> float:
        """Bring served embeddings current (incremental when the caches are
        valid — the streaming analogue of GNNServer's full recompute)."""
        return self._commit().seconds

    def update_plan(self, plan: ExecutionPlan, cfg=None) -> None:
        """Swap the plan/graph wholesale: the engine and every stream
        buffer restart against the new node set."""
        super().update_plan(plan, cfg)
        self.engine = IncrementalEngine(plan, self.cfg, self.params,
                                        mode=self.mode,
                                        frontier_mode=self.frontier_mode,
                                        device=self.device, mesh=self._mesh)
        self._reset_buffers()
