"""Graph mutation buffer + amortized CSR rebuild for dynamic graphs.

A copy of ``repro.streaming.delta`` (numpy) over the port's own
``core.graph.Graph``, so that the port needs nothing of the JAX package.

The §4.2 taxi case study is a streaming workload: positions and demand maps
move every tick, and occasionally the road/proximity graph itself changes.
``GraphDelta`` buffers those mutations (feature updates, edge adds/removes)
against a fixed node set, and ``apply_deltas`` commits the whole buffer in
one vectorized CSR rebuild — O(E) numpy, amortized over however many ticks
were buffered, instead of a per-mutation splice.

Renormalization contract: ``Graph.gcn_normalize`` derives every edge weight
and the implicit self-loop weight purely from the degree profile
(``w_ij = 1/sqrt((d_i+1)(d_j+1))``, diagonal ``1/(d_i+1)``). A graph that
was normalized (``self_loop is not None``) therefore stays exactly on that
contract after any structural delta: ``apply_deltas`` recomputes the
normalization from the mutated structure, so the result is
indistinguishable from rebuilding the raw graph and calling
``gcn_normalize`` from scratch (regression-tested).

Dirt tracking: the result carries two [N] masks consumed by
``streaming.frontier``:

  * ``feature_dirty``   — nodes whose input feature row changed.
  * ``structure_dirty`` — nodes whose *aggregation inputs* changed: rows
    that gained/lost an edge, plus (normalized graphs only) every row
    touched by a degree change — a degree change at u rescales u's own row
    (self loop + all in-edges) *and* every edge elsewhere that reads u as a
    source, so those destination rows are dirty too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import Graph


@dataclasses.dataclass
class GraphDelta:
    """Buffered mutations over a fixed node set of size ``n_nodes``.

    Node additions/removals are out of scope (the serving plans pin the
    node set); ids out of ``[0, n_nodes)`` raise immediately so a bad tick
    cannot poison the buffer.
    """
    n_nodes: int
    _feat_nodes: list = dataclasses.field(default_factory=list)
    _feat_rows: list = dataclasses.field(default_factory=list)
    _add_dst: list = dataclasses.field(default_factory=list)
    _add_src: list = dataclasses.field(default_factory=list)
    _add_w: list = dataclasses.field(default_factory=list)
    _rm_dst: list = dataclasses.field(default_factory=list)
    _rm_src: list = dataclasses.field(default_factory=list)
    # per remove call: how many add-edges were buffered before it, so a
    # remove cancels earlier buffered adds but not later re-adds
    _rm_watermark: list = dataclasses.field(default_factory=list)

    def _check_ids(self, *arrays) -> None:
        for a in arrays:
            if a.size and (a.min() < 0 or a.max() >= self.n_nodes):
                raise IndexError(
                    f"node id out of range [0, {self.n_nodes}): "
                    f"[{a.min()}, {a.max()}]")

    def update_features(self, nodes, rows) -> "GraphDelta":
        """Replace the feature rows of ``nodes`` ([M] int) with ``rows``
        ([M, F]). Later updates to the same node win."""
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float32).reshape(len(nodes), -1)
        self._check_ids(nodes)
        self._feat_nodes.append(nodes)
        self._feat_rows.append(rows)
        return self

    def add_edges(self, dst, src, weight=None) -> "GraphDelta":
        """Append edges src -> dst (CSR rows are destinations). ``weight``
        ([M] or scalar) is only meaningful on unnormalized graphs — a
        normalized graph rederives every weight from the degree profile."""
        dst = np.asarray(dst, np.int64).reshape(-1)
        src = np.asarray(src, np.int64).reshape(-1)
        assert dst.shape == src.shape, (dst.shape, src.shape)
        self._check_ids(dst, src)
        w = np.broadcast_to(
            np.asarray(1.0 if weight is None else weight, np.float32),
            dst.shape).copy()
        self._add_dst.append(dst)
        self._add_src.append(src)
        self._add_w.append(w)
        return self

    def remove_edges(self, dst, src) -> "GraphDelta":
        """Remove every edge matching a (dst, src) pair (duplicate parallel
        edges all go) — including edges *added earlier in this buffer*; an
        add buffered after the remove survives. Unknown pairs are ignored.
        """
        dst = np.asarray(dst, np.int64).reshape(-1)
        src = np.asarray(src, np.int64).reshape(-1)
        assert dst.shape == src.shape, (dst.shape, src.shape)
        self._check_ids(dst, src)
        self._rm_dst.append(dst)
        self._rm_src.append(src)
        self._rm_watermark.append(sum(len(a) for a in self._add_dst))
        return self

    @property
    def has_structure(self) -> bool:
        return bool(self._add_dst or self._rm_dst)

    @property
    def has_features(self) -> bool:
        return bool(self._feat_nodes)

    def __len__(self) -> int:
        """Number of buffered mutations (feature rows + edge ops)."""
        return (sum(len(a) for a in self._feat_nodes)
                + sum(len(a) for a in self._add_dst)
                + sum(len(a) for a in self._rm_dst))

    def clear(self) -> None:
        for buf in (self._feat_nodes, self._feat_rows, self._add_dst,
                    self._add_src, self._add_w, self._rm_dst, self._rm_src,
                    self._rm_watermark):
            buf.clear()


@dataclasses.dataclass
class DeltaResult:
    """Mutated graph + the dirt masks ``streaming.frontier`` expands."""
    graph: Graph
    feature_dirty: np.ndarray     # [N] bool — input feature row changed
    structure_dirty: np.ndarray   # [N] bool — aggregation inputs changed

    @property
    def any_dirty(self) -> bool:
        return bool(self.feature_dirty.any() or self.structure_dirty.any())


def _edge_keys(dst: np.ndarray, src: np.ndarray, n: int) -> np.ndarray:
    return dst.astype(np.int64) * n + src.astype(np.int64)


def apply_deltas(g: Graph, delta: GraphDelta) -> DeltaResult:
    """Commit every buffered mutation in one amortized CSR rebuild.

    Returns a *new* Graph (``g`` is never mutated) plus the dirt masks.
    Within a row, surviving edges keep their original order and added edges
    append after them — so the padded-sample truncation of untouched rows
    is stable. The buffer is left intact; callers clear it after a commit.
    """
    n = g.n_nodes
    assert delta.n_nodes == n, (delta.n_nodes, n)
    normalized = g.self_loop is not None
    feature_dirty = np.zeros(n, bool)
    structure_dirty = np.zeros(n, bool)

    features = g.features
    if delta.has_features:
        features = features.copy()
        for nodes, rows in zip(delta._feat_nodes, delta._feat_rows):
            assert rows.shape[1] == features.shape[1], (
                rows.shape, features.shape)
            features[nodes] = rows
            feature_dirty[nodes] = True

    if not delta.has_structure:
        graph = Graph(g.indptr, g.indices, g.edge_weight, features,
                      g.self_loop)
        return DeltaResult(graph, feature_dirty, structure_dirty)

    deg_old = np.diff(g.indptr)
    dst_old = np.repeat(np.arange(n, dtype=np.int64), deg_old)
    keep = np.ones(g.n_edges, bool)
    add_dst = (np.concatenate(delta._add_dst) if delta._add_dst
               else np.zeros(0, np.int64))
    add_src = (np.concatenate(delta._add_src) if delta._add_src
               else np.zeros(0, np.int64))
    add_w = (np.concatenate(delta._add_w) if delta._add_w
             else np.zeros(0, np.float32))
    add_keep = np.ones(len(add_dst), bool)
    if delta._rm_dst:
        old_keys = _edge_keys(dst_old, g.indices.astype(np.int64), n)
        add_keys = _edge_keys(add_dst, add_src, n)
        add_pos = np.arange(len(add_dst))
        for rm_d, rm_s, mark in zip(delta._rm_dst, delta._rm_src,
                                    delta._rm_watermark):
            rm_keys = _edge_keys(rm_d, rm_s, n)
            keep &= ~np.isin(old_keys, rm_keys)
            # cancel adds buffered before this remove; later re-adds stand
            add_keep &= ~(np.isin(add_keys, rm_keys) & (add_pos < mark))
            structure_dirty[rm_d] = True
        add_dst, add_src, add_w = (add_dst[add_keep], add_src[add_keep],
                                   add_w[add_keep])
    structure_dirty[add_dst] = True

    old_w = (g.edge_weight[keep] if g.edge_weight is not None
             else np.ones(int(keep.sum()), np.float32))
    dst = np.concatenate([dst_old[keep], add_dst])
    src = np.concatenate([g.indices[keep].astype(np.int64), add_src])
    wts = np.concatenate([old_w, add_w])
    order = np.argsort(dst, kind="stable")     # old-before-new within a row
    dst, src, wts = dst[order], src[order], wts[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    graph = Graph(indptr, src.astype(np.int32), wts.astype(np.float32),
                  features)

    if normalized:
        graph = graph.gcn_normalize()          # rederives w_ij + self loop
        deg_changed = deg_old != np.diff(indptr)
        # a degree change at u rescales u's own row (self loop + in-edges)
        # and every row that reads u as a source
        structure_dirty |= deg_changed
        hit = deg_changed[graph.indices]
        structure_dirty[np.repeat(np.arange(n), np.diff(indptr))[hit]] = True
    return DeltaResult(graph, feature_dirty, structure_dirty)
