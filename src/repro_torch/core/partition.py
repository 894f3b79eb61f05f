"""Graph partitioning and the centralized/decentralized/semi execution plan.

A copy of the dense host tables of ``repro.core.partition`` (numpy), so
that the port needs nothing of the JAX package. ``partition(graph, k)``
splits a CSR graph into k clusters and derives the padded device-local
subgraphs and the halo tables; ``hier_partition`` builds the two-tier
semi-decentralized hierarchy; ``ExecutionPlan`` runs one GNN in any of the
three settings on the port's backends:

  * ``jnp``    — plain PyTorch ops (the reference's name for its backend of
    plain array ops);
  * ``pallas`` — composed: the hand-written aggregation kernel, then the
    matmul or the plain crossbar numerics (the reference's name for its
    backend of hand-written kernels);
  * ``fused``  — the hand-written fused layer kernels.

``plan_execution(buckets=...)`` selects the capacity-bucketed ragged
layout (``BucketedPartition``): clusters grouped into power-of-two
capacity buckets, each paying its bucket's capacity instead of the largest
cluster's; ``ExecutionPlan.layout_stats`` prices it against the dense
layout, and ``rebalance`` moves load off slow clusters.

``ExecutionPlan.measured_traffic`` bills the exchanges' wire bytes
(``distributed.traffic``), and ``make_forward`` wraps its forward in the
telemetry's ``plan.forward`` span (``telemetry.instrument_forward``).
``predicted_metrics`` prices the plan's setting with the paper's cost
model (``core.costmodel``), ``compile_mapping`` / ``mapping_report``
compile its workload onto the modeled crossbar inventory
(``repro_torch.mapper``): both describe the paper's in-memory edge
devices, not the card. ``tune_kernels`` picks the Hopper kernels' launch
choices for the plan's shapes (``repro_torch.tuning``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph, GraphStats



@dataclasses.dataclass
class Partition:
    assignment: np.ndarray        # [N] int32 cluster id per node
    n_clusters: int
    # device-local tensors, all padded to uniform sizes across clusters:
    local_nodes: np.ndarray       # [K, n_max] int32 global node ids (pad: -1)
    local_mask: np.ndarray        # [K, n_max] bool
    halo_nodes: np.ndarray        # [K, h_max] int32 global ids needed from
    halo_src: np.ndarray          # [K, h_max] int32 owning cluster (pad: -1)
    comm_volume: np.ndarray       # [K, K] int64 e_ij: feature rows cluster i
    #                               receives from cluster j per layer (unique
    #                               remote sources of its boundary edges — the
    #                               rows the alltoall exchange ships)
    sample: int | None = None     # the neighbor-sample size the halo/comm
    #                               tables were pruned to (None: unpruned)

    @property
    def n_max(self) -> int:
        return self.local_nodes.shape[1]

    @property
    def h_max(self) -> int:
        return self.halo_nodes.shape[1]

    def cluster_stats(self, g: Graph, k: int) -> GraphStats:
        nodes = self.local_nodes[k][self.local_mask[k]]
        deg = np.diff(g.indptr)[nodes] if len(nodes) else np.zeros(1)
        return GraphStats(f"cluster{k}", len(nodes), int(deg.sum()),
                          g.feature_len, float(deg.mean() if len(deg) else 0))


def _bfs_clusters(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Greedy balanced BFS growth from k spread-out seeds."""
    n = g.n_nodes
    target = -(-n // k)
    rng = np.random.default_rng(seed)
    assignment = np.full(n, -1, np.int32)
    seeds = rng.choice(n, size=min(k, n), replace=False)
    frontiers = [[int(s)] for s in seeds]
    sizes = np.zeros(k, np.int64)
    for c, s in enumerate(seeds):
        assignment[s] = c
        sizes[c] = 1
    active = True
    while active:
        active = False
        for c in range(k):
            if sizes[c] >= target or not frontiers[c]:
                continue
            nxt = []
            for u in frontiers[c]:
                for v in g.indices[g.indptr[u]:g.indptr[u + 1]]:
                    if assignment[v] == -1 and sizes[c] < target:
                        assignment[v] = c
                        sizes[c] += 1
                        nxt.append(int(v))
            frontiers[c] = nxt
            active = active or bool(nxt)
    # orphans (disconnected): round-robin to the emptiest clusters
    for u in np.nonzero(assignment == -1)[0]:
        c = int(np.argmin(sizes))
        assignment[u] = c
        sizes[c] += 1
    return assignment


def _chunk_clusters(g: Graph, k: int) -> np.ndarray:
    """Contiguous node-balanced split: cluster of node i is ``i * k // N``.

    O(N), locality-preserving for graphs whose node order is meaningful
    (CSR builders emit destination-sorted ids) — the partitioner that makes
    million-node graphs tractable where the BFS grower's Python frontier
    loop is not."""
    n = max(g.n_nodes, 1)
    return (np.arange(g.n_nodes, dtype=np.int64) * k // n).astype(np.int32)


def _edge_clusters(g: Graph, k: int) -> np.ndarray:
    """Contiguous *edge*-balanced split: each cluster owns ~E/k edges.

    On power-law graphs this deliberately skews the node counts (a chunk of
    hubs is short, a chunk of leaves is long) — balanced per-device compute,
    unbalanced per-device rows, which the dense ``[K, n_max, S]`` padding
    amplifies."""
    deg = np.diff(g.indptr).astype(np.int64) + 1     # +1 keeps isolated
    #                                                  nodes spreading
    before = np.cumsum(deg) - deg                    # edge mass before node i
    total = max(int(deg.sum()), 1)
    return np.minimum(before * k // total, k - 1).astype(np.int32)


PARTITION_METHODS = ("bfs", "chunk", "edge")


def _sample_edge_mask(g: Graph, sample: int | None,
                      self_loops: bool = True) -> np.ndarray:
    """Boolean [E] mask of the edges the padded-sample runtime reads.

    ``build_local_subgraphs``/``pad_neighbors`` truncate each node to its
    first ``sample - 1`` neighbors (one slot is the self loop); halo and
    comm tables built from *all* edges would ship rows the kernels never
    touch. ``sample=None`` keeps every edge."""
    if sample is None:
        return np.ones(g.n_edges, bool)
    cap = sample - 1 if self_loops else sample
    deg = np.diff(g.indptr)
    pos = np.arange(g.n_edges) - np.repeat(g.indptr[:-1], deg)
    return pos < cap


def partition(g: Graph, n_clusters: int, seed: int = 0,
              sample: int | None = None,
              self_loops: bool = True,
              method: str = "bfs") -> Partition:
    """Split into ``n_clusters`` clusters and derive all exchange tables.

    ``sample`` (optional) prunes the halo/comm tables to the edges the
    padded-sample runtime actually reads, so tabulated e_ij equals the rows
    the alltoall exchange measurably ships (``plan_execution`` passes its
    sample through here). ``method`` selects the assignment heuristic:
    ``bfs`` (quality default), ``chunk`` (O(N) node-balanced contiguous) or
    ``edge`` (O(N) edge-balanced contiguous — skewed node counts on
    power-law graphs)."""
    if method not in PARTITION_METHODS:
        raise ValueError(f"unknown partition method {method!r}; "
                         f"choose from {PARTITION_METHODS}")
    if method == "chunk":
        assignment = _chunk_clusters(g, n_clusters)
    elif method == "edge":
        assignment = _edge_clusters(g, n_clusters)
    else:
        assignment = _bfs_clusters(g, n_clusters, seed)
    return _from_assignment(g, assignment, n_clusters, sample=sample,
                            self_loops=self_loops)


@dataclasses.dataclass
class LocalSubgraph:
    """Per-device padded subgraph in device-local index space.

    Feature table layout per device: rows [0, n_max) are owned nodes,
    rows [n_max, n_max + h_max) are halo (received) nodes. Neighbor indices
    point into this concatenated table.
    """
    neighbors: np.ndarray   # [K, n_max, S] int32 local-space indices
    weights: np.ndarray     # [K, n_max, S] float32 (0 = padding)
    node_mask: np.ndarray   # [K, n_max] bool


def _owner_slots(part: Partition) -> np.ndarray:
    """[N] local slot of each node in its owning cluster's table.

    Members are stored in ascending global-id order (``np.nonzero``), so a
    stable argsort of the assignment reproduces every cluster's row order
    without a per-cluster scan."""
    a = part.assignment
    order = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=part.n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(len(a), np.int64)
    slot[order] = np.arange(len(a)) - np.repeat(starts, counts)
    return slot


def _local_tables(g: Graph, part: Partition, cluster_ids, n_rows: int,
                  s_cap: int, halo_base: int,
                  self_loops: bool = True):
    """Vectorized padded neighbor/weight tables for the given clusters.

    Rows are the clusters' owned nodes (ascending global id), columns the
    first ``s_cap - 1`` CSR neighbors plus the self loop; neighbor indices
    point into the device-local table (owned rows [0, n_rows), halo rows
    [halo_base, halo_base + h)). The dense layout passes
    ``n_rows = n_max`` and ``s_cap = sample``."""
    cluster_ids = np.asarray(cluster_ids, np.int64)
    nbr = np.zeros((len(cluster_ids), n_rows, s_cap), np.int32)
    wts = np.zeros((len(cluster_ids), n_rows, s_cap), np.float32)
    cap = s_cap - 1 if self_loops else s_cap
    # self-loop weight honors the graph's normalization (gcn_normalize sets
    # A_hat's diagonal 1/(d_i+1); unnormalized graphs keep A + I's 1.0)
    sl = (g.self_loop if g.self_loop is not None
          else np.ones(g.n_nodes, np.float32))
    slot = _owner_slots(part)
    assignment = part.assignment
    h_counts = (part.halo_src >= 0).sum(axis=1)
    for out_i, c in enumerate(cluster_ids):
        rows = part.local_nodes[c][part.local_mask[c]]
        m = len(rows)
        if m == 0:
            continue
        deg = (g.indptr[rows + 1] - g.indptr[rows]).astype(np.int64)
        take = np.minimum(deg, cap)
        if cap > 0 and g.indices.size:  # edgeless graphs: self-loops only
            e_idx = g.indptr[rows][:, None] + np.arange(cap)[None, :]
            valid = np.arange(cap)[None, :] < take[:, None]
            e_idx = np.where(valid, e_idx, 0)
            v = g.indices[e_idx]
            w = (g.edge_weight[e_idx] if g.edge_weight is not None
                 else np.ones_like(e_idx, np.float32))
            # halo_nodes are unique-sorted, so searchsorted recovers the
            # halo row of every sample-reachable remote neighbor
            hn = part.halo_nodes[c][:h_counts[c]]
            remote = assignment[v] != c
            loc = np.where(remote,
                           halo_base + np.searchsorted(hn, v),
                           slot[v])
            nbr[out_i, :m, :cap] = np.where(valid, loc, 0)
            wts[out_i, :m, :cap] = np.where(valid, w, 0.0)
        if self_loops:
            nbr[out_i, np.arange(m), take] = np.arange(m)
            wts[out_i, np.arange(m), take] = sl[rows]
    return nbr, wts


def build_local_subgraphs(g: Graph, part: Partition, sample: int,
                          self_loops: bool = True) -> LocalSubgraph:
    if part.sample is not None and sample > part.sample:
        raise ValueError(
            f"subgraph sample {sample} exceeds the sample {part.sample} the "
            f"partition's halo tables were pruned to — neighbors past the "
            f"pruning cut have no halo row; rebuild the partition with "
            f"sample >= {sample}")
    nbr, wts = _local_tables(g, part, np.arange(part.n_clusters),
                             part.n_max, sample, part.n_max,
                             self_loops=self_loops)
    return LocalSubgraph(nbr, wts, part.local_mask)


def gather_features(g: Graph, part: Partition) -> np.ndarray:
    """[K, n_max, F] owned-node features per device (pad rows zero)."""
    k, n_max = part.n_clusters, part.n_max
    f = g.feature_len
    out = np.zeros((k, n_max, f), np.float32)
    for c in range(k):
        m = part.local_mask[c]
        out[c, m] = g.features[part.local_nodes[c][m]]
    return out


_MIN_CAP = 8          # smallest bucket capacity (bounds shape churn when
#                       streaming rebuilds nudge tiny clusters around)


def _pow2ceil(n: int, floor: int = 1) -> int:
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class BucketedPartition:
    """Capacity-bucketed ragged layout over a dense :class:`Partition`.

    Dense plans pad every cluster to the global ``n_max``/``h_max``/``S`` —
    one hub cluster inflates every device's tensors. Here clusters are
    grouped into power-of-two *capacity buckets*: all clusters in bucket b
    share ``n_caps[b]`` owned rows, ``h_caps[b]`` halo rows and a neighbor
    width ``s_caps[b]``, so each device pays for its bucket's capacity, not
    the hub's. Power-of-two caps keep tensor shapes stable across
    rebuilds. The wrapped dense ``part`` (assignment, halo and comm
    tables) stays the single source of truth for traffic accounting; only
    the padded runtime tensors go ragged.
    """
    part: Partition
    clusters: tuple               # per-bucket int32 cluster ids (ascending)
    n_caps: tuple                 # per-bucket owned-row capacity (pow2)
    h_caps: tuple                 # per-bucket halo-row capacity (pow2)
    s_caps: tuple                 # per-bucket neighbor width (<= sample)
    bucket_of: np.ndarray         # [K] bucket index of each cluster
    index_in: np.ndarray          # [K] row of each cluster inside its bucket

    @property
    def n_buckets(self) -> int:
        return len(self.clusters)

    def real_rows(self) -> int:
        return int(self.part.local_mask.sum())

    def padded_rows(self) -> int:
        return sum(len(cl) * cap
                   for cl, cap in zip(self.clusters, self.n_caps))

    def dense_padded_rows(self) -> int:
        return self.part.n_clusters * self.part.n_max

    def padding_ratio(self) -> float:
        """Padded rows / real rows of the bucketed layout (>= 1)."""
        return self.padded_rows() / max(self.real_rows(), 1)

    def dense_padding_ratio(self) -> float:
        """Padded rows / real rows the dense layout would pay."""
        return self.dense_padded_rows() / max(self.real_rows(), 1)

    def covers(self) -> bool:
        """Every cluster's real rows/halos/neighbors fit its bucket's caps."""
        sizes = self.part.local_mask.sum(axis=1)
        halos = (self.part.halo_src >= 0).sum(axis=1)
        for b, cl in enumerate(self.clusters):
            if len(cl) == 0:
                continue
            if int(sizes[cl].max()) > self.n_caps[b]:
                return False
            if int(halos[cl].max()) > self.h_caps[b]:
                return False
        return True


def bucket_partition(part: Partition, g: Graph | None = None,
                     sample: int | None = None, max_buckets: int = 0,
                     like: "BucketedPartition | None" = None,
                     self_loops: bool = True) -> BucketedPartition:
    """Group a dense partition's clusters into power-of-two capacity buckets.

    ``n_caps`` is the pow2 ceiling of each cluster's size (floor
    ``_MIN_CAP``); ``h_caps`` the pow2 ceiling of the largest halo count in
    the bucket; ``s_caps`` trims the neighbor width to the largest *used*
    slot count in the bucket (needs ``g`` + ``sample``; falls back to
    ``sample``). ``max_buckets > 0`` merges the smallest-capacity buckets
    upward until at most that many remain. ``like=`` reuses an existing
    bucketing's grouping and never shrinks its caps, so rebuilds keep
    tensor shapes stable (same assignment => same groups)."""
    sample = sample if sample is not None else part.sample
    sizes = part.local_mask.sum(axis=1)
    hcounts = (part.halo_src >= 0).sum(axis=1)
    if like is not None:
        groups = [np.asarray(cl, np.int64) for cl in like.clusters]
        n_caps = [max(c, _pow2ceil(int(sizes[cl].max(initial=0)), _MIN_CAP))
                  for c, cl in zip(like.n_caps, groups)]
    else:
        caps = np.array([_pow2ceil(int(s), _MIN_CAP) for s in sizes])
        uniq = sorted(set(caps.tolist()))
        groups = [np.nonzero(caps == u)[0].astype(np.int64) for u in uniq]
        n_caps = list(uniq)
        while max_buckets > 0 and len(groups) > max_buckets:
            groups[1] = np.sort(np.concatenate([groups[0], groups[1]]))
            n_caps[1] = max(n_caps[0], n_caps[1])
            groups, n_caps = groups[1:], n_caps[1:]
    h_caps, s_caps = [], []
    deg = np.diff(g.indptr) if g is not None else None
    for b, cl in enumerate(groups):
        hc = _pow2ceil(int(hcounts[cl].max(initial=0)), 1)
        sc = int(sample) if sample is not None else 1
        if deg is not None and sample is not None and len(cl):
            cap = sample - 1 if self_loops else sample
            rows = np.concatenate(
                [part.local_nodes[c][part.local_mask[c]] for c in cl])
            used = int(np.minimum(deg[rows], cap).max(initial=0))
            used += 1 if self_loops else 0
            sc = min(int(sample), _pow2ceil(max(used, 1)))
        if like is not None:
            hc = max(hc, like.h_caps[b])
            sc = max(sc, like.s_caps[b])
        h_caps.append(hc)
        s_caps.append(sc)
    bucket_of = np.zeros(part.n_clusters, np.int32)
    index_in = np.zeros(part.n_clusters, np.int32)
    for b, cl in enumerate(groups):
        bucket_of[cl] = b
        index_in[cl] = np.arange(len(cl))
    return BucketedPartition(part, tuple(groups),
                             tuple(int(c) for c in n_caps), tuple(h_caps),
                             tuple(s_caps), bucket_of, index_in)


def build_bucketed_subgraphs(g: Graph, bpart: BucketedPartition,
                             self_loops: bool = True):
    """Per-bucket padded neighbor/weight tables.

    Returns (neighbors, weights): tuples of per-bucket arrays
    ``[K_b, n_caps[b], s_caps[b]]`` in the same device-local index
    convention as :class:`LocalSubgraph` — owned rows first, halo rows at
    ``n_caps[b] + h``. Trailing neighbor slots past ``s_caps[b]`` carry
    weight zero in the dense layout, and the layers sum the S axis in slot
    order, so dropping them leaves every bit of the result as it is."""
    nbrs, wtss = [], []
    for b, cl in enumerate(bpart.clusters):
        nbr, wts = _local_tables(g, bpart.part, cl, bpart.n_caps[b],
                                 bpart.s_caps[b], bpart.n_caps[b],
                                 self_loops=self_loops)
        nbrs.append(nbr)
        wtss.append(wts)
    return tuple(nbrs), tuple(wtss)


def gather_bucketed_features(g: Graph, bpart: BucketedPartition):
    """Tuple of per-bucket ``[K_b, n_caps[b], F]`` owned-feature tables."""
    part = bpart.part
    out = []
    for b, cl in enumerate(bpart.clusters):
        f = np.zeros((len(cl), bpart.n_caps[b], g.feature_len), np.float32)
        for j, c in enumerate(cl):
            m = part.local_mask[c]
            f[j, :int(m.sum())] = g.features[part.local_nodes[c][m]]
        out.append(f)
    return tuple(out)


@dataclasses.dataclass
class HierPartition:
    """Two-tier semi-decentralized partition (the paper's §5 hierarchy).

    The graph is split into ``n_heads`` *regions*, each fronted by a cluster
    head (an infrastructure edge server). Every region's nodes are spread
    over ``spokes_per_region`` member edge devices (spokes) that hold the raw
    features. Tier 0 is the intra-region spoke->head feature upload; tier 1
    is the head<->head boundary halo exchange over ``region``'s tables.
    """
    region: Partition             # tier-1 partition over the R regions
    n_heads: int
    spokes_per_region: int
    spoke_nodes: np.ndarray       # [R, P, m_max] int32 global ids (pad: -1)
    spoke_mask: np.ndarray        # [R, P, m_max] bool
    gather_spoke: np.ndarray      # [R, n_max] spoke owning each region row
    gather_slot: np.ndarray       # [R, n_max] slot in that spoke's table

    @property
    def m_max(self) -> int:
        return self.spoke_nodes.shape[2]


def hier_partition(g: Graph, n_heads: int, nodes_per_region: int = 4,
                   sample: int | None = None, seed: int = 0) -> HierPartition:
    """Region-level partition (cluster heads) nested over member clusters.

    ``nodes_per_region`` is the number of member edge devices (spokes) under
    each head; a region's owned nodes are split into that many balanced
    contiguous spoke tables. ``sample`` prunes the tier-1 halo/comm tables
    exactly as in ``partition``.
    """
    region = partition(g, n_heads, seed=seed, sample=sample)
    p = max(int(nodes_per_region), 1)
    n_max = region.n_max
    spoke_id = np.zeros((n_heads, n_max), np.int32)
    sizes = np.zeros((n_heads, p), np.int64)
    for r in range(n_heads):
        m = int(region.local_mask[r].sum())
        for i in range(m):
            spoke_id[r, i] = i * p // max(m, 1)
        np.add.at(sizes[r], spoke_id[r, :m], 1)
    m_max = max(int(sizes.max()), 1)
    spoke_nodes = np.full((n_heads, p, m_max), -1, np.int32)
    spoke_mask = np.zeros((n_heads, p, m_max), bool)
    gather_spoke = np.zeros((n_heads, n_max), np.int32)
    gather_slot = np.zeros((n_heads, n_max), np.int32)
    fill = np.zeros((n_heads, p), np.int64)
    for r in range(n_heads):
        m = int(region.local_mask[r].sum())
        for i in range(m):
            s = int(spoke_id[r, i])
            t = int(fill[r, s])
            fill[r, s] += 1
            spoke_nodes[r, s, t] = region.local_nodes[r, i]
            spoke_mask[r, s, t] = True
            gather_spoke[r, i] = s
            gather_slot[r, i] = t
    return HierPartition(region, n_heads, p, spoke_nodes, spoke_mask,
                         gather_spoke, gather_slot)


def gather_spoke_features(g: Graph, hier: HierPartition) -> np.ndarray:
    """[R, P, m_max, F] spoke-resident node features (pad rows zero)."""
    r, p, m_max = hier.spoke_nodes.shape
    out = np.zeros((r, p, m_max, g.feature_len), np.float32)
    m = hier.spoke_mask
    out[m] = g.features[hier.spoke_nodes[m]]
    return out


def halo_exchange_tables(part: Partition):
    """Precomputed gather plan for the halo exchange.

    Returns (src_cluster [K, h_max] int32, src_slot [K, h_max] int32,
    halo_mask [K, h_max] bool): device c's halo row h is the feature at
    (src_cluster[c, h], src_slot[c, h]) — an all-gather + gather realizes the
    exchange (see repro.distributed.halo).
    """
    k, h_max = part.n_clusters, part.h_max
    slot = np.zeros((k, h_max), np.int32)
    owner_slot = _owner_slots(part)
    for c in range(k):
        valid = part.halo_src[c] >= 0
        slot[c, valid] = owner_slot[part.halo_nodes[c][valid]]
    return part.halo_src, slot, part.halo_src >= 0



@dataclasses.dataclass
class ExecutionPlan:
    """One GNN, three execution settings, one switchable kernel backend.

      * ``centralized``   — one device owns the full graph (paper Fig. 4a).
      * ``decentralized`` — one cluster per device, halo exchange per layer
        (Fig. 4b): one process a cluster on a mesh (SPMD), or emulated
        over a leading cluster axis on one device.
      * ``semi``          — the two-tier hierarchy (paper §5): cluster heads
        each centralized over a region; spokes upload features to their
        head (tier 0), heads exchange boundary halos per layer (tier 1).

    ``backend`` is ``jnp``, ``pallas`` or ``fused`` (see the module
    docstring). Build with ``plan_execution``; ``make_forward`` gives the
    runnable forward on a device and ``scatter`` maps its device-local
    output back to global node order.
    """
    setting: str
    backend: str
    sample: int
    n_clusters: int
    graph: Graph
    part: Partition | None          # None for centralized; the region-level
    #                                 (tier-1) partition for semi
    sub: LocalSubgraph | None
    feats: np.ndarray               # [K, n_max, F] (centralized: [1, N, F];
    #                                 semi: [R, P, m_max, F] spoke tables;
    #                                 bucketed non-semi: tuple of per-bucket
    #                                 [K_b, n_cap, F] tables)
    neighbors: np.ndarray           # [K, n_max, S] device-local sample
    #                                 (bucketed: tuple of [K_b, n_cap, s_cap])
    weights: np.ndarray             # [K, n_max, S] (bucketed: tuple)
    hier: HierPartition | None = None   # set for setting == "semi"
    mapping: object | None = None   # cached CompiledMapping (mapper)
    tuned: object | None = None     # cached TunedKernels (tuning)
    bucketed: BucketedPartition | None = None   # the ragged layout

    def gnn_config(self, cfg):
        """Rebind a GNNConfig to this plan's backend/sample (and its tuned
        kernel configs, when ``tune_kernels`` has run)."""
        tuned = self.tuned if self.tuned is not None else cfg.tuned
        return dataclasses.replace(cfg, backend=self.backend,
                                   sample=self.sample, tuned=tuned)

    def tune_kernels(self, cfg, cache=None, device="cuda", **tune_kw):
        """Tune the Hopper kernel launches this plan's forward makes
        (``repro_torch.tuning``) and cache the winners on ``self.tuned``
        so that ``make_forward`` picks them up. ``cache`` is a
        ``TuneCache`` (or a path to load one from); candidates are the
        kernels' own launch choices, roofline-pruned and timed on
        ``device`` with CUDA events, and bit-identical to the default
        launch. Returns the ``TunedKernels`` bundle (empty on ``jnp``)."""
        from ..tuning import TuneCache, tune_plan
        if isinstance(cache, str):
            cache = TuneCache.load(cache)
        self.tuned = tune_plan(self, self.gnn_config(cfg), cache=cache,
                               device=device, **tune_kw)
        return self.tuned

    def make_forward(self, cfg, mesh=None, mode: str = "alltoall",
                     overlap: str = "overlap", device="cuda"):
        """Runnable forward for this plan on ``device``:
        ``fn(params) -> [K, n_max, out]`` (a tensor on ``device``).

        The plan's host tables are copied to the device once, here.
        ``mesh`` (a ``launch.mesh.Mesh``) of exactly ``n_clusters`` ranks
        selects the SPMD runtime for a dense decentralized or semi plan:
        this process copies only its own cluster's (region's) rows to
        ``mesh.device``, exchanges halos by collectives and returns the
        full output on every rank; ``device`` must name the mesh's.
        Otherwise the emulated exchange runs the same dataflow on
        ``device``. ``mode`` picks the halo-exchange strategy
        (``allgather`` or ``alltoall``) of the decentralized exchange and
        of semi's tier-1 head<->head exchange; centralized has none.

        Bucketed plans return a *tuple* of per-bucket ``[K_b, n_cap, out]``
        tensors (``scatter`` accepts it) and run the double-buffered
        exchange of ``halo.make_emulated_bucketed_forward``:
        ``overlap="overlap"`` issues every bucket's halo gather of a layer,
        on a side CUDA stream, before any bucket's layer step; ``"serial"``
        interleaves gather and step on the current stream. Both give the
        same values.

        The returned callable carries telemetry instrumentation (a
        ``plan.forward`` span closed by a device sync, with exact wire-byte
        accounting from ``measured_traffic``); with telemetry disabled (the
        default) the wrapper is a single flag check."""
        from ..telemetry import instrument_forward
        fwd = self._build_forward(cfg, mesh=mesh, mode=mode,
                                  overlap=overlap, device=device)
        return instrument_forward(self, self.gnn_config(cfg), mode, fwd)

    def _spmd(self, mesh) -> bool:
        """Whether ``make_forward`` takes the SPMD runtime on ``mesh``: a
        mesh of ``n_clusters`` ranks and a dense decentralized or semi
        plan, as the reference decides."""
        return (mesh is not None and mesh.size == self.n_clusters
                and self.setting != "centralized" and self.bucketed is None)

    def _build_forward(self, cfg, mesh=None, mode: str = "alltoall",
                       overlap: str = "overlap", device="cuda"):
        import torch

        from ..distributed import halo
        from .._device import resolve_device
        from .gnn import forward as gnn_forward
        cfg = self.gnn_config(cfg)
        if self._spmd(mesh):
            from ..launch.mesh import mesh_device
            dev, r = mesh_device(mesh, device), mesh.rank
            feats = torch.from_numpy(self.feats[r]).to(dev)
            nbr = torch.from_numpy(self.neighbors[r]).to(dev)
            wts = torch.from_numpy(self.weights[r]).to(dev)
            if self.setting == "semi":
                fn = halo.make_semi_forward(
                    mesh, cfg, halo.build_two_tier_plan(self.hier),
                    mode=mode, axis=mesh.axis)
            else:
                fn = halo.make_decentralized_forward(
                    mesh, cfg, halo.build_halo_plan(self.part),
                    self.part.n_max, mode=mode, axis=mesh.axis)
            return lambda params: fn(params, feats, nbr, wts)
        dev = resolve_device(device)
        if self.bucketed is not None:
            bplan = halo.build_bucketed_halo_plan(self.bucketed)
            nbrs = tuple(torch.from_numpy(a).to(dev) for a in self.neighbors)
            wtss = tuple(torch.from_numpy(a).to(dev) for a in self.weights)
            if self.setting == "semi":
                fn = halo.make_emulated_bucketed_semi_forward(
                    cfg, bplan, self.hier, self.bucketed, mode=mode,
                    overlap=overlap, device=dev)
                spoke = torch.from_numpy(self.feats).to(dev)
                return lambda params: fn(params, spoke, nbrs, wtss)
            fn = halo.make_emulated_bucketed_forward(
                cfg, bplan, mode=mode, overlap=overlap, device=dev)
            feats = tuple(torch.from_numpy(f).to(dev) for f in self.feats)
            return lambda params: fn(params, feats, nbrs, wtss)
        feats = torch.from_numpy(self.feats).to(dev)
        nbr = torch.from_numpy(self.neighbors).to(dev)
        wts = torch.from_numpy(self.weights).to(dev)
        if self.setting == "centralized":
            def forward(params):
                return gnn_forward(params, feats[0], nbr[0], wts[0],
                                   cfg)[None]
            return forward
        if self.setting == "semi":
            fn = halo.make_emulated_semi_forward(
                cfg, halo.build_two_tier_plan(self.hier), mode=mode,
                device=dev)
        else:
            fn = halo.make_emulated_forward(
                cfg, halo.build_halo_plan(self.part), mode=mode, device=dev)
        return lambda params: fn(params, feats, nbr, wts)

    def scatter(self, out) -> np.ndarray:
        """Map the forward's per-cluster output [K, n_max, D] (a tensor on
        any device) to a numpy array in global node order. Bucketed plans
        pass the forward's tuple of per-bucket ``[K_b, n_cap, D]``
        tensors."""
        if self.bucketed is not None and isinstance(out, (list, tuple)):
            parts = [o.detach().cpu().numpy() for o in out]
            full = np.zeros((self.graph.n_nodes, parts[0].shape[-1]),
                            parts[0].dtype)
            sizes = self.part.local_mask.sum(axis=1)
            for b, cl in enumerate(self.bucketed.clusters):
                for j, c in enumerate(cl):
                    m = int(sizes[c])
                    full[self.part.local_nodes[c, :m]] = parts[b][j, :m]
            return full
        out = out.detach().cpu().numpy()
        if self.setting == "centralized":
            return out[0]
        full = np.zeros((self.graph.n_nodes, out.shape[-1]), out.dtype)
        for c in range(self.n_clusters):
            m = self.part.local_mask[c]
            full[self.part.local_nodes[c][m]] = out[c][m]
        return full

    def layout_stats(self, cfg=None) -> dict:
        """Deterministic padded-layout accounting for this plan.

        ``padding_ratio`` is padded rows / real rows of the layout the plan
        actually runs; ``dense_*`` keys price the uniform dense layout for
        the same partition so the bucketing win is a ratio of two numbers
        from one partition. ``peak_device_bytes`` models the largest single
        device's live working set (feature table + halo rows + activation
        double-buffer + neighbor/weight tables at the widest layer dim of
        ``cfg``, float32/int32)."""
        f_max = int(max(cfg.dims)) if cfg is not None else max(
            int(self.graph.feature_len), 1)

        def _peak(n_rows: int, h_rows: int, s: int) -> int:
            return 4 * (2 * n_rows * f_max + h_rows * f_max
                        + 2 * n_rows * s)

        if self.part is None:                     # dense centralized
            rows = max(int(self.graph.n_nodes), 1)
            peak = _peak(rows, 0, self.sample)
            return {"layout": "dense", "real_rows": rows,
                    "padded_rows": rows, "padding_ratio": 1.0,
                    "dense_padded_rows": rows, "dense_padding_ratio": 1.0,
                    "peak_device_bytes": peak,
                    "dense_peak_device_bytes": peak}
        real = max(int(self.part.local_mask.sum()), 1)
        dense_rows = self.part.n_clusters * self.part.n_max
        dense_peak = _peak(self.part.n_max, self.part.h_max, self.sample)
        if self.bucketed is None:
            rows, peak, layout = dense_rows, dense_peak, "dense"
        else:
            bp = self.bucketed
            rows, layout = bp.padded_rows(), "bucketed"
            peak = max(_peak(bp.n_caps[b], bp.h_caps[b], bp.s_caps[b])
                       for b in range(bp.n_buckets))
        return {"layout": layout, "real_rows": real, "padded_rows": rows,
                "padding_ratio": rows / real,
                "dense_padded_rows": dense_rows,
                "dense_padding_ratio": dense_rows / real,
                "peak_device_bytes": peak,
                "dense_peak_device_bytes": dense_peak}

    def predicted_metrics(self, workload_scaled: bool = False,
                          mode: str = "calibrated", inventory=None,
                          layer_dims: tuple | None = None,
                          technology=None, calibration=None):
        """Cost-model (Eqs. 1-7) prediction for this plan's setting, on the
        paper's modeled devices.

        ``mode="derived"`` prices compute through the crossbar mapper
        instead of the Table-1 calibration (DESIGN.md §8); ``inventory`` /
        ``layer_dims`` / ``technology`` / ``calibration`` are forwarded
        to it (DESIGN.md §13)."""
        from . import costmodel
        return costmodel.predict(
            self.setting, self.graph.stats("plan"),
            workload_scaled=workload_scaled, n_clusters=self.n_clusters,
            sample=self.sample, mode=mode, inventory=inventory,
            layer_dims=layer_dims, technology=technology,
            calibration=calibration)

    def compile_mapping(self, cfg=None, hw=None, inventory=None,
                        technology=None, calibration=None):
        """Compile this plan's workload onto a crossbar inventory.

        ``cfg`` (a GNNConfig, optional) supplies the layer dims — without
        it the mapper prices the calibration workload (one
        ``feature_len -> 128`` layer). ``technology`` / ``calibration``
        re-anchor the per-pass primitives (DESIGN.md §13). The result is
        cached on ``self.mapping`` and returned (a
        ``repro_torch.mapper.CompiledMapping``: per-layer tilings, array
        allocation, pass schedule, derived latency/energy)."""
        from ..mapper.compile import compile_mapping
        dims = (cfg.dims if cfg is not None
                else (max(self.graph.feature_len, 1), 128))
        self.mapping = compile_mapping(
            dims, self.graph.stats("plan"), hw, inventory, self.setting,
            self.n_clusters, self.sample, technology=technology,
            calibration=calibration)
        return self.mapping

    def mapping_report(self, cfg=None, hw=None, inventory=None,
                       technology=None, calibration=None) -> str:
        """Human-readable report of the compiled hardware mapping (tile
        shapes, padding, duplication/serialization, pass schedule, derived
        latency/energy). Compiles on first use; recompiles when any
        argument is given."""
        if (self.mapping is None or cfg is not None or hw is not None
                or inventory is not None or technology is not None
                or calibration is not None):
            self.compile_mapping(cfg, hw=hw, inventory=inventory,
                                 technology=technology,
                                 calibration=calibration)
        return self.mapping.mapping_report()

    def measured_traffic(self, cfg=None, mode: str = "alltoall"):
        """Measured wire traffic of this plan's exchanges (bytes per device
        per layer, counted on the executed send/recv tables). ``cfg`` (a
        GNNConfig) supplies per-layer feature dims; without it a single
        input-dim layer is assumed. Returns a
        ``repro_torch.distributed.traffic.TrafficReport``."""
        from ..distributed.traffic import measure_execution
        return measure_execution(self, cfg=cfg, mode=mode)


def _parse_buckets(buckets) -> int | None:
    """Normalize the ``buckets`` knob: None => dense, 0 => unlimited
    buckets, N > 0 => at most N buckets."""
    if buckets in (None, 0, "off", "dense", False):
        return None
    if buckets in ("auto", -1, True):
        return 0
    n = int(buckets)
    if n <= 0:
        raise ValueError(f"buckets must be 'auto', 'off' or a positive "
                         f"count, got {buckets!r}")
    return n


def plan_execution(g: Graph, setting: str = "centralized",
                   backend: str = "jnp", sample: int = 16,
                   n_clusters: int | None = None,
                   seed: int = 0,
                   spokes_per_head: int = 4,
                   buckets=None,
                   partition_method: str = "bfs") -> ExecutionPlan:
    """Build the ExecutionPlan for one (setting, backend) combination.

    ``n_clusters`` defaults per setting: 1 (centralized), 8 (decentralized
    — one per edge device), 4 (semi — cluster heads, each fronting
    ``spokes_per_head`` member edge devices). Halo/comm tables are pruned
    to the ``sample``-reachable edges the kernels read.

    ``buckets`` selects the capacity-bucketed ragged layout:
    ``None``/``"off"`` keeps the uniform dense padding, ``"auto"`` buckets
    clusters by their natural pow2 capacities, an int N caps the bucket
    count at N (centralized with buckets runs one bucketed cluster).
    ``partition_method`` picks the cluster heuristic (``bfs``/``chunk``/
    ``edge`` — see ``partition``)."""
    if setting not in ("centralized", "decentralized", "semi"):
        raise ValueError(f"unknown setting {setting!r}")
    max_b = _parse_buckets(buckets)
    if setting == "centralized" and max_b is None:
        nbr, wts = g.neighbor_sample(sample)
        return ExecutionPlan(setting, backend, sample, 1, g, None, None,
                             g.features[None], nbr[None], wts[None])
    k = 1 if setting == "centralized" else (
        n_clusters or (8 if setting == "decentralized" else 4))
    # a cluster must own at least one node
    k = max(min(k, g.n_nodes), 1)
    if setting == "semi":
        hier = hier_partition(g, k, nodes_per_region=spokes_per_head,
                              sample=sample, seed=seed)
        feats = gather_spoke_features(g, hier)
        if max_b is not None:
            bp = bucket_partition(hier.region, g, sample, max_buckets=max_b)
            nbrs, wtss = build_bucketed_subgraphs(g, bp)
            return ExecutionPlan(setting, backend, sample, k, g,
                                 hier.region, None, feats, nbrs, wtss,
                                 hier=hier, bucketed=bp)
        sub = build_local_subgraphs(g, hier.region, sample)
        return ExecutionPlan(setting, backend, sample, k, g, hier.region,
                             sub, feats, sub.neighbors, sub.weights,
                             hier=hier)
    if setting == "centralized":
        part = _from_assignment(g, np.zeros(g.n_nodes, np.int32), 1,
                                sample=sample)
    else:
        part = partition(g, k, seed=seed, sample=sample,
                         method=partition_method)
    if max_b is not None:
        bp = bucket_partition(part, g, sample, max_buckets=max_b)
        nbrs, wtss = build_bucketed_subgraphs(g, bp)
        feats = gather_bucketed_features(g, bp)
        return ExecutionPlan(setting, backend, sample, k, g, part, None,
                             feats, nbrs, wtss, bucketed=bp)
    sub = build_local_subgraphs(g, part, sample)
    feats = gather_features(g, part)
    return ExecutionPlan(setting, backend, sample, k, g, part, sub,
                         feats, sub.neighbors, sub.weights)


def rebalance(g: Graph, part: Partition, latency: np.ndarray,
              frac: float = 0.25, seed: int = 0) -> Partition:
    """Straggler mitigation: shift load away from slow clusters.

    ``latency``: [K] observed (or cost-model-predicted) per-cluster step
    latency. Boundary nodes of clusters slower than the mean are handed to
    their fastest adjacent cluster (at most ``frac`` of the slow cluster's
    nodes move), then the partition tables are rebuilt. Deterministic in
    ``seed``: the decentralized setting re-balances its clusters when a
    node's latency spikes.
    """
    latency = np.asarray(latency, np.float64)
    k = part.n_clusters
    assignment = part.assignment.copy()
    mean = latency.mean()
    for c in np.argsort(-latency):
        if latency[c] <= mean * 1.05:
            break
        members = np.nonzero(assignment == c)[0]
        budget = max(int(len(members) * frac), 1)
        # boundary nodes: owned nodes with at least one out-of-cluster edge
        moved = 0
        for u in members:
            lo, hi = int(g.indptr[u]), int(g.indptr[u + 1])
            nbr_clusters = assignment[g.indices[lo:hi]]
            remote = nbr_clusters[nbr_clusters != c]
            if len(remote) == 0:
                continue
            # move to the fastest adjacent cluster that is below the mean
            cand = np.unique(remote)
            cand = cand[latency[cand] < mean]
            if len(cand) == 0:
                continue
            target = int(cand[np.argmin(latency[cand])])
            assignment[u] = target
            moved += 1
            if moved >= budget:
                break
    # rebuild partition tables from the adjusted assignment, keeping the
    # original tables' sample pruning
    return _from_assignment(g, assignment, k, sample=part.sample)


def _from_assignment(g: Graph, assignment: np.ndarray, k: int,
                     sample: int | None = None,
                     self_loops: bool = True) -> Partition:
    """Build full Partition tables from a given node->cluster assignment.

    Halo and comm tables are restricted to ``sample``-reachable edges (see
    ``_sample_edge_mask``); ``comm_volume[i, j]`` counts the *unique* remote
    rows i needs from j — the feature rows an alltoall exchange ships, so
    measured traffic and tabulated e_ij agree by construction."""
    members = [np.nonzero(assignment == c)[0].astype(np.int32)
               for c in range(k)]
    n_max = max(max(len(m) for m in members), 1)
    halos, comm = [], np.zeros((k, k), np.int64)
    used = _sample_edge_mask(g, sample, self_loops)
    dst_cluster = assignment[np.repeat(np.arange(g.n_nodes),
                                       np.diff(g.indptr))]
    src_cluster = assignment[g.indices]
    for c in range(k):
        mask = used & (dst_cluster == c) & (src_cluster != c)
        remote = np.unique(g.indices[mask])
        halos.append(remote.astype(np.int32))
        pairs, counts = np.unique(assignment[remote], return_counts=True)
        comm[c, pairs] = counts
    h_max = max(max((len(h) for h in halos), default=0), 1)
    local_nodes = np.full((k, n_max), -1, np.int32)
    local_mask = np.zeros((k, n_max), bool)
    halo_nodes = np.full((k, h_max), 0, np.int32)
    halo_src = np.full((k, h_max), -1, np.int32)
    for c in range(k):
        local_nodes[c, :len(members[c])] = members[c]
        local_mask[c, :len(members[c])] = True
        halo_nodes[c, :len(halos[c])] = halos[c]
        halo_src[c, :len(halos[c])] = assignment[halos[c]]
    return Partition(assignment, k, local_nodes, local_mask,
                     halo_nodes, halo_src, comm, sample=sample)
