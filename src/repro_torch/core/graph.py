"""Graph containers, CSR utilities, and the paper's dataset statistics.

A copy of ``repro.core.graph`` (host-side numpy), so that the port needs
nothing of the JAX package.

Two representations:
  * ``Graph`` — a concrete CSR graph (numpy host-side) with features; used by
    the GNN runtime, the examples, and the tests.
  * ``GraphStats`` — the Table-2 summary statistics (nodes / edges / feature
    length / average cluster size c_s); all the analytical cost model needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Key statistics of a graph workload (IMA-GNN Table 2)."""
    name: str
    n_nodes: int
    n_edges: int
    feature_len: int
    avg_cs: float          # average cluster size / neighbors per node


# IMA-GNN Table 2 — the four evaluation datasets, plus the §4.2 taxi graph
# (10 000 nodes, c_s = 10, 864-byte messages => 216 fp32 feature dims).
TABLE2_DATASETS = {
    "livejournal": GraphStats("livejournal", 4_847_571, 68_993_773, 1, 9),
    "collab":      GraphStats("collab",        372_475, 24_574_995, 496, 263),
    "cora":        GraphStats("cora",             2_708,      5_429, 1433, 4),
    "citeseer":    GraphStats("citeseer",         3_327,      4_732, 3703, 2),
}
TAXI_STATS = GraphStats("taxi", 10_000, 100_000, 216, 10)


@dataclasses.dataclass
class Graph:
    """A concrete CSR graph with node features (host-side numpy)."""
    indptr: np.ndarray            # [N+1] int64
    indices: np.ndarray           # [E]   int32
    edge_weight: np.ndarray | None  # [E] float32 (None => unweighted)
    features: np.ndarray | None     # [N, F] float32
    self_loop: np.ndarray | None = None  # [N] implicit self-loop weight
    #                                      (None => 1.0, i.e. plain A + I)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @property
    def feature_len(self) -> int:
        return 0 if self.features is None else self.features.shape[1]

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(self.n_nodes, 1)

    def stats(self, name: str = "graph") -> GraphStats:
        return GraphStats(name, self.n_nodes, self.n_edges,
                          self.feature_len, self.avg_degree)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def gcn_normalize(self) -> "Graph":
        """Symmetric GCN normalization ``A_hat = D^-1/2 (A + I) D^-1/2``:
        w_ij = 1/sqrt((d_i+1)(d_j+1)) on the stored edges, and the implicit
        self loop added by the aggregation layer carries A_hat's diagonal
        weight 1/(d_i+1) (recorded in ``self_loop``)."""
        deg = self.degrees().astype(np.float64) + 1.0
        src = self.indices
        dst = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        w = 1.0 / np.sqrt(deg[dst] * deg[src])
        return Graph(self.indptr, self.indices, w.astype(np.float32),
                     self.features, (1.0 / deg).astype(np.float32))

    def neighbor_sample(self, sample: int, self_loops: bool = True):
        """Padded fixed-size neighbor sample (paper Table-2 mapping)."""
        from ..kernels.csr_aggregate.ref import pad_neighbors
        return pad_neighbors(self.indptr, self.indices, self.edge_weight,
                             sample, self_loops=self_loops,
                             self_loop_weight=self.self_loop)


def random_graph(n_nodes: int, n_edges: int, feature_len: int,
                 seed: int = 0, weighted: bool = True) -> Graph:
    """Synthetic CSR graph with a skewed (power-law-ish) degree profile,
    matching the scale statistics of a requested dataset."""
    rng = np.random.default_rng(seed)
    # skewed destination distribution => realistic degree imbalance
    raw = rng.zipf(1.6, size=n_edges * 2) % n_nodes
    dst = raw[:n_edges].astype(np.int64)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    ew = (rng.random(n_edges).astype(np.float32) if weighted else None)
    feats = rng.normal(size=(n_nodes, feature_len)).astype(np.float32)
    return Graph(indptr, src, ew, feats)


def dataset_like(name: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """A synthetic graph with (optionally downscaled) Table-2 statistics.

    Valid names are the Table-2 datasets plus ``"taxi"`` (the §4.2 case
    study); anything else raises ``ValueError`` — a typo must not silently
    substitute a wrong-scale graph.
    """
    datasets = dict(TABLE2_DATASETS, taxi=TAXI_STATS)
    if name not in datasets:
        raise ValueError(f"unknown dataset {name!r}; valid names: "
                         f"{sorted(datasets)}")
    s = datasets[name]
    n = max(int(s.n_nodes * scale), 8)
    e = max(int(s.n_edges * scale), 16)
    return random_graph(n, e, s.feature_len, seed=seed)
