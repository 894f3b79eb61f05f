"""Feature-similarity workloads: the non-taxi scenarios the CAM opens.

A copy of ``repro.neighbors.scenarios``; the features are drawn with numpy
exactly as the reference draws them.

The taxi/Table-2 graphs arrive with explicit edges; recommendation and
stream-anomaly workloads arrive as bare feature vectors and the *graph is
built* by nearest-neighbor search — the step ``knn.knn_graph`` runs on the
CAM. Two ``dataset_like``-style synthetic generators, deterministic in
(name, seed):

  * ``recsys``  — users drawn around ``n_topics`` latent taste centroids
    (mixture of Gaussians): the k-NN graph's edges connect same-taste
    users, the structure collaborative-filtering GNNs aggregate over.
  * ``anomaly`` — a stream of mostly-nominal readings plus a small
    fraction of far-outlier rows: nominal nodes form a dense mutual k-NN
    core while anomalies attach by weak (few-band) edges — the structural
    signal a GNN anomaly scorer reads.

``scenario_graph`` returns the served ``Graph`` (features attached);
``scenario_features`` exposes the raw table plus ground-truth labels
(topic id / anomaly flag) for model-quality experiments.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph
from .knn import knn_graph

SCENARIOS = ("recsys", "anomaly")


def scenario_features(name: str, n_nodes: int = 512, feature_len: int = 32,
                      seed: int = 0, n_topics: int = 8,
                      anomaly_frac: float = 0.05) -> tuple:
    """(features [N, F] float32, labels [N] int32) for one scenario.

    ``recsys`` labels are topic ids; ``anomaly`` labels are 0 (nominal) /
    1 (outlier). Unknown names raise ``ValueError`` naming the valid set —
    a typo must not silently substitute a wrong workload.
    """
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; valid names: "
                         f"{sorted(SCENARIOS)}")
    if n_nodes < 2 or feature_len < 1:
        raise ValueError(f"need n_nodes >= 2 and feature_len >= 1, got "
                         f"({n_nodes}, {feature_len})")
    rng = np.random.default_rng(seed)
    if name == "recsys":
        topics = rng.integers(0, max(n_topics, 1), size=n_nodes)
        centroids = rng.normal(size=(max(n_topics, 1), feature_len)) * 3.0
        x = centroids[topics] + rng.normal(size=(n_nodes, feature_len)) * 0.7
        return x.astype(np.float32), topics.astype(np.int32)
    base = rng.normal(size=feature_len) * 2.0
    x = base[None, :] + rng.normal(size=(n_nodes, feature_len)) * 0.5
    n_anom = max(int(n_nodes * anomaly_frac), 1)
    anom = rng.choice(n_nodes, size=n_anom, replace=False)
    x[anom] += rng.normal(size=(n_anom, feature_len)) * 6.0
    labels = np.zeros(n_nodes, np.int32)
    labels[anom] = 1
    return x.astype(np.float32), labels


def scenario_graph(name: str, n_nodes: int = 512, feature_len: int = 32,
                   k: int = 8, seed: int = 0, neighbor_mode: str = "topk",
                   backend: str = "jnp", device="cuda", **knn_kw) -> Graph:
    """Build one scenario's served feature-similarity ``Graph``.

    ``neighbor_mode``/``backend`` pick the scoring path exactly as
    ``knn.knn_graph`` does; every combination yields the identical graph
    (the fallback contract), so the choice is purely a hardware/pricing
    decision — the planner's ``neighbor_mode`` axis.
    """
    x, _ = scenario_features(name, n_nodes=n_nodes, feature_len=feature_len,
                             seed=seed)
    return knn_graph(x, k=k, seed=seed, mode=neighbor_mode,
                     backend=backend, device=device, **knn_kw)
