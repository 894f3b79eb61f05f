"""Graph data pipeline: deterministic mini-batched node sampling.

The counterpart of ``repro.data.graphs``, a numpy host pipeline: the same
batches as the reference's for the same graph and seed.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph


def graph_batches(g: Graph, batch_nodes: int, sample: int, seed: int = 0):
    """Yields dicts of (node_ids, neighbors, weights, features, step)
    forever, deterministic in (seed, step)."""
    nbr, wts = g.neighbor_sample(sample)
    step = 0
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        ids = rng.choice(g.n_nodes, size=min(batch_nodes, g.n_nodes),
                         replace=False)
        yield {"node_ids": ids.astype(np.int32),
               "neighbors": nbr[ids],
               "weights": wts[ids],
               "features": g.features[ids] if g.features is not None else None,
               "step": step}
        step += 1
