"""Plain PyTorch oracle for the aggregation core (IMA-GNN Fig. 2(a)-3).

The kernel-facing format is a padded neighbor sample: for each destination
node, ``sample`` slots of (source index, edge weight), weight 0 on padding.

    z[i] = sum_s  weight[i, s] * x[neighbors[i, s]]

The sum runs over ``s`` in slot order, one rounded multiply and one rounded
add per slot, which is what the CUDA kernel does; on the card the two agree
bit for bit.

The rows are gathered by ``index_select``, whose gradient (training's
``jnp`` backend) is an ``index_add_``: the gradient of ``x[idx]`` is an
``index_put_`` with accumulation, which on CUDA adds the rows of a
repeated index one after another, and every padding slot repeats row 0.
"""
from __future__ import annotations

import numpy as np
import torch


def csr_aggregate_ref(x: torch.Tensor, neighbors: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """x: [N, F] float; neighbors: [Nd, S] int in [0, N); weights: [Nd, S].

    Returns z: [Nd, F] float32, the weighted neighbor-feature reduction."""
    x = x.float()
    nbr = neighbors.long()
    wts = weights.float()
    z = torch.zeros((nbr.shape[0], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    for s in range(nbr.shape[1]):
        z = z + wts[:, s, None] * x.index_select(0, nbr[:, s])
    return z


def pad_neighbors(indptr, indices, edge_weights, sample: int,
                  *, self_loops: bool = False, self_loop_weight=None):
    """Host-side CSR -> padded neighbor sample conversion (numpy).

    Deterministic: takes the first ``sample`` neighbors of each node; pads
    with index 0 / weight 0. Returns (neighbors [N, S] int32, weights
    [N, S] float32). ``self_loop_weight`` (scalar or [N]) weights the self
    loop appended when ``self_loops=True`` (default 1.0)."""
    n = len(indptr) - 1
    nbr = np.zeros((n, sample), np.int32)
    wts = np.zeros((n, sample), np.float32)
    if self_loop_weight is None:
        self_loop_weight = np.ones(n, np.float32)
    else:
        self_loop_weight = np.broadcast_to(
            np.asarray(self_loop_weight, np.float32), (n,))
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        take = min(hi - lo, sample - (1 if self_loops else 0))
        nbr[i, :take] = indices[lo:lo + take]
        wts[i, :take] = (edge_weights[lo:lo + take]
                         if edge_weights is not None else 1.0)
        if self_loops:
            nbr[i, take] = i
            wts[i, take] = self_loop_weight[i]
    return nbr, wts
