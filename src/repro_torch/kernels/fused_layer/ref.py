"""Composed-path oracle for the fused GNN layer.

The fused kernels must match aggregation then the crossbar MVM run back to
back, with Z materialized in between:

    fused_layer_ref(x, nbr, wts, W, b) = act(agg(x, nbr, wts) @ W + b)
"""
from __future__ import annotations

import torch

from ..crossbar_mvm.ref import CrossbarNumerics, crossbar_matmul_signed_ref
from ..csr_aggregate.ref import csr_aggregate_ref


def fused_layer_ref(x: torch.Tensor, neighbors: torch.Tensor,
                    weights: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    cfg: CrossbarNumerics = CrossbarNumerics(ideal=True),
                    relu: bool = False) -> torch.Tensor:
    """One GNN layer through the composed two-stage path."""
    z = csr_aggregate_ref(x, neighbors, weights)
    if cfg.ideal:
        h = z @ w.float()
    else:
        h = crossbar_matmul_signed_ref(z, w, cfg)
    h = h + b.float()
    return torch.clamp_min(h, 0.0) if relu else h
