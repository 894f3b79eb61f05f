"""Plain PyTorch oracle for the traversal core's CAM search (IMA-GNN
Fig. 3(c)-(d)).

The counterpart of ``repro.kernels.cam_match.ref``. Search CAM: each query
(destination node id) is matched against the CSR column-index array;
matching rows activate. Scan CAM then resolves the source nodes via the
row-pointer array: a broadcast equality compare plus a popcount, and a
searchsorted over RP.
"""
from __future__ import annotations

import torch


def cam_search_ref(ci: torch.Tensor, queries: torch.Tensor):
    """ci: [E] int32 CSR column indices; queries: [Q] int32 node ids.

    Returns (match [Q, E] int8, counts [Q] int32): the match-line bitmap
    of the search CAM and the per-query activation count. Negative query
    ids match nothing: valid node ids are non-negative."""
    match = (ci[None, :] == queries[:, None]) & (queries >= 0)[:, None]
    return match.to(torch.int8), match.sum(dim=1, dtype=torch.int32)


def cam_scan_ref(rp: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Scan/compare: map flat edge positions to their source row via RP.

    rp: [N+1] int32 row pointers; positions: [P] int32 edge positions.
    Returns [P] int32 source node ids (the row whose [rp[r], rp[r+1])
    range contains the position)."""
    return (torch.searchsorted(rp, positions, right=True) - 1).to(
        torch.int32)
