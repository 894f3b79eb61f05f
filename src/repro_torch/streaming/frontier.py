"""k-hop dirty-frontier tracking: which rows must each GNN layer recompute.

The counterpart of ``repro.streaming.frontier``. An L-layer GNN reads a
node's L-hop neighborhood, so a mutation at node v invalidates layer-l
activations of every node within l hops of v — the "dirty frontier". The
expansion runs over the *padded neighbor sample* the kernels actually read
(``Graph.neighbor_sample`` truncation included), so the masks are exact
w.r.t. the runtime, not the untruncated graph: an edge past the sample cut
never dirties anything.

Mask semantics (``FrontierMasks.masks[l]``, shape [L+1, N]):

  * ``masks[0]``  — rows of the *input* table h^0 that changed
    (feature-dirty nodes).
  * ``masks[l]``  — rows of h^l (the output of layer l) that must be
    recomputed: structure-dirty rows (their sample/weights changed), plus
    any row whose sample contains a ``masks[l-1]`` node.

The inner membership test — "does this row's sample contain a dirty
node?" — is an associative lookup, so it can run on the traversal core's
search CAM: load the dirty node ids as CAM entries and search the sample's
flattened column indices against them; a non-zero match count *is*
membership. ``expand_frontier(..., mode=)`` selects the path (``numpy``
expansion on the host, ``cam`` through the CAM search's plain PyTorch
version, ``cam-pallas`` through the hand-written CAM kernel
``cam_search``); all modes are bit-identical by construction — pad slots
are replaced by ``-1`` sentinels, which match nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.cam_match import search as _cam_search

FRONTIER_MODES = ("numpy", "cam", "cam-pallas")

# bound on the CAM match-bitmap footprint per chunk: Qc x n_dirty int8
_BITMAP_BUDGET = 1 << 24


@dataclasses.dataclass(frozen=True)
class FrontierMasks:
    """Per-layer recompute masks over global node ids."""
    masks: np.ndarray              # [L+1, N] bool; [0] = input dirt

    @property
    def n_layers(self) -> int:
        return self.masks.shape[0] - 1

    @property
    def n_nodes(self) -> int:
        return self.masks.shape[1]

    def layer(self, l: int) -> np.ndarray:
        """[N] bool — rows of h^l to recompute (l in [1, L])."""
        return self.masks[l]

    def recompute_fraction(self) -> float:
        """Recomputed rows across layers 1..L over L*N — the fraction of
        per-layer kernel work an incremental refresh performs."""
        l, n = self.n_layers, self.n_nodes
        if l == 0 or n == 0:
            return 0.0
        return float(self.masks[1:].sum()) / float(l * n)

    def counts(self) -> np.ndarray:
        """[L+1] dirty-row count per level."""
        return self.masks.sum(axis=1)


def _dirty_hop_cam(prev: np.ndarray, flat: torch.Tensor, shape: tuple,
                   backend: str) -> np.ndarray:
    """One hop of dirt propagation on the search CAM.

    ``prev``: [N] bool dirty mask at level l-1. ``flat``: the padded
    sample's column indices flattened to [N*S] int32 on the search's
    device, pad slots already replaced by ``-1`` (negative queries match
    nothing). One search per chunk of ``_BITMAP_BUDGET // n_dirty``
    queries, its counts read back to the host. Returns the [N] bool "any
    sampled input dirty" mask — identical to
    ``(prev[neighbors] & live).any(axis=1)``.
    """
    dirty_ids = np.nonzero(prev)[0].astype(np.int32)
    if dirty_ids.size == 0:
        return np.zeros(shape[0], bool)
    entries = torch.from_numpy(dirty_ids).to(flat.device)
    chunk = max(_BITMAP_BUDGET // max(dirty_ids.size, 1), 1)
    hit = np.empty(flat.numel(), bool)
    for lo in range(0, flat.numel(), chunk):
        qc = flat[lo:lo + chunk]
        _, counts = _cam_search(entries, qc, backend=backend)
        hit[lo:lo + qc.numel()] = (counts > 0).cpu().numpy()
    return hit.reshape(shape).any(axis=1)


def expand_frontier(neighbors: np.ndarray, weights: np.ndarray,
                    feature_dirty: np.ndarray, structure_dirty: np.ndarray,
                    n_layers: int, mode: str = "numpy",
                    device="cuda") -> FrontierMasks:
    """BFS the dirt L hops through the sampled adjacency.

    ``neighbors``/``weights``: [N, S] — the *global* padded sample of the
    mutated graph (self loops included), i.e. exactly what the centralized
    runtime reads and the same edge set the per-cluster subgraphs are built
    from. Padding slots carry weight 0 and contribute nothing, so dirt does
    not propagate through them. ``feature_dirty`` / ``structure_dirty``:
    [N] bool from ``apply_deltas``.

    ``mode`` picks the membership-test path (``FRONTIER_MODES``); every
    mode returns bit-identical masks. ``cam``/``cam-pallas`` run the
    per-hop membership test through ``kernels.cam_match.search`` (plain
    version / hand-written kernel) on ``device``, which defaults to CUDA
    and raises without it; ``numpy`` runs on the host and ignores it.
    """
    if mode not in FRONTIER_MODES:
        raise ValueError(f"unknown frontier mode {mode!r}; "
                         f"one of {FRONTIER_MODES}")
    neighbors = np.asarray(neighbors)
    n = neighbors.shape[0]
    live = np.asarray(weights) != 0        # [N, S] real (non-padding) slots
    feature_dirty = np.asarray(feature_dirty, bool).reshape(n)
    structure_dirty = np.asarray(structure_dirty, bool).reshape(n)
    masks = np.zeros((n_layers + 1, n), bool)
    masks[0] = feature_dirty
    if mode == "numpy":
        for l in range(1, n_layers + 1):
            # a row is dirty iff its own sample changed or any sampled
            # input was
            prev = masks[l - 1]
            masks[l] = structure_dirty | (prev[neighbors] & live).any(axis=1)
        return FrontierMasks(masks)
    dev = resolve_device(device)
    backend = "jnp" if mode == "cam" else "pallas"
    # pad slots -> -1 sentinel once: negative CAM queries match nothing
    flat = torch.from_numpy(np.where(live, neighbors, -1).astype(
        np.int32).reshape(-1)).to(dev)
    for l in range(1, n_layers + 1):
        hop = _dirty_hop_cam(masks[l - 1], flat, neighbors.shape, backend)
        masks[l] = structure_dirty | hop
    return FrontierMasks(masks)
