"""CAM-backed k-nearest-neighbor graph construction.

The counterpart of ``repro.neighbors.knn``. The traversal core's search CAM
(``kernels.cam_match``) does one thing — associative equality match with a
per-query popcount — and that is what approximate nearest-neighbor
selection over LSH band signatures needs: load every node's tagged band
signatures (``signature.tag_bands``) into one flat CAM array, search each
query node's tagged bands against it, and the per-(query, node) match count
is the number of agreeing bands, the similarity score. Top-k over those
scores (self excluded, ties toward the smaller node id) gives the edges.

Two result-identical paths compute the scores, on the device:

  * ``mode="cam"``  — through ``kernels.cam_match.search`` (``backend=``
    picks the plain version or the hand-written kernel); the bitmap stays
    on the device and is folded there per band pair as int32. Query rows
    are chunked so that one launch's [Qc*B, N*B] bitmap stays within
    ``_BITMAP_BUDGET`` bytes.
  * ``mode="topk"`` — a direct signature compare reduced over bands, no
    CAM anywhere.

Band tags make cross-band CAM matches impossible and tagged entries are
non-negative, so the folded bitmap is exactly the per-band equality count;
selection runs through one ``torch.topk`` on a collision-free key, so the
graphs are identical on every path, and equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.graph import Graph
from ..kernels.cam_match import search as cam_search
from .signature import (DEFAULT_BAND_BITS, DEFAULT_BANDS, lsh_signatures,
                        tag_bands)

NEIGHBOR_MODES = ("topk", "cam")

# bound on the CAM match-bitmap footprint per query chunk: Qc*B * N*B int8
_BITMAP_BUDGET = 1 << 24


def band_match_counts(sig_e: np.ndarray, sig_q: np.ndarray,
                      mode: str = "topk", backend: str = "jnp",
                      band_bits: int = DEFAULT_BAND_BITS,
                      device="cuda") -> torch.Tensor:
    """[N, B] entry sigs x [Q, B] query sigs -> [Q, N] int32 band-match
    counts (agreeing bands per pair) on ``device``. ``mode="cam"`` routes
    through the traversal CAM; ``mode="topk"`` through a direct compare —
    identical outputs by construction."""
    if mode not in NEIGHBOR_MODES:
        raise ValueError(f"unknown neighbor mode {mode!r}; "
                         f"one of {NEIGHBOR_MODES}")
    dev = resolve_device(device)
    sig_e = np.asarray(sig_e, np.int32)
    sig_q = np.asarray(sig_q, np.int32)
    if sig_e.ndim != 2 or sig_q.ndim != 2 or sig_e.shape[1] != sig_q.shape[1]:
        raise ValueError(f"band mismatch: entries {sig_e.shape} vs queries "
                         f"{sig_q.shape}")
    n, b = sig_e.shape
    q = sig_q.shape[0]
    if mode == "topk":
        eq = (torch.from_numpy(sig_q).to(dev)[:, None, :]
              == torch.from_numpy(sig_e).to(dev)[None, :, :])
        return eq.sum(dim=2, dtype=torch.int32)
    entries = torch.from_numpy(tag_bands(sig_e, band_bits)).to(dev)
    tagged_q = torch.from_numpy(tag_bands(sig_q, band_bits)).to(dev)
    chunk = max(_BITMAP_BUDGET // max(n * b * b, 1), 1)
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    for lo in range(0, q, chunk):
        qc = min(chunk, q - lo)
        match, _ = cam_search(entries, tagged_q[lo * b:(lo + qc) * b],
                              backend=backend)
        # [Qc*B, N*B] bitmap -> per-(query, node) agreeing-band count: tags
        # zero every cross-band block, so the double band-sum is the
        # same-band equality count
        out[lo:lo + qc] = match.view(qc, b, n, b).sum(dim=(1, 3),
                                                      dtype=torch.int32)
    return out


def select_topk(counts, k: int, exclude_self: bool = False) -> tuple:
    """Deterministic top-k selection shared by every mode.

    counts: [Q, N] integer scores (a tensor, or an array-like taken to the
    CPU). Returns (neighbors [Q, k] int32, scores [Q, k] int32) on the
    device of ``counts``, ordered by (score desc, node id asc): the
    combined key is collision-free, so ``torch.topk``'s tie policy never
    shows and every path selects identically."""
    counts = torch.as_tensor(counts)
    q, n = counts.shape
    if not 1 <= k <= n - (1 if exclude_self else 0):
        raise ValueError(f"k={k} out of range for {n} candidate nodes"
                         f"{' (self excluded)' if exclude_self else ''}")
    if exclude_self and q != n:
        raise ValueError(f"exclude_self needs a square score matrix, "
                         f"got {tuple(counts.shape)}")
    key = counts.to(torch.int64, copy=True)
    if exclude_self:
        key.fill_diagonal_(-1)
    ids = torch.arange(n, dtype=torch.int64, device=counts.device)
    key.mul_(n).add_((n - 1 - ids)[None, :])
    int32_max = torch.iinfo(torch.int32).max
    if key.numel() and max(int(key.max()), -int(key.min())) >= int32_max:
        raise ValueError(f"combined selection key overflows int32 for "
                         f"{n} nodes at max score {int(counts.max())}")
    top = torch.topk(key.to(torch.int32), k, dim=1).values.to(torch.int64)
    nbr = (n - 1 - top % n).to(torch.int32)
    return nbr, (top // n).to(torch.int32)


def knn_graph(features, k: int = 8, n_bands: int = DEFAULT_BANDS,
              band_bits: int = DEFAULT_BAND_BITS, seed: int = 0,
              mode: str = "topk", backend: str = "jnp",
              min_bands: int = 1, device="cuda") -> Graph:
    """Build the feature-similarity ``Graph`` the runtimes serve (host
    CSR; the scores and the selection run on ``device``).

    Row ``i`` of the CSR holds node i's selected similar nodes as incoming
    sources, weighted by the agreeing-band fraction. Candidates matching
    fewer than ``min_bands`` bands are dropped, so degrees are at most —
    not exactly — ``k``. Every ``mode``/``backend`` gives the same
    graph."""
    dev = resolve_device(device)
    x = np.asarray(features, np.float32)
    sigs = lsh_signatures(x, n_bands=n_bands, band_bits=band_bits, seed=seed)
    counts = band_match_counts(sigs, sigs, mode=mode, backend=backend,
                               band_bits=band_bits, device=dev)
    nbr, score = select_topk(counts, k, exclude_self=True)
    del counts
    nbr, score = nbr.cpu().numpy(), score.cpu().numpy()
    keep = score >= max(min_bands, 1)
    degrees = keep.sum(axis=1)
    indptr = np.zeros(x.shape[0] + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    indices = nbr[keep].astype(np.int32)
    weights = (score[keep].astype(np.float32) / float(n_bands))
    return Graph(indptr, indices, weights, x)
