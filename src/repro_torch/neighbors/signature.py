"""Quantized LSH band signatures — the discrete keys the edge CAM matches.

A numpy copy of ``repro.neighbors.signature``: the hyperplane projection
stays on the host so that signatures are bit-identical to the reference's.

A CAM does exact associative lookup, so similarity search over continuous
feature vectors needs a discretization whose *collisions* encode
similarity. The classic construction is random-hyperplane LSH (sign-random
projections): project a feature vector onto ``band_bits`` random
hyperplanes and pack the sign bits into one integer — one *band
signature*. Two vectors agree on a band with probability
``(1 - theta/pi) ** band_bits`` (theta the angle between them), so the
number of agreeing bands out of ``n_bands`` independent bands is a
monotone similarity estimate — and counting agreeing bands is exactly what
the search CAM's match lines + popcount compute (``kernels.cam_match``).

Band signatures are deliberately small non-negative int32s so they can
live in the same CAM entry format as CSR column indices: valid signatures
occupy ``[0, 2**band_bits)`` and the band *tag* (``tag_bands``) offsets
band ``b`` into its own disjoint id range, so a single flat CAM array
holds every band of every node and cross-band matches are impossible by
construction — the one-array layout ``knn.band_match_counts`` searches.
"""
from __future__ import annotations

import numpy as np

DEFAULT_BANDS = 8
DEFAULT_BAND_BITS = 8

# band tags must keep tagged ids inside int32 (the CAM entry dtype)
_MAX_TAG_BITS = 30


def lsh_signatures(features, n_bands: int = DEFAULT_BANDS,
                   band_bits: int = DEFAULT_BAND_BITS,
                   seed: int = 0) -> np.ndarray:
    """[N, F] float features -> [N, n_bands] int32 band signatures.

    Deterministic in (seed, n_bands, band_bits, F): the hyperplane bank is
    drawn once from ``default_rng(seed)``, so signatures — and therefore
    the k-NN graphs built from them — reproduce exactly across runs and
    across the CAM/top-k selection paths.
    """
    if n_bands < 1 or band_bits < 1:
        raise ValueError(f"need n_bands >= 1 and band_bits >= 1, got "
                         f"({n_bands}, {band_bits})")
    if int(np.ceil(np.log2(max(n_bands, 1))) + band_bits) > _MAX_TAG_BITS:
        raise ValueError(
            f"n_bands={n_bands} x band_bits={band_bits} overflows the "
            f"int32 CAM entry space; keep log2(n_bands) + band_bits <= "
            f"{_MAX_TAG_BITS}")
    x = np.asarray(features, np.float32)
    if x.ndim != 2:
        raise ValueError(f"features must be [N, F], got shape {x.shape}")
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(x.shape[1], n_bands * band_bits)) \
        .astype(np.float32)
    bits = (x @ planes) > 0.0                      # [N, n_bands * band_bits]
    bits = bits.reshape(x.shape[0], n_bands, band_bits)
    weights = (1 << np.arange(band_bits, dtype=np.int64))
    return (bits * weights).sum(axis=2).astype(np.int32)


def tag_bands(sigs: np.ndarray, band_bits: int = DEFAULT_BAND_BITS
              ) -> np.ndarray:
    """[N, B] band signatures -> [N * B] flat tagged CAM entries.

    Entry ``i * B + b`` is ``b * 2**band_bits + sigs[i, b]`` — band ``b``
    signatures occupy their own disjoint non-negative id range, so a flat
    equality match (the CAM search) can only pair same-band signatures.
    """
    sigs = np.asarray(sigs, np.int64)
    if sigs.ndim != 2:
        raise ValueError(f"sigs must be [N, n_bands], got shape {sigs.shape}")
    if sigs.min(initial=0) < 0 or sigs.max(initial=0) >= (1 << band_bits):
        raise ValueError(f"signatures must lie in [0, 2**{band_bits}); got "
                         f"range [{sigs.min()}, {sigs.max()}]")
    bands = np.arange(sigs.shape[1], dtype=np.int64)[None, :]
    tagged = bands * (1 << band_bits) + sigs
    return tagged.reshape(-1).astype(np.int32)
