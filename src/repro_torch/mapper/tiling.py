"""Weight/activation tiling onto physical crossbar tiles — pure shape math.

A copy of ``repro.mapper.tiling``, so that the port needs nothing of
the JAX package.

This module is the dependency-free bottom of the mapper (no imports of
the port's kernels or core). The compiler (``mapper.compile``) builds
``LayerTiling`` plans and the kernel-view ``TileGrid`` of each layer from
it. The port's CUDA kernels mask ragged edges themselves and pad to no
block grid: ``TileGrid`` describes the reference's Pallas launch and is
kept so that the mapping reports of both packages agree.

Two views of the same layer:

  * ``TileGrid``    — the *kernel* view: an [M, K] x [K, N] matmul padded to
    a (bm, bk, bn) block grid with bk = one physical crossbar's rows (the
    ADC reduction-tree position) and bm/bn MXU/VPU lane-aligned.
  * ``LayerTiling`` — the *hardware* view: how many rows x cols crossbar
    tiles an F_in x F_out weight matrix occupies, including the bit-slicing
    plan when a device cell stores fewer bits than the weight precision
    (OpenNVRAM-style: the array module is sized from the requested rows,
    not the other way round).
"""
from __future__ import annotations

import dataclasses
import math


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Padded (bm, bk, bn) block grid of an [M, K] x [K, N] matmul.

    ``bk`` is one physical crossbar's row count (K-tiles are accumulated
    digitally post-ADC); ``bm``/``bn`` are the MXU block shape. The padded
    dims are the smallest multiples covering the logical shape — the ops
    layer zero-pads to them, the kernel asserts nothing.
    """
    m: int
    k: int
    n: int
    bm: int
    bk: int
    bn: int

    @property
    def m_pad(self) -> int:
        return _ceil_to(self.m, self.bm)

    @property
    def k_pad(self) -> int:
        return _ceil_to(self.k, self.bk)

    @property
    def n_pad(self) -> int:
        return _ceil_to(self.n, self.bn)

    @property
    def grid(self) -> tuple:
        """Pallas grid (M-tiles, N-tiles, K-tiles)."""
        return (self.m_pad // self.bm, self.n_pad // self.bn,
                self.k_pad // self.bk)

    @property
    def k_tiles(self) -> int:
        return self.k_pad // self.bk


def padded_grid(m: int, k: int, n: int, rows_per_xbar: int,
                bm: int = 128, bn: int = 128) -> TileGrid:
    """The (bm, bk, bn) grid mapping an arbitrary [M, K] x [K, N] matmul
    onto ``rows_per_xbar``-row crossbars — what the kernels pad to.

    Any positive M/K/N is mappable; this is the API the kernel layer's
    shape errors point at.
    """
    if min(m, k, n) < 1:
        raise ValueError(f"degenerate matmul shape M={m}, K={k}, N={n}")
    if rows_per_xbar < 1 or bm < 1 or bn < 1:
        raise ValueError(
            f"invalid tile geometry rows_per_xbar={rows_per_xbar}, "
            f"bm={bm}, bn={bn}")
    return TileGrid(m, k, n, bm=bm, bk=rows_per_xbar, bn=bn)


@dataclasses.dataclass(frozen=True)
class LayerTiling:
    """Physical occupancy of one F_in x F_out weight matrix on rows x cols
    crossbar tiles, with the bit-slicing plan.

    A device cell pair stores ``cell_bits``; a ``w_bits`` weight therefore
    spans ``bit_slices`` adjacent physical columns, shrinking the logical
    column capacity of one array to ``cols // bit_slices``.
    """
    f_in: int
    f_out: int
    rows: int
    cols: int
    w_bits: int = 8
    cell_bits: int = 8

    def __post_init__(self):
        if min(self.f_in, self.f_out) < 1:
            raise ValueError(f"degenerate layer {self.f_in}x{self.f_out}")
        if self.cols < self.bit_slices:
            raise ValueError(
                f"crossbar of {self.cols} columns cannot hold one "
                f"{self.w_bits}-bit weight at {self.cell_bits} bits/cell "
                f"({self.bit_slices} slices needed)")

    @property
    def bit_slices(self) -> int:
        return max(1, math.ceil(self.w_bits / self.cell_bits))

    @property
    def logical_cols(self) -> int:
        """Weight columns one physical array holds after bit-slicing."""
        return self.cols // self.bit_slices

    @property
    def k_tiles(self) -> int:
        return math.ceil(self.f_in / self.rows)

    @property
    def n_tiles(self) -> int:
        return math.ceil(self.f_out / self.logical_cols)

    @property
    def n_arrays(self) -> int:
        """Physical arrays one resident copy of the weight matrix occupies."""
        return self.k_tiles * self.n_tiles

    @property
    def pad_k(self) -> int:
        return self.k_tiles * self.rows - self.f_in

    @property
    def pad_n(self) -> int:
        return self.n_tiles * self.logical_cols - self.f_out

    @property
    def utilization(self) -> float:
        """Programmed cells / total cells over the occupied arrays."""
        used = self.f_in * self.f_out * self.bit_slices
        total = self.n_arrays * self.rows * self.cols
        return used / total

    def kernel_grid(self, m: int, bm: int = 128, bn: int = 128) -> TileGrid:
        """The kernel-view grid for an [m, F_in] activation batch."""
        return padded_grid(m, self.f_in, self.f_out, self.rows, bm=bm, bn=bn)


def tile_layer(f_in: int, f_out: int, rows: int, cols: int,
               w_bits: int = 8, cell_bits: int = 8) -> LayerTiling:
    """Tile an F_in x F_out layer onto rows x cols crossbars."""
    return LayerTiling(f_in, f_out, rows, cols, w_bits=w_bits,
                       cell_bits=cell_bits)


def execute_tiled(x, w, tiling: LayerTiling):
    """Execute x @ w tile-by-tile exactly as the tiling maps it to hardware:
    pad K/N to the tile grid, run one partial matmul per (K-tile, N-tile),
    and accumulate K-tiles digitally. Pure numpy, ideal numerics.

    This is the mapper's correctness oracle: for any tiling, the result
    equals the dense matmul (bit-exactly on integer-valued inputs) — the
    property test in tests/test_mapper.py pins it.
    """
    import numpy as np

    x = np.asarray(x)
    w = np.asarray(w)
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or (k, n) != (tiling.f_in, tiling.f_out):
        raise ValueError(f"shape mismatch: x {x.shape}, w {w.shape}, "
                         f"tiling {tiling.f_in}x{tiling.f_out}")
    r, c = tiling.rows, tiling.logical_cols
    xp = np.zeros((m, tiling.k_tiles * r), x.dtype)
    xp[:, :k] = x
    wp = np.zeros((tiling.k_tiles * r, tiling.n_tiles * c), w.dtype)
    wp[:k, :n] = w
    out = np.zeros((m, tiling.n_tiles * c), np.result_type(x, w, np.float64))
    for kt in range(tiling.k_tiles):        # digital cross-crossbar add
        for nt in range(tiling.n_tiles):    # independent column tiles
            out[:, nt * c:(nt + 1) * c] += (
                xp[:, kt * r:(kt + 1) * r] @ wp[kt * r:(kt + 1) * r,
                                               nt * c:(nt + 1) * c])
    return out[:, :n]
