"""Roofline-guided candidate pruning on the card's own bounds.

The counterpart of ``repro.tuning.prune``. Each candidate launch choice
implies a per-launch cost — the operations and the device-memory bytes
the Hopper kernel moves at that choice (``launch_cost``), and the shared
memory a block takes. The costs feed ``analysis.roofline.roofline_terms``
over ``H100`` and the dominant-term bound prunes the space before
anything is timed, with the reference's rules:

  1. **feasibility** — a candidate whose block does not fit the card's
     shared memory can never launch; drop it.
  2. **bound**       — a candidate whose roofline lower bound is more than
     ``slack``x the best candidate's cannot win by more than measurement
     noise; drop it.
  3. **cap**         — measure at most ``max_survivors`` configs (bound
     order), the default always among them.

The costs count what a launch moves for its geometry, with every slot of
the neighbor sample live (the data decides how many are; a geometry does
not): a block of fewer columns than the output gathers its rows of Â·X
once per column block, a K chunk that is not the whole depth stages the
weights again for every row tile, and a smaller query group reads the CAM
entries once more per group. Operations run at the rate of their type:
f32 on the CUDA cores, 3 x TF32 for the ideal layer's product, int8 for
the bit-plane products.
"""
from __future__ import annotations

import dataclasses

from ..analysis.roofline import H100, HW, roofline_terms
from ..kernels import launch_plans as lp
from .space import candidates, resolve_plan, tile_depth


@dataclasses.dataclass(frozen=True)
class LaunchCost:
    """Per-launch cost of one (geometry, config) point on the card."""
    flops: float
    hbm_bytes: float
    smem_bytes: float
    grid_steps: int                 # blocks, or row tiles of a persistent grid
    collective_bytes: float = 0.0
    precision: str = "f32"          # the operations' type (HW.peak)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gather_bytes(nd: int, s: int, f: int) -> float:
    """One gather of Â·X: the slot tables and a feature row per slot."""
    return 4.0 * nd * s * f + 8.0 * nd * s


def crossbar_cost(geom, c, hw: HW = H100) -> LaunchCost:
    """``crossbar_matmul_quantized`` at (bn, depth), clean codes (one
    digit): each column block reads its row tiles' DAC codes; the digits
    are staged once a persistent block where the depth is one chunk,
    else once a row tile."""
    pl = resolve_plan(geom, c)
    cols = pl.cols(1)
    kp = tile_depth(geom.k, geom.rows_per_xbar)
    ncol = _cdiv(geom.n, cols)
    rows = lp.MMA_ROWS * (lp.X_WARPS // pl.ncg)
    row_tiles = _cdiv(geom.m, rows)
    per_sm = 1 if geom.in_bits > 8 else 2
    blocks = min(row_tiles, max(1, per_sm * hw.n_sms // ncol))
    stagings = blocks if pl.kc >= kp else row_tiles
    hbm = (4.0 * geom.m * geom.k * ncol + 1.0 * kp * cols * ncol * stagings
           + 4.0 * geom.m * geom.n)
    ops = 2.0 * geom.m * kp * ncol * cols * geom.in_bits
    ng = lp.passes(geom.in_bits)
    smem = (ng * rows + cols) * (pl.kc + 16)
    return LaunchCost(ops, hbm, smem, row_tiles * ncol, precision="int8")


def _ideal_cost(geom, c, hw: HW) -> LaunchCost:
    pl = resolve_plan(geom, c)
    f, h = geom.f_in, geom.f_out
    ncol, row_tiles = _cdiv(h, pl.bn), _cdiv(geom.nd, pl.bm)
    blocks = min(row_tiles, max(1, hw.n_sms // ncol))
    w_stagings = blocks if pl.kc >= f else row_tiles
    hbm = (_gather_bytes(geom.nd, geom.sample, f) * ncol
           + 4.0 * f * pl.bn * ncol * w_stagings + 4.0 * geom.nd * h)
    flops = 3 * 2.0 * geom.nd * ((f + 7) // 8 * 8) * ncol * pl.bn
    kc8 = (min(pl.kc, f) + 7) // 8 * 8
    smem = lp.ideal_smem(pl.bm, pl.bn, kc8, pl.nsplit)
    return LaunchCost(flops, hbm, smem, row_tiles * ncol, precision="tf32")


def _quant_cost(geom, c, hw: HW) -> LaunchCost:
    """The bit-accurate layer at 8-bit DAC codes and one digit: the zmax
    pass's gather, then the quant layer's, once per column block."""
    pl = resolve_plan(geom, c)
    f, h = geom.f_in, geom.f_out
    kp = tile_depth(f, geom.rows_per_xbar)
    ncol, row_tiles = _cdiv(h, pl.bn), _cdiv(geom.nd, lp.MMA_ROWS * pl.mt)
    per_sm = 1 if pl.carry else 2
    blocks = min(row_tiles, max(1, per_sm * hw.n_sms // ncol))
    chunks = _cdiv(kp, pl.kc)
    d_stagings = blocks if chunks == 1 else row_tiles
    zmax = _gather_bytes(geom.nd, geom.sample, f) + 8.0 * geom.nd
    quant = ((4.0 * geom.nd * geom.sample * f
              + 8.0 * geom.nd * geom.sample * chunks) * ncol
             + 1.0 * kp * pl.bn * ncol * d_stagings + 4.0 * geom.nd * h)
    ops = 2 * 8 * 2.0 * geom.nd * kp * ncol * pl.bn
    smem = lp.quant_smem(1, 1, pl.bn, pl.mt, pl.kc)
    return LaunchCost(ops, zmax + quant, smem, row_tiles * ncol,
                      precision="int8")


def fused_cost(geom, c, hw: HW = H100) -> LaunchCost:
    """One ``fused_gnn_layer`` launch at (bm, bn, depth)."""
    return (_ideal_cost if geom.ideal else _quant_cost)(geom, c, hw)


def aggregate_cost(geom, c, hw: HW = H100) -> LaunchCost:
    """One standalone ``csr_aggregate`` launch at ``warps``: every choice
    moves the same bytes (a row per 16 or 32 lanes, the gather once)."""
    lanes = 16 if geom.f // 4 <= 16 else 32
    blocks = _cdiv(geom.nd, 32 * c.warps // lanes)
    hbm = _gather_bytes(geom.nd, geom.sample, geom.f) + 4.0 * geom.nd * geom.f
    flops = 2.0 * geom.nd * geom.sample * geom.f
    return LaunchCost(flops, hbm, 0.0, blocks)


def cam_cost(geom, c, hw: HW = H100) -> LaunchCost:
    """One CAM search at (bq, be): each query group's cluster reads all of
    E, and the bitmap is written once."""
    groups = _cdiv(geom.q, c.bq)
    chunk = lp.CAM_THREADS * lp.cam_per(c.bq, c.be)
    blocks = groups * min(max(_cdiv(geom.e, chunk), 1), 16)
    hbm = (1.0 * geom.q * geom.e + 4.0 * geom.e * groups + 8.0 * geom.q)
    flops = 2.0 * geom.q * geom.e              # compare + popcount add
    smem = 4.0 * (lp.CAM_THREADS // 32 + 1) * c.bq
    return LaunchCost(flops, hbm, smem, blocks)


def launch_cost(geom, config, hw: HW = H100) -> LaunchCost:
    if geom.kernel == "fused_layer":
        return fused_cost(geom, config, hw)
    if geom.kernel == "csr_aggregate":
        return aggregate_cost(geom, config, hw)
    if geom.kernel == "cam_match":
        return cam_cost(geom, config, hw)
    return crossbar_cost(geom, config, hw)


def roofline_bound(geom, config, hw: HW = H100) -> float:
    """Dominant-term lower bound [s] for one launch (the pruning score)."""
    return roofline_terms(launch_cost(geom, config, hw), hw).bound_s


def prune(geom, cands: list | None = None, hw: HW = H100,
          slack: float = 2.0, max_survivors: int = 4) -> list:
    """[(config, bound_s)] survivors worth timing, best bound first.

    Fully deterministic (pure arithmetic on the geometry). The default
    config always survives, even when its bound loses: it is the reference
    the winner is measured against."""
    cands = candidates(geom) if cands is None else list(cands)
    default = cands[0]
    scored = [(c, roofline_bound(geom, c, hw)) for c in cands
              if launch_cost(geom, c, hw).smem_bytes <= hw.smem_bytes]
    if not scored:
        return [(default, roofline_bound(geom, default, hw))]
    best = min(b for _, b in scored)
    scored.sort(key=lambda cb: (cb[1], cb[0]))
    survivors = [(c, b) for c, b in scored if b <= slack * best]
    survivors = survivors[:max_survivors]
    if all(c != default for c, _ in survivors):
        survivors.append((default, roofline_bound(geom, default, hw)))
    return survivors
