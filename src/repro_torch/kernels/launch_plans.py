"""The Hopper kernels' launch plans, computed on the host.

The one place a launch plan is made: the rows and columns of a block, the
depth of a K chunk, warps per block. Every wrapper resolves its launch's
plan here, the default and a tuned choice alike, and passes it to its CUDA
launcher (``csrc/*.cu``), which only refuses a plan that does not fit the
card. The plans are for a card with the shared memory of an H100
(``analysis.roofline.H100``); the tuner enumerates and prices the same
plans. ``*_resolve`` returns the plan a launch runs with the caller's
choices, where 0 keeps the default plan's; it raises ``ValueError`` where
the choices do not fit the card, before any launch, on every device.

No choice changes a bit of any output: the kernels' sums keep their order
in every plan (the notes in each ``.cu`` file say why).
"""
from __future__ import annotations

import dataclasses
import functools

from ..analysis.roofline import H100

MAX_SMEM = H100.smem_bytes          # a block's shared memory, opted in
SM_SMEM = H100.sm_smem_bytes        # one SM's shared memory

AGGREGATE_WARPS = (4, 8, 16)        # csr_aggregate.cu: warps a block
CAM_QUERIES = (4, 8, 16)            # cam_match.cu: kQ, queries a group
CAM_PER = (4, 8, 16)                # cam_match.cu: kPer, entries a thread
CAM_THREADS = 256
MMA_ROWS = 16                       # crossbar_mma.cuh: an m16 tile


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def unit_cols(ndigits: int) -> int:
    """Output columns of one warp unit of the int8 tile (crossbar_mma.cuh
    ``Shape<kD>::kCols``): 16 for one digit, 8 for two or more."""
    return 16 if ndigits == 1 else 8


def passes(in_bits: int) -> int:
    """Passes of 8 bit planes a DAC code of ``in_bits`` takes."""
    return -(-in_bits // 8)


def check_warps(warps: int) -> None:
    if warps not in AGGREGATE_WARPS:
        raise ValueError(f"warps must be one of {AGGREGATE_WARPS}, got "
                         f"{warps!r}")


def cam_per(bq: int, be: int) -> int:
    """kPer of a CAM launch choice: the entries a thread holds per chunk,
    ``be`` entries a warp matches per chunk over 32 lanes. Raises unless
    ``bq`` and ``be`` are choices the kernel has."""
    if bq not in CAM_QUERIES:
        raise ValueError(f"bq must be one of {CAM_QUERIES}, got {bq!r}")
    if be not in tuple(32 * p for p in CAM_PER):
        raise ValueError(f"be must be one of "
                         f"{tuple(32 * p for p in CAM_PER)}, got {be!r}")
    return be // 32


# ------------------------------------------------------------- ideal layer

I_WARPS = 16
I_UNIT = 32
I_MAX_COLS = 64


def _round8(v: int) -> int:
    return (v + 7) & ~7


def _z_stride(kc8: int) -> int:
    return (kc8 + 27) // 32 * 32 + 4


def ideal_splits(units: int, kc: int) -> int:
    """Warps that share a unit's depth (fused_layer.cu ``ideal_splits``)."""
    every, deep = I_WARPS // units, (kc + 7) // 8 // 4
    return 1 if deep < 1 else min(deep, every)


def ideal_smem(bm: int, bn: int, kc8: int, nsplit: int) -> int:
    return 4 * (kc8 * (bn + 8) + max(bm * _z_stride(kc8),
                                     nsplit * bm * (bn + 4)))


@dataclasses.dataclass(frozen=True)
class IdealPlan:
    bm: int
    bn: int
    kc: int
    nsplit: int


def ideal_plan(f: int, h: int, max_smem: int = MAX_SMEM) -> IdealPlan:
    """The ideal layer's default launch: the block's columns (32 at H <= 32,
    else 64), its row tile (64, or 32 where that keeps W resident), K's
    chunk (all of F where W fits the card's shared memory at 32 rows, else
    the deepest multiple of 32 that fits; kc = 0 where nothing fits) and
    the warps sharing a unit's depth."""
    bn = I_UNIT if h <= I_UNIT else I_MAX_COLS

    def smem(bm, kc8):
        return ideal_smem(bm, bn, kc8,
                          ideal_splits(bm // I_UNIT * (bn // I_UNIT), kc8))
    bm, kc = 2 * I_UNIT, f
    if smem(bm, _round8(kc)) > max_smem:
        bm = I_UNIT
    if smem(bm, _round8(kc)) > max_smem:
        kc = f // 32 * 32
        while kc > 0 and smem(bm, kc) > max_smem:
            kc -= 32
    return IdealPlan(bm, bn, kc,
                     ideal_splits(bm // I_UNIT * (bn // I_UNIT), min(kc, f)))


@functools.lru_cache(maxsize=1024)
def ideal_resolve(f: int, h: int, bm: int = 0, bn: int = 0, depth: int = 0,
                  max_smem: int = MAX_SMEM) -> IdealPlan:
    """The ideal layer's launch with these choices: ``bm`` rows a block (32, 64 or 128), ``bn``
    columns (32 or 64), ``depth`` K's chunk (below F, a multiple of 32 and
    of 8 nsplit; 0 keeps the plan's). The kernel splits K across
    ``ideal_splits`` warps of a unit; a choice that splits it otherwise
    than the plan would sum in another order and raises."""
    pl = ideal_plan(f, h, max_smem)
    if pl.kc < 1:
        raise ValueError(f"the ideal layer does not fit at F={f}, H={h}")
    if not (bm or bn or depth):
        return pl
    nbm, nbn, kc = bm or pl.bm, bn or pl.bn, depth or pl.kc
    if nbm not in (32, 64, 128):
        raise ValueError(f"bm must be 32, 64 or 128 rows, got {nbm}")
    if nbn not in (I_UNIT, I_MAX_COLS):
        raise ValueError(f"bn must be 32 or 64 columns, got {nbn}")
    o = IdealPlan(nbm, nbn, kc, ideal_splits(
        nbm // I_UNIT * (nbn // I_UNIT), min(kc, f)))
    if o.nsplit != pl.nsplit:
        raise ValueError(
            f"bm={o.bm}, bn={o.bn}, depth {min(kc, f)} split K across "
            f"{o.nsplit} warps of a unit, the default plan across "
            f"{pl.nsplit}: the sums would change order")
    if depth and (depth >= f or depth % 32 or depth % (8 * o.nsplit)):
        raise ValueError(
            f"depth {depth} must be below F={f} and a multiple of 32 and of "
            f"{8 * o.nsplit} (0 keeps the default plan's depth)")
    kc8 = _round8(min(o.kc, f))
    if ideal_smem(o.bm, o.bn, kc8, o.nsplit) > max_smem:
        raise ValueError(f"bm={o.bm}, bn={o.bn}, depth {min(o.kc, f)} need "
                         f"{ideal_smem(o.bm, o.bn, kc8, o.nsplit)} bytes of "
                         f"shared memory, above {max_smem}")
    return o


# ------------------------------------------------------------- quant layer

Q_WARPS = 8
Q_MAX_COLS = 64


def quant_smem(ndig: int, ng: int, bn: int, mt: int, kc: int) -> int:
    stride, rows = kc + 16, MMA_ROWS * mt
    return ndig * bn * stride + 2 * ng * rows * stride + 4 * 2 * rows * (
        bn + 1)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    bn: int
    mt: int
    kc: int
    carry: bool


def _mts(bn: int, cols: int) -> int:
    return max(1, min(4, Q_WARPS // (2 * (bn // cols))))


def _deepest(ndig, ng, bn, mt, r, max_smem) -> tuple:
    """(kc, carry) of K in chunks: the deepest chunk that fits beside a
    row tile, whole tiles where a tile fits, else the kCarry variant."""
    rows, rpad = MMA_ROWS * mt, _ceil_to(r, 32)
    fixed = 4 * 2 * rows * (bn + 1)
    kc = ((max_smem - fixed) // (ndig * bn + 2 * ng * rows) - 16) // 32 * 32
    carry = ng > 1
    if rpad <= kc:
        kc = kc // rpad * rpad
    else:
        carry = True
    return (0 if kc < 32 else kc), carry


def quant_plan(ndig: int, ng: int, h: int, r: int, kp: int,
               max_smem: int = MAX_SMEM,
               sm_smem: int = SM_SMEM) -> QuantPlan:
    """The quant layer's default launch for ``ndig`` conductance digits and
    ``ng`` passes of bit planes: the block's columns (the unit's columns
    times enough groups to cover H, up to 64) and m16 tiles a row tile
    (enough units for the 8 warps, at most 4). Where all of K fits shared
    memory (kc = kp): with one pass, fewer columns a block until two blocks
    share an SM (three digits at F = 496). Deeper: at most 4 column
    groups, so that the units are at most the 8 warps, and the deepest
    chunk that fits, whole tiles where a tile fits (else the kCarry
    variant), rather than fewer columns: narrower blocks would gather each
    row of z once for each column block. kc = 0 where nothing fits."""
    cols = unit_cols(ndig)
    bn = min(Q_MAX_COLS, _ceil_to(h, cols))
    mt, carry = _mts(bn, cols), ng > 1
    if quant_smem(ndig, ng, bn, mt, kp) <= max_smem:
        while (not carry and bn > cols and
               2 * (quant_smem(ndig, ng, bn, mt, kp) + 1024) > sm_smem):
            bn = max(cols, bn // 2 // cols * cols)
        return QuantPlan(bn, mt, kp, carry)
    bn = min(bn, 4 * cols)
    mt = _mts(bn, cols)
    kc, carry = _deepest(ndig, ng, bn, mt, r, max_smem)
    return QuantPlan(bn, mt, kc, carry)


@functools.lru_cache(maxsize=1024)
def quant_resolve(ndig: int, ng: int, h: int, r: int, kp: int, bm: int = 0,
                  bn: int = 0, depth: int = 0,
                  max_smem: int = MAX_SMEM) -> QuantPlan:
    """The quant layer's launch with these choices: ``bm`` rows a row tile (16 to 64, a multiple of
    16), ``bn`` columns (a multiple of the unit's columns, up to 64),
    ``depth`` the chunk depth (a multiple of 32 up to ``kp``; 0: all of
    ``kp`` where it fits, else the deepest chunk that fits)."""
    pl = quant_plan(ndig, ng, h, r, kp, max_smem)
    if pl.kc < 32:
        raise ValueError(f"the quant layer does not fit at K={kp}, H={h} "
                         f"with {ndig} digits and {ng} passes")
    if not (bm or bn or depth):
        return pl
    cols = unit_cols(ndig)
    nbn = bn or pl.bn
    if nbn % cols or not cols <= nbn <= Q_MAX_COLS:
        raise ValueError(f"bn must be a multiple of {cols} up to "
                         f"{Q_MAX_COLS} columns, got {nbn}")
    if bm and (bm % MMA_ROWS or not MMA_ROWS <= bm <= 4 * MMA_ROWS):
        raise ValueError(f"bm must be 16, 32, 48 or 64 rows, got {bm}")
    mt = bm // MMA_ROWS if bm else (pl.mt if not bn else _mts(nbn, cols))
    if depth:
        if depth % 32 or not 32 <= depth <= kp:
            raise ValueError(f"depth must be a multiple of 32 from 32 to "
                             f"{kp}, got {depth}")
        kc = depth
    elif (nbn, mt) == (pl.bn, pl.mt):
        kc = pl.kc
    elif quant_smem(ndig, ng, nbn, mt, kp) <= max_smem:
        kc = kp
    else:
        kc = _deepest(ndig, ng, nbn, mt, r, max_smem)[0]
    rpad = _ceil_to(r, 32)
    carry = ng > 1 or (kc < kp and kc % rpad != 0)
    if kc < 32:
        raise ValueError(f"bn={nbn}, bm={MMA_ROWS * mt} leave no chunk "
                         f"depth in {max_smem} bytes of shared memory")
    if kc < kp and 2 * (nbn // cols) * mt > Q_WARPS:
        raise ValueError(f"bn={nbn}, bm={MMA_ROWS * mt} in chunks need "
                         f"{2 * (nbn // cols) * mt} units, more than "
                         f"{Q_WARPS} warps")
    if quant_smem(ndig, ng, nbn, mt, kc) > max_smem:
        raise ValueError(f"bn={nbn}, bm={MMA_ROWS * mt}, depth {kc} need "
                         f"{quant_smem(ndig, ng, nbn, mt, kc)} bytes of "
                         f"shared memory, above {max_smem}")
    return QuantPlan(nbn, mt, kc, carry)


# --------------------------------------------------------------- crossbar

X_WARPS = 8
X_MAX_COLS = 64
X_SMEM_BUDGET = 112 * 1024          # crossbar_mvm.cu: two blocks an SM
CROSSBAR_BN = (8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class CrossbarPlan:
    ncg: int
    kc: int

    def cols(self, ndig: int) -> int:
        return self.ncg * unit_cols(ndig)


@functools.lru_cache(maxsize=1024)
def crossbar_resolve(ndig: int, ng: int, n: int, r: int, kp: int,
                     crossbars: int, bn: int = 0,
                     depth: int = 0) -> CrossbarPlan:
    """The crossbar kernel's launch with these choices (0: the default
    plan's, the fewest power-of-two column groups that cover N up to 64
    columns, and the deepest chunk within the kernel's shared memory
    budget, whole tiles with several passes where a tile fits): ``bn``
    columns a block (8, 16, 32 or 64: bn / unit columns column groups, at
    least one), ``depth`` crossbar tiles a K chunk (dividing the crossbar
    count; 0: as deep as the shared memory budget allows)."""
    cols = unit_cols(ndig)
    if bn:
        if bn not in CROSSBAR_BN:
            raise ValueError(f"bn must be one of {CROSSBAR_BN}, got {bn}")
        ncg = max(1, bn // cols)
    else:
        ncg = 1
        while ncg * cols < n and ncg * cols < X_MAX_COLS:
            ncg *= 2
    rows, rpad = MMA_ROWS * (X_WARPS // ncg), _ceil_to(r, 32)
    per_row = ng * rows + ndig * ncg * cols
    if depth:
        if depth < 1 or crossbars % depth:
            raise ValueError(f"pipeline depth {depth} must divide the "
                             f"crossbar count ceil(K/rows_per_xbar) = "
                             f"{crossbars}")
        kc = depth * rpad
    else:
        kc = (X_SMEM_BUDGET // per_row - 16) // 32 * 32
        if ng > 1 and rpad <= kc:
            kc = kc // rpad * rpad
    kc = min(kp, kc)
    if kc < 32 or per_row * (kc + 16) > X_SMEM_BUDGET:
        raise ValueError(f"bn={bn}, depth {depth}: {per_row * (kc + 16)} "
                         f"bytes of shared memory, above the crossbar "
                         f"kernel's {X_SMEM_BUDGET}")
    return CrossbarPlan(ncg, kc)
