"""Tuning search space: kernel geometries, the Hopper kernels' launch
choices, and the hashable ``TunedKernels`` bundle.

The counterpart of ``repro.tuning.space``. A *geometry* is the static
shape signature of one kernel launch; the four geometry types keep the
reference's fields and ``key()`` exactly, so one plan yields the same keys
in both packages. A *config* is one launch choice of a Hopper kernel, a
choice the kernel really makes (``kernels.launch_plans`` computes what
each one launches; 0 keeps the default plan's):

  * ``crossbar_mvm`` — ``(bn, depth)``: the block's output columns (its
    m16 tiles follow from the 8 warps) and the crossbar tiles of a K chunk
    (dividing the crossbar count, as the reference's ``depth`` must).
  * ``fused_layer`` — ``(bm, bn, depth)``: a block's rows and output
    columns and K's chunk depth, for the ideal layer (3xTF32; the split of
    K across warps stays the default plan's) and for the quant layer of the
    bit-accurate path.
  * ``csr_aggregate`` — ``(warps,)``: warps per block of the standalone
    aggregation kernel the composed ``pallas`` backend launches.
  * ``cam_match`` — ``(bq, be)``: the queries of a cluster's group and the
    entries a warp matches per chunk (32 lanes x entries a thread).

The reference's lane-padding knob ``bf`` has no counterpart: the Hopper
kernels mask ragged edges and pad nothing, so the wrappers validate ``bf``
and ignore it, and the crossbar's ``bm`` follows from its 8 warps.

Every candidate gives the default launch's bits: a choice regroups rows
and columns across blocks or K across chunks, never the order of an
output element's sums. ``candidates`` lists the default first, then, in
order, each choice that fits the card (H100 shared memory) for every
numerics the geometry key does not name — the digit count of the
conductance codes and, for ``fused_layer``, the DAC width — so a tuned
choice fits every launch that looks it up.
"""
from __future__ import annotations

import dataclasses
import math

from ..kernels import launch_plans as lp

DEFAULT_WARPS = 8
DEFAULT_BQ = 8
DEFAULT_BE = 256

WARPS_CANDIDATES = lp.AGGREGATE_WARPS
BQ_CANDIDATES = lp.CAM_QUERIES
BE_CANDIDATES = tuple(32 * p for p in lp.CAM_PER)   # 128, 256, 512
CROSSBAR_BN_CANDIDATES = (16, 32, 64)
CROSSBAR_DEPTH_CANDIDATES = (1, 2, 4)
IDEAL_BM_CANDIDATES = (32, 64, 128)
IDEAL_BN_CANDIDATES = (32, 64)
QUANT_BM_CANDIDATES = (16, 32, 64)
QUANT_BN_CANDIDATES = (16, 32, 64)
FUSED_DEPTH_CANDIDATES = (64, 128, 256)
# what a geometry key leaves open: conductance digits, passes of 8 bit
# planes (in_bits up to 30)
DIGIT_COUNTS = (1, 2, 3, 4)
PASS_COUNTS = (1, 2, 3, 4)


@dataclasses.dataclass(frozen=True, order=True)
class CrossbarConfig:
    """One launch choice of the ``crossbar_mvm`` kernel (0: its own)."""
    bn: int = 0                   # output columns a block
    depth: int = 0                # crossbar tiles a K chunk

    def as_dict(self) -> dict:
        return {"bn": self.bn, "depth": self.depth}


@dataclasses.dataclass(frozen=True, order=True)
class FusedConfig:
    """One launch choice of the ``fused_layer`` kernels (0: their own)."""
    bm: int = 0                   # rows a block
    bn: int = 0                   # output columns a block
    depth: int = 0                # K chunk depth, a multiple of 32

    def as_dict(self) -> dict:
        return {"bm": self.bm, "bn": self.bn, "depth": self.depth}


@dataclasses.dataclass(frozen=True, order=True)
class AggregateConfig:
    """One launch choice of the standalone ``csr_aggregate`` kernel."""
    warps: int = DEFAULT_WARPS    # warps per block

    def as_dict(self) -> dict:
        return {"warps": self.warps}


@dataclasses.dataclass(frozen=True, order=True)
class CamConfig:
    """One launch choice of the traversal ``cam_match`` search kernel."""
    bq: int = DEFAULT_BQ          # queries of a cluster's group
    be: int = DEFAULT_BE          # entries a warp matches per chunk

    def as_dict(self) -> dict:
        return {"bq": self.bq, "be": self.be}


CONFIG_TYPES = {"crossbar_mvm": CrossbarConfig, "fused_layer": FusedConfig,
                "csr_aggregate": AggregateConfig, "cam_match": CamConfig}


@dataclasses.dataclass(frozen=True)
class CrossbarGeometry:
    """Static signature of one ``crossbar_matmul_quantized`` launch."""
    m: int
    k: int
    n: int
    rows_per_xbar: int = 512
    in_bits: int = 8

    kernel = "crossbar_mvm"

    @property
    def n_k(self) -> int:
        """Physical crossbars along the contraction dim."""
        return math.ceil(self.k / self.rows_per_xbar)

    def key(self) -> tuple:
        return (self.kernel, self.m, self.k, self.n,
                self.rows_per_xbar, self.in_bits)

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "m": self.m, "k": self.k,
                "n": self.n, "rows_per_xbar": self.rows_per_xbar,
                "in_bits": self.in_bits}


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """Static signature of one ``fused_gnn_layer`` launch.

    ``n`` is the feature-table row count the gather reads (owned + halo
    rows on distributed settings); ``nd`` the destination rows."""
    nd: int
    n: int
    f_in: int
    f_out: int
    sample: int
    ideal: bool = True
    rows_per_xbar: int = 512

    kernel = "fused_layer"

    def key(self) -> tuple:
        return (self.kernel, self.nd, self.n, self.f_in, self.f_out,
                self.sample, self.ideal, self.rows_per_xbar)

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "nd": self.nd, "n": self.n,
                "f_in": self.f_in, "f_out": self.f_out,
                "sample": self.sample, "ideal": self.ideal,
                "rows_per_xbar": self.rows_per_xbar}


@dataclasses.dataclass(frozen=True)
class AggregateGeometry:
    """Static signature of one standalone ``aggregate`` launch.

    ``n`` is the feature-table row count (owned + halo), ``nd`` the
    destination rows, ``f`` the feature width."""
    nd: int
    n: int
    f: int
    sample: int

    kernel = "csr_aggregate"

    def key(self) -> tuple:
        return (self.kernel, self.nd, self.n, self.f, self.sample)

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "nd": self.nd, "n": self.n,
                "f": self.f, "sample": self.sample}


@dataclasses.dataclass(frozen=True)
class CamGeometry:
    """Static signature of one traversal CAM ``search`` launch: ``e`` CSR
    column-index entries, ``q`` queries."""
    e: int
    q: int

    kernel = "cam_match"

    def key(self) -> tuple:
        return (self.kernel, self.e, self.q)

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "e": self.e, "q": self.q}


GEOMETRY_TYPES = {"crossbar_mvm": CrossbarGeometry,
                  "fused_layer": FusedGeometry,
                  "csr_aggregate": AggregateGeometry,
                  "cam_match": CamGeometry}


def default_config(geom):
    """The launch each kernel makes on its own: candidate #0."""
    return CONFIG_TYPES[geom.kernel]()


def tile_depth(f: int, rows_per_xbar: int) -> int:
    """Tile-padded depth of ``f`` rows (``crossbar_mvm.ops.tile_depth``):
    each crossbar tile starts at a multiple of 32."""
    if not f:
        return 0
    tiles = -(-f // rows_per_xbar)
    last = f - (tiles - 1) * rows_per_xbar
    return ((tiles - 1) * (-(-rows_per_xbar // 32) * 32)
            + -(-last // 32) * 32)


def resolve_plan(geom, config, ndig: int = 1, ng: int | None = None):
    """The launch plan (``kernels.launch_plans``) ``config`` gives on
    ``geom`` for ``ndig`` conductance digits and ``ng`` passes of 8 bit
    planes (default: the geometry's DAC width, 8 bits for
    ``fused_layer``). Raises ``ValueError`` where it does not fit."""
    if geom.kernel == "fused_layer":
        if geom.ideal:
            return lp.ideal_resolve(geom.f_in, geom.f_out, config.bm,
                                    config.bn, config.depth)
        kp = tile_depth(geom.f_in, geom.rows_per_xbar)
        return lp.quant_resolve(ndig, ng or 1, geom.f_out,
                                geom.rows_per_xbar, kp, config.bm,
                                config.bn, config.depth)
    if geom.kernel == "crossbar_mvm":
        kp = tile_depth(geom.k, geom.rows_per_xbar)
        return lp.crossbar_resolve(ndig, ng or lp.passes(geom.in_bits),
                                   geom.n, geom.rows_per_xbar, kp, geom.n_k,
                                   config.bn, config.depth)
    if geom.kernel == "cam_match":
        return config.bq, lp.cam_per(config.bq, config.be)
    lp.check_warps(config.warps)
    return config.warps


def fits_everywhere(geom, config) -> bool:
    """Whether ``config`` fits the card for every numerics the geometry
    key leaves open (``DIGIT_COUNTS`` and, on ``fused_layer``'s quant
    path, ``PASS_COUNTS``)."""
    if geom.kernel in ("csr_aggregate", "cam_match") or (
            geom.kernel == "fused_layer" and geom.ideal):
        combos = [(1, None)]
    elif geom.kernel == "crossbar_mvm":
        combos = [(d, None) for d in DIGIT_COUNTS]
    else:
        combos = [(d, g) for d in DIGIT_COUNTS for g in PASS_COUNTS]
    try:
        for ndig, ng in combos:
            resolve_plan(geom, config, ndig, ng)
    except ValueError:
        return False
    return True


def _explicit(geom) -> list:
    if geom.kernel == "csr_aggregate":
        return [AggregateConfig(w) for w in WARPS_CANDIDATES]
    if geom.kernel == "cam_match":
        return [CamConfig(bq, be) for bq in BQ_CANDIDATES
                for be in BE_CANDIDATES]
    if geom.kernel == "crossbar_mvm":
        depths = (0,) + tuple(d for d in CROSSBAR_DEPTH_CANDIDATES
                              if d < geom.n_k and geom.n_k % d == 0)
        return [CrossbarConfig(bn, d) for bn in CROSSBAR_BN_CANDIDATES
                for d in depths]
    k = geom.f_in if geom.ideal else tile_depth(geom.f_in,
                                                geom.rows_per_xbar)
    depths = (0,) + tuple(d for d in FUSED_DEPTH_CANDIDATES if d < k)
    bms, bns = ((IDEAL_BM_CANDIDATES, IDEAL_BN_CANDIDATES) if geom.ideal
                else (QUANT_BM_CANDIDATES, QUANT_BN_CANDIDATES))
    return [FusedConfig(bm, bn, d) for bm in bms for bn in bns
            for d in depths]


def candidates(geom) -> list:
    """Deterministic candidate list, the default first.

    The rest: every explicit choice of ``_explicit`` that fits the card
    for every numerics the key leaves open (``fits_everywhere``) and does
    not launch what the default launches at the geometry's nominal
    numerics (one digit, its own DAC width), in sorted order."""
    default = default_config(geom)
    own = resolve_plan(geom, default)
    rest = {c for c in _explicit(geom)
            if c != default and fits_everywhere(geom, c)
            and resolve_plan(geom, c) != own}
    return [default] + sorted(rest)


@dataclasses.dataclass(frozen=True)
class TunedKernels:
    """Immutable (geometry key -> config) bundle, hashable so it can ride
    on ``GNNConfig.tuned`` (a frozen dataclass)."""
    entries: tuple = ()           # sorted ((key, config), ...) pairs

    @classmethod
    def of(cls, mapping: dict) -> "TunedKernels":
        return cls(tuple(sorted(mapping.items())))

    def lookup(self, key: tuple):
        for k, c in self.entries:
            if k == key:
                return c
        return None

    def merged(self, other: "TunedKernels") -> "TunedKernels":
        """Right-biased union (``other`` wins on key collisions)."""
        m = dict(self.entries)
        m.update(other.entries)
        return TunedKernels.of(m)

    def __len__(self) -> int:
        return len(self.entries)
