"""The crossbar mapper/compiler: (model, workload, device) → CompiledMapping.

A copy of ``repro.mapper.compile``, so that the port needs nothing of
the JAX package. Its latencies and energies are those of the paper's
modeled crossbar devices, not of the card the port runs on.

Where ``core/costmodel.py`` *calibrates* per-core latencies to the paper's
Table 1 and can therefore only price the exact configurations the paper
measured, this module *derives* them from first principles:

  1. **Tile** every GNN layer's F_in x F_out weight matrix onto the
     device's physical fx crossbars (``tiling.LayerTiling`` — padding and
     bit-slicing make arbitrary shapes mappable), and count the traversal /
     aggregation tile passes one node's neighborhood needs.
  2. **Allocate** the device's array inventory (``allocate.allocate``):
     duplicate weight tiles for throughput when arrays are plentiful,
     serialize passes when they are scarce.
  3. **Schedule** the pass rounds per pipeline stage
     (``schedule.PassSchedule``) and roll up latency (rounds x t_pass) and
     energy (tile passes x per-array read energy).

The per-*pass* primitives are the only calibrated quantities — one CAM
search, one 512x512 aggregation pass, one 128x128 fx pass, inverted from
Table 1 exactly as ``costmodel`` does (t_fx_pass = t3 / 2: the calibration
workload is a 216→128 layer, two fx tiles serialized on one array). Pass
latency scales with the ADC column count and read energy with the cell
count, so changing the crossbar geometry or the inventory moves the rollup
— that is the derivation the calibrated path cannot do. At the paper's own
geometry the two paths agree to ceil-rounding (< 10%, asserted in
tests/test_mapper.py); away from it they diverge, and the divergence is
the measurement (benchmarks/mapper_sweep.py).
"""
from __future__ import annotations

import dataclasses
import math

from .allocate import CoreAllocation, allocate
from .inventory import XbarInventory
from .schedule import PassSchedule, build_schedule
from .tiling import LayerTiling, TileGrid, padded_grid, tile_layer

SETTINGS = ("centralized", "decentralized", "semi")


@dataclasses.dataclass(frozen=True)
class PassPrimitives:
    """Per-round latency [s] and per-tile-pass read energy [J] per core,
    derived from the calibrated ``HardwareParams`` (or a measured
    ``HostCalibration``), scaled to the target inventory's geometry and
    device technology."""
    t_cam: float
    t_agg: float
    t_fx: float
    e_cam: float
    e_agg: float
    e_fx: float

    @classmethod
    def derive(cls, hw, inv: XbarInventory, tech=None,
               calibration=None) -> "PassPrimitives":
        # per-round latencies at the calibration geometry (Table-1 inversion:
        # decentralized = 1 array/core; taxi fx workload = 2 serialized
        # tiles) — or, when a HostCalibration artifact is supplied, the
        # per-pass wall-clocks measured on the current host
        # (devices.calibrate; same geometry convention)
        if calibration is not None:
            t_cam_cal, t_agg_cal, t_fx_cal = (calibration.t_cam,
                                              calibration.t_agg,
                                              calibration.t_fx)
        else:
            t_cam_cal, t_agg_cal, t_fx_cal = hw.t1, hw.t2, hw.t3 / 2.0
        # MVM pass latency tracks the ADC read-out serialization over
        # columns; the bit-serial DAC cycle count is geometry-independent.
        # CAM search is match-line parallel: constant per pass.
        t_agg = t_agg_cal * inv.agg_cols / hw.agg_cols
        t_fx = t_fx_cal * inv.fx_cols / hw.fx_cols
        # read energy tracks the activated cell count; per-array density
        # from the centralized bank (p_core / M_i arrays active per round)
        e_cam = (hw.p_cores_cent[0] / hw.m1) * t_cam_cal
        e_agg = ((hw.p_cores_cent[1] / hw.m2) * t_agg_cal
                 * (inv.agg_rows * inv.agg_cols) / (hw.agg_rows * hw.agg_cols))
        e_fx = ((hw.p_cores_cent[2] / hw.m3) * t_fx_cal
                * (inv.fx_rows * inv.fx_cols) / (hw.fx_rows * hw.fx_cols))
        t_cam = t_cam_cal
        if tech is not None:
            # technology scaling: read-path ratios to the SOT-MRAM anchor
            # (devices.bank) — exactly (1.0, 1.0) at the anchor itself, so
            # the Table-1 calibration point is reproduced bit-for-bit
            from ..devices.bank import primitive_scales
            lat, ene = primitive_scales(tech)
            t_cam, t_agg, t_fx = t_cam * lat, t_agg * lat, t_fx * lat
            e_cam, e_agg, e_fx = e_cam * ene, e_agg * ene, e_fx * ene
        return cls(t_cam, t_agg, t_fx, e_cam, e_agg, e_fx)


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    """One GNN layer's weight tiling plus its kernel-facing padded grid."""
    index: int
    tiling: LayerTiling
    grid: TileGrid          # (bm, bk, bn) the ops layer pads to

    def describe(self) -> str:
        t = self.tiling
        return (f"layer {self.index}: {t.f_in}x{t.f_out} -> "
                f"{t.k_tiles}x{t.n_tiles} tiles of {t.rows}x{t.cols} "
                f"(pad K+{t.pad_k}, N+{t.pad_n}, "
                f"{t.bit_slices} bit-slice(s), "
                f"util {t.utilization:.1%}); kernel grid "
                f"bm={self.grid.bm}, bk={self.grid.bk}, bn={self.grid.bn}")


@dataclasses.dataclass(frozen=True)
class CompiledMapping:
    """The mapper's output: tilings, allocations, schedule, and the
    first-principles latency/energy rollup for one device of one setting."""
    setting: str
    n_devices: int
    items_per_device: int
    inventory: XbarInventory
    layers: tuple                   # LayerMapping per GNN layer
    cam: CoreAllocation
    agg: CoreAllocation
    fx: CoreAllocation
    primitives: PassPrimitives
    schedule: PassSchedule
    sample: int | None = None
    technology: str = "sot-mram"

    # ---- latency rollup (rounds x t_pass), Eq. 1-compatible serial sum ----
    @property
    def t_traversal(self) -> float:
        return self.cam.rounds * self.primitives.t_cam

    @property
    def t_aggregation(self) -> float:
        return self.agg.rounds * self.primitives.t_agg

    @property
    def t_fx(self) -> float:
        return self.fx.rounds * self.primitives.t_fx

    @property
    def t_compute(self) -> float:
        return self.t_traversal + self.t_aggregation + self.t_fx

    @property
    def t_compute_pipelined(self) -> float:
        return self.schedule.t_pipelined

    # ---- energy rollup (tile passes x per-array read energy) ----
    @property
    def energy_j(self) -> float:
        p = self.primitives
        return (self.cam.tile_passes * p.e_cam
                + self.agg.tile_passes * p.e_agg
                + self.fx.tile_passes * p.e_fx)

    @property
    def weight_arrays(self) -> int:
        """fx arrays one resident copy of all layer weights occupies."""
        return sum(lm.tiling.n_arrays for lm in self.layers)

    @property
    def weight_utilization(self) -> float:
        """Programmed cells / cells over the occupied weight arrays."""
        used = sum(lm.tiling.utilization * lm.tiling.n_arrays
                   for lm in self.layers)
        return used / max(self.weight_arrays, 1)

    @property
    def array_utilization(self) -> tuple:
        """(cam, agg, fx) schedule occupancy: work / (rounds x arrays)."""
        return (self.cam.occupancy, self.agg.occupancy, self.fx.occupancy)

    def core_latency(self):
        """The rollup as a ``repro_torch.core.costmodel.CoreLatency``."""
        from ..core.costmodel import CoreLatency
        return CoreLatency(self.t_traversal, self.t_aggregation, self.t_fx)

    def mapping_report(self) -> str:
        inv = self.inventory
        u = self.array_utilization
        lines = [
            f"CompiledMapping[{self.setting}] — {self.n_devices} device(s), "
            f"{self.items_per_device} node(s)/device/inference",
            f"inventory: CAM {inv.cam_arrays}x({inv.cam_rows}x{inv.cam_cols})"
            f", AGG {inv.agg_arrays}x({inv.agg_rows}x{inv.agg_cols}), "
            f"FX {inv.fx_arrays}x({inv.fx_rows}x{inv.fx_cols}), "
            f"{inv.cell_bits} bits/cell, technology {self.technology}",
        ]
        lines += [lm.describe() for lm in self.layers]
        lines += [
            f"weights: {self.weight_arrays} fx arrays resident "
            f"(cell util {self.weight_utilization:.1%}); fx copies "
            f"{self.fx.copies}, groups {self.fx.groups}",
            f"allocation: cam {self.cam.rounds} rounds (occ {u[0]:.1%}), "
            f"agg {self.agg.rounds} rounds (occ {u[1]:.1%}), "
            f"fx {self.fx.rounds} rounds (occ {u[2]:.1%})",
            f"derived: T_compute {self.t_compute:.3e} s (pipelined "
            f"{self.t_compute_pipelined:.3e} s), E {self.energy_j:.3e} J",
            self.schedule.describe(limit=4),
        ]
        return "\n".join(lines)


def _layer_dims(model) -> tuple:
    """Accept a GNNConfig-like object (``.dims``) or a plain dims tuple."""
    dims = tuple(getattr(model, "dims", model))
    if len(dims) < 2 or any(int(d) < 1 for d in dims):
        raise ValueError(f"need >= 2 positive layer dims, got {dims!r}")
    return tuple(int(d) for d in dims)


def items_per_device(setting: str, n_nodes: int, n_clusters: int = 1) -> int:
    """Nodes one device processes per inference (Eq. 2/3 conventions)."""
    if setting == "centralized":
        return max(n_nodes - 1, 1)
    if setting == "decentralized":
        return 1
    assert setting == "semi", setting
    return max(math.ceil(n_nodes / max(n_clusters, 1)) - 1, 1)


def compile_mapping(model, stats, hw=None, inventory: XbarInventory = None,
                    setting: str = "centralized", n_clusters: int = 1,
                    sample: int | None = None, w_bits: int | None = None,
                    technology=None, calibration=None) -> CompiledMapping:
    """Compile (GNN layer dims, graph stats, hardware) into a CompiledMapping.

    ``model``: a ``GNNConfig``-like object exposing ``.dims`` or a plain
    tuple of layer feature dims; ``stats``: ``GraphStats``; ``hw``: the
    calibrated ``HardwareParams`` supplying the per-pass primitives
    (default ``DEFAULT_HW``); ``inventory``: the device's array inventory
    (default: the setting's paper inventory via
    ``XbarInventory.from_hardware``); ``sample``: the runtime's neighbor
    sample size (default: the Table-2 ``avg_cs`` heuristic).

    ``technology``: a registered technology name or ``TechnologyParams``
    overriding the inventory's; the per-pass primitives are scaled by the
    technology's read-path ratios to the SOT-MRAM anchor (exact identity
    at the anchor). An unregistered name raises the named
    ``UnknownTechnologyError`` here, before any latency rollup.
    ``calibration``: a measured ``HostCalibration`` replacing the Table-1
    inversion as the primitives' anchor point (``devices.calibrate``).
    """
    if setting not in SETTINGS:
        raise ValueError(f"unknown setting {setting!r}; one of {SETTINGS}")
    if hw is None:
        from ..core.costmodel import DEFAULT_HW
        hw = DEFAULT_HW
    inv = inventory or XbarInventory.from_hardware(hw, setting)
    # resolve the technology up front: a typo'd name must fail with the
    # named registry error, not deep inside the latency rollup
    from ..devices.bank import resolve_technology
    tech = resolve_technology(
        technology if technology is not None else inv.technology)
    if technology is not None and inv.technology != tech.name:
        # explicit override: rebuild the arrays from the named technology
        # (cell_bits follows it); an inventory already carrying a custom
        # technology/cell_bits pairing is the caller's explicit choice
        inv = inv.with_technology(tech)
    dims = _layer_dims(model)
    prim = PassPrimitives.derive(hw, inv, tech=tech, calibration=calibration)

    items = items_per_device(setting, stats.n_nodes, n_clusters)
    n_devices = (1 if setting == "centralized"
                 else (n_clusters if setting == "semi" else stats.n_nodes))

    # traversal: one CAM search per cam_rows block of the neighbor list
    cs = max(stats.avg_cs, 1.0)
    cam_tiles = math.ceil(cs / inv.cam_rows)
    # aggregation: per layer, (sampled neighbors x that layer's input
    # features) tiled onto the aggregation crossbar
    s = sample if sample is not None else min(cs, inv.agg_rows)
    agg_tiles = sum(math.ceil(max(s, 1) / inv.agg_rows)
                    * math.ceil(f_in / inv.agg_cols) for f_in in dims[:-1])
    # feature extraction: every layer's weight matrix resident on fx arrays
    layers = []
    for i, (f_in, f_out) in enumerate(zip(dims[:-1], dims[1:])):
        # weight precision is a property of the numerics, not the device:
        # default to the stack-wide 8-bit CrossbarNumerics so low-precision
        # cells (cell_bits < 8) correctly trigger bit-slicing
        t = tile_layer(f_in, f_out, inv.fx_rows, inv.fx_cols,
                       w_bits=w_bits or 8, cell_bits=inv.cell_bits)
        layers.append(LayerMapping(i, t, padded_grid(
            max(items, 1), f_in, f_out, inv.fx_rows)))
    fx_tiles = sum(lm.tiling.n_arrays for lm in layers)

    cam = allocate("traversal", cam_tiles, items, inv.cam_arrays)
    agg = allocate("aggregation", agg_tiles, items, inv.agg_arrays)
    fx = allocate("fx", fx_tiles, items, inv.fx_arrays)
    sched = build_schedule((cam, agg, fx),
                           (prim.t_cam, prim.t_agg, prim.t_fx))

    return CompiledMapping(setting, n_devices, items, inv, tuple(layers),
                           cam, agg, fx, prim, sched, sample=sample,
                           technology=tech.name)
