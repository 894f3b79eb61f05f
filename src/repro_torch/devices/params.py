"""Per-technology device parameter records (DESIGN.md §13).

A copy of ``repro.devices.params`` (pure dataclasses), so that the port
needs nothing of the JAX package.

One ``TechnologyParams`` describes the cell-level behaviour of an in-memory
compute technology — the quantities the mapper's per-pass rollup, the
Monte-Carlo variation pass, and the planner's accuracy/energy evaluators
consume. The records are *relative* models: the paper's Table 1 calibrates
one SOT-MRAM geometry, and every other technology is priced by scaling the
calibrated per-pass primitives with its read-latency / read-energy ratio to
that anchor (``bank.ANCHOR``). That keeps the anchor bit-for-bit identical
to the calibrated path (ratio exactly 1.0) while letting the planner trade
technologies per tier from literature-class parameters.

Conventions:

  * latencies/energies are *per cell access* [s] / [J] — absolute values
    matter only through their ratio to the anchor's;
  * ``cell_bits`` is the weight resolution one physical column group
    stores before bit-slicing. The Table-1 calibration maps one 8-bit
    weight per crossbar column, so the anchor records 8; multi-level-cell
    technologies with fewer bits trigger column bit-slicing in
    ``mapper.tiling`` (more arrays, more energy) exactly as a low
    ``XbarInventory.cell_bits`` does;
  * ``noise_sigma`` is the relative conductance-noise std of one
    programmed level (σ_G / G_max): the Monte-Carlo variation pass
    (``devices.variation``) perturbs quantized conductance codes by
    ``noise_sigma * w_levels`` per draw. Digital technologies (SRAM)
    record 0.0;
  * ``endurance`` is write cycles before wear-out — reported so streaming
    refresh churn can be turned into a device lifetime, not used in the
    latency rollup.

Dependency-free by design (pure dataclasses): the mapper and the planner's
candidate space import this module without pulling in jax.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TechnologyParams:
    """Cell-level parameters of one in-memory compute technology."""
    name: str
    read_latency_s: float
    write_latency_s: float
    read_energy_j: float
    write_energy_j: float
    cell_bits: int            # weight bits one column group stores
    on_off_ratio: float       # G_on / G_off conductance window
    noise_sigma: float        # relative conductance-level noise std
    endurance: float          # write cycles before wear-out

    def __post_init__(self):
        if not self.name:
            raise ValueError("technology name must be non-empty")
        for f in ("read_latency_s", "write_latency_s", "read_energy_j",
                  "write_energy_j", "on_off_ratio", "endurance"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{self.name}: {f} must be > 0, "
                                 f"got {getattr(self, f)}")
        if self.cell_bits < 1:
            raise ValueError(f"{self.name}: cell_bits must be >= 1, "
                             f"got {self.cell_bits}")
        if self.noise_sigma < 0:
            raise ValueError(f"{self.name}: noise_sigma must be >= 0, "
                             f"got {self.noise_sigma}")

    @property
    def conductance_levels(self) -> int:
        """Distinct programmable levels per column group (2^cell_bits)."""
        return 2 ** self.cell_bits

    def lifetime_writes(self, writes_per_tick: float) -> float:
        """Ticks until wear-out at a given per-cell write rate."""
        return self.endurance / max(writes_per_tick, 1e-30)


# The paper's calibration point (Table 1 / §4.1): SOT-MRAM crossbars.
# Separate read/write paths give MRAM its fast, low-energy reads; the
# 8 cell_bits record the Table-1 one-weight-per-column mapping convention.
SOT_MRAM = TechnologyParams(
    name="sot-mram",
    read_latency_s=3e-9, write_latency_s=2e-9,
    read_energy_j=25e-15, write_energy_j=350e-15,
    cell_bits=8, on_off_ratio=3.0, noise_sigma=0.01, endurance=1e15)

# ReRAM: dense multi-level cells, slow energetic writes, large
# device-to-device conductance variation.
RERAM = TechnologyParams(
    name="reram",
    read_latency_s=10e-9, write_latency_s=100e-9,
    read_energy_j=10e-15, write_energy_j=2e-12,
    cell_bits=4, on_off_ratio=100.0, noise_sigma=0.05, endurance=1e9)

# SRAM: digital 8T compute macro — fastest access, no conductance noise,
# effectively unlimited endurance, but leaky and area-hungry.
SRAM = TechnologyParams(
    name="sram",
    read_latency_s=1e-9, write_latency_s=1e-9,
    read_energy_j=50e-15, write_energy_j=50e-15,
    cell_bits=8, on_off_ratio=1e6, noise_sigma=0.0, endurance=1e16)

# FeFET: ultra-low read energy (field-effect read, no static current),
# moderate multi-level precision, limited program/erase endurance.
FEFET = TechnologyParams(
    name="fefet",
    read_latency_s=5e-9, write_latency_s=10e-9,
    read_energy_j=5e-15, write_energy_j=100e-15,
    cell_bits=4, on_off_ratio=1e4, noise_sigma=0.03, endurance=1e8)
