"""Per-device crossbar array inventories (paper §4.1 / Table 1, Fig. 2).

A copy of ``repro.mapper.inventory``, so that the port needs nothing of
the JAX package.

IMA-GNN's devices are bags of physical arrays: the centralized accelerator
carries 2000x(512x32) CAM arrays (traversal), 1000x(512x512) MVM crossbars
(aggregation) and 256x(128x128) MVM crossbars (feature extraction); a
decentralized edge node carries one of each. ``XbarInventory`` is that
inventory as data — counts and geometries per core — so the mapper can
allocate against *any* device, not just the two the paper measured.

Dependency-free by design (duck-types ``HardwareParams``): the kernel layer
may import this module without pulling in the core package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class XbarInventory:
    """Physical array inventory of one accelerator device.

    Per core (traversal CAM / aggregation MVM / feature-extraction MVM):
    array count and rows x cols geometry. ``cell_bits`` is the storage
    resolution of one device pair — fewer bits than the weight precision
    forces bit-slicing across columns (see ``tiling.LayerTiling``).
    ``technology`` names the device technology the arrays are built from
    (``repro_torch.devices.bank``); the default is the paper's SOT-MRAM
    calibration point, and the name is resolved — and validated — by
    ``compile_mapping``, which scales its per-pass primitives by the
    technology's ratio to that anchor.
    """
    cam_arrays: int = 2000
    cam_rows: int = 512
    cam_cols: int = 32
    agg_arrays: int = 1000
    agg_rows: int = 512
    agg_cols: int = 512
    fx_arrays: int = 256
    fx_rows: int = 128
    fx_cols: int = 128
    cell_bits: int = 8
    technology: str = "sot-mram"

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.type == "int" and getattr(self, f.name) < 1:
                raise ValueError(f"inventory field {f.name} must be >= 1, "
                                 f"got {getattr(self, f.name)}")
        if not self.technology:
            raise ValueError("inventory technology must be non-empty")

    @property
    def total_cells(self) -> tuple:
        """(cam, agg, fx) total device cells — the silicon budget."""
        return (self.cam_arrays * self.cam_rows * self.cam_cols,
                self.agg_arrays * self.agg_rows * self.agg_cols,
                self.fx_arrays * self.fx_rows * self.fx_cols)

    @classmethod
    def from_hardware(cls, hw, setting: str = "centralized") -> "XbarInventory":
        """Inventory implied by a ``HardwareParams``-like object.

        ``centralized``/``semi`` (a cluster head is a full centralized
        accelerator, paper §5) get the (m1, m2, m3) multiplicities;
        ``decentralized`` gets ``n_xbar_dec`` of each.
        """
        if setting == "decentralized":
            counts = tuple(int(c) for c in hw.n_xbar_dec)
        else:
            counts = (int(hw.m1), int(hw.m2), int(hw.m3))
        return cls(cam_arrays=counts[0], cam_rows=hw.cam_rows,
                   cam_cols=hw.cam_cols,
                   agg_arrays=counts[1], agg_rows=hw.agg_rows,
                   agg_cols=hw.agg_cols,
                   fx_arrays=counts[2], fx_rows=hw.fx_rows,
                   fx_cols=hw.fx_cols)

    def with_xbar_size(self, size: int, iso_cells: bool = False
                       ) -> "XbarInventory":
        """Re-geometry the MVM crossbars (aggregation + feature extraction)
        to ``size x size`` arrays; the CAM keeps its entry-width geometry.

        ``iso_cells=True`` rescales the array counts to preserve each
        core's total cell budget (the iso-silicon comparison the mapper
        sweep reports); ``False`` keeps the counts — same arrays, different
        geometry.
        """
        agg_n, fx_n = self.agg_arrays, self.fx_arrays
        if iso_cells:
            _, agg_cells, fx_cells = self.total_cells
            agg_n = max(1, agg_cells // (size * size))
            fx_n = max(1, fx_cells // (size * size))
        return dataclasses.replace(self, agg_arrays=agg_n, agg_rows=size,
                                   agg_cols=size, fx_arrays=fx_n,
                                   fx_rows=size, fx_cols=size)

    def with_technology(self, tech) -> "XbarInventory":
        """Rebuild the arrays from another device technology.

        ``tech`` is a registered name or a ``TechnologyParams``
        (``repro_torch.devices.bank.resolve_technology`` — an unknown name
        raises the named ``UnknownTechnologyError``). The cell storage
        resolution follows the technology (fewer ``cell_bits`` triggers
        column bit-slicing in the tiling); the per-pass latency/energy
        scaling happens in ``compile_mapping``'s primitive derivation.
        """
        from ..devices.bank import resolve_technology
        t = resolve_technology(tech)
        return dataclasses.replace(self, technology=t.name,
                                   cell_bits=t.cell_bits)
