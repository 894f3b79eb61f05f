"""Crossbar mapper/compiler: derive hardware mappings from first principles.

The port's copy of ``repro.mapper`` (plain Python and numpy).

``compile_mapping(model, stats, ...)`` turns (GNN layer dims, graph stats,
array inventory) into a ``CompiledMapping`` — per-layer weight tilings with
padding/bit-slicing, array allocation (duplication vs pass serialization),
a pipeline pass schedule, and derived latency/energy rollups. DESIGN.md §8.

The shape-math bottom (``tiling``, ``inventory``) is import-light; the
compiler modules (which pull in ``repro_torch.core``) load lazily via
PEP-562, as the reference's do.
"""
from __future__ import annotations

from .inventory import XbarInventory
from .tiling import (LayerTiling, TileGrid, execute_tiled, padded_grid,
                     tile_layer)

_LAZY = {
    "CompiledMapping": "compile",
    "LayerMapping": "compile",
    "PassPrimitives": "compile",
    "compile_mapping": "compile",
    "items_per_device": "compile",
    "CoreAllocation": "allocate",
    "allocate": "allocate",
    "PassSchedule": "schedule",
    "Stage": "schedule",
    "build_schedule": "schedule",
}

__all__ = ["XbarInventory", "LayerTiling", "TileGrid", "padded_grid",
           "tile_layer", "execute_tiled", *sorted(_LAZY)]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
