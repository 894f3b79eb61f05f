"""Array allocation: map per-node tile work onto a device's array pool.

A copy of ``repro.mapper.allocate``, so that the port needs nothing of
the JAX package.

One allocation rule covers all three cores and both scarcity regimes:

  * **plentiful** — when a device has more arrays than one work item needs
    (``arrays >= tiles_per_item``), the weight tiles are *duplicated*
    ``copies = arrays // tiles_per_item`` times and that many items are
    processed per pass round (the paper's §4.3 "more crossbars per node →
    linear speed-up" made explicit).
  * **scarce** — when one item's tiles exceed the pool
    (``tiles_per_item > arrays``), the item is *serialized* over
    ``groups = ceil(tiles_per_item / arrays)`` pass rounds, time-
    multiplexing the pool across tile groups.

``rounds = ceil(items / copies) * groups`` is then the number of serialized
crossbar pass rounds this core needs per inference — latency is
``rounds x t_pass``; energy is ``tile_passes x e_pass`` (idle arrays in a
ragged last round draw no read energy, so energy counts work, not rounds).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CoreAllocation:
    """Allocation of one core's array pool for one inference."""
    core: str               # "traversal" | "aggregation" | "fx"
    tiles_per_item: int     # tile-passes one work item (node) needs
    n_items: int            # work items this device processes per inference
    arrays: int             # physical arrays of this kind on the device

    def __post_init__(self):
        if self.tiles_per_item < 1 or self.n_items < 0 or self.arrays < 1:
            raise ValueError(f"invalid allocation {self}")

    @property
    def groups(self) -> int:
        """Sequential tile groups when one item overflows the pool."""
        return math.ceil(self.tiles_per_item / self.arrays)

    @property
    def copies(self) -> int:
        """Parallel duplicates of the item's tile set across the pool."""
        return max(1, self.arrays // self.tiles_per_item)

    @property
    def rounds(self) -> int:
        """Serialized pass rounds per inference (latency multiplier)."""
        if self.n_items == 0:
            return 0
        return math.ceil(self.n_items / self.copies) * self.groups

    @property
    def tile_passes(self) -> int:
        """Total tile-level passes executed (energy multiplier)."""
        return self.n_items * self.tiles_per_item

    @property
    def arrays_used(self) -> int:
        """Arrays the schedule actually exercises."""
        return min(self.arrays, self.copies * self.tiles_per_item)

    @property
    def occupancy(self) -> float:
        """Work / capacity over the schedule: tile_passes / (rounds*arrays)."""
        if self.rounds == 0:
            return 0.0
        return self.tile_passes / (self.rounds * self.arrays)

    @property
    def resident(self) -> bool:
        """True when one full tile set fits the pool (no time-multiplexing)."""
        return self.groups == 1


def allocate(core: str, tiles_per_item: int, n_items: int,
             arrays: int) -> CoreAllocation:
    """Allocate ``arrays`` physical arrays to ``n_items`` work items of
    ``tiles_per_item`` tiles each. See module docstring for the rule."""
    return CoreAllocation(core, tiles_per_item, n_items, arrays)
