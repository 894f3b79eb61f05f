"""Persistent (geometry, platform)-keyed store of tuning winners.

A copy of ``repro.tuning.cache``. Its default file is
``results/tuned_configs_torch.json``: the port's configs are the Hopper
kernels' launch choices, which the reference's entries do not parse as.

The mapper caches a ``CompiledMapping`` on its ``ExecutionPlan``; the
tuner needs the same property across *processes* — measurement is the
expensive step, and a serving process should never re-time a geometry a
previous run already decided. Entries are keyed by the geometry key plus
the platform tag (``cuda:<device name>``, ``cpu``), because a winner on
one card says nothing about a winner on another.

Serialization is deterministic: sorted keys, fixed indent — two caches
holding the same decisions are byte-identical files (regression-tested in
tests/test_torch_tuning.py).
"""
from __future__ import annotations

import json
import os

from .space import CONFIG_TYPES

DEFAULT_CACHE_PATH = os.path.join("results", "tuned_configs_torch.json")


def _key_str(geom_key: tuple, platform: str) -> str:
    return "|".join(str(p) for p in (*geom_key, platform))


class TuneCache:
    """Dict-of-records tuning cache with deterministic JSON round-trip."""

    def __init__(self, path: str | None = None, entries: dict | None = None):
        self.path = path
        self.entries = dict(entries or {})

    @classmethod
    def load(cls, path: str = DEFAULT_CACHE_PATH) -> "TuneCache":
        entries = {}
        if os.path.exists(path):
            with open(path) as f:
                entries = json.load(f)
        return cls(path, entries)

    # ---- record access ----------------------------------------------------
    def get(self, geom, platform: str):
        """The cached winner config for (geometry, platform), or None."""
        rec = self.entries.get(_key_str(geom.key(), platform))
        if rec is None:
            return None
        return CONFIG_TYPES[rec["kernel"]](**rec["config"])

    def put(self, geom, platform: str, config, **meta) -> None:
        self.entries[_key_str(geom.key(), platform)] = dict(
            kernel=geom.kernel, geometry=geom.as_dict(),
            platform=platform, config=config.as_dict(), **meta)

    def configs_for(self, platform: str):
        """[(geometry_key_str_prefix, config)] — feeds registry.activate.

        Yields (geometry key tuple, config) pairs for one platform; the
        key tuple is rebuilt from the stored geometry dict."""
        from .space import GEOMETRY_TYPES
        for rec in self.entries.values():
            if rec.get("platform") != platform:
                continue
            gd = dict(rec["geometry"])
            gd.pop("kernel", None)
            geom = GEOMETRY_TYPES[rec["kernel"]](**gd)
            yield geom.key(), CONFIG_TYPES[rec["kernel"]](**rec["config"])

    # ---- deterministic persistence ---------------------------------------
    def dumps(self) -> str:
        return json.dumps(self.entries, sort_keys=True, indent=2,
                          default=str) + "\n"

    def save(self, path: str | None = None) -> str:
        path = path or self.path or DEFAULT_CACHE_PATH
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dumps())
        self.path = path
        return path

    def __len__(self) -> int:
        return len(self.entries)
