"""The weights of a cell, drawn on the device from the run's seed.

Each parameter is drawn by one call in the dtype it is stored in, from a
generator of its own seeded by (seed, path): so any one parameter can be
drawn again alone, the same on every run of a seed, and the program and
the reference are handed the same values. The shapes, dtypes and
scales come from the architecture's reference (``param_specs``).
"""
from __future__ import annotations

import hashlib

import torch


def leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_one(spec: tuple, seed: int, path: str, device) -> torch.Tensor:
    shape, dtype, (kind, value) = spec
    dt = getattr(torch, dtype)
    if kind == "const":
        return torch.full(shape, value, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    return torch.randn(shape, generator=gen, dtype=dt,
                       device=device).mul_(value)


def draw(specs: dict, seed: int, device) -> dict:
    """``{path: tensor}`` of every parameter in ``specs``."""
    return {path: draw_one(spec, seed, path, device)
            for path, spec in specs.items()}
