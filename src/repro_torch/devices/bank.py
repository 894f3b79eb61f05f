"""The technology bank: registry of ``TechnologyParams`` records.

A copy of ``repro.devices.bank`` (pure dataclasses), so that the port
needs nothing of the JAX package.

``resolve_technology`` is the single name→record lookup the mapper, the
planner, and the benches share; an unregistered name raises
``UnknownTechnologyError`` (a ``ValueError``) that lists the registered
technologies — the named early failure ``mapper.compile_mapping`` surfaces
instead of dying deep in the latency rollup.

``ANCHOR`` is the calibration point: every per-pass primitive scale factor
is a ratio to the anchor's parameters, so pricing the anchor itself is the
exact identity (scale 1.0 bit-for-bit) and the calibrated Table-1 numbers
are reproduced unchanged (the acceptance contract of
``benchmarks/tech_sweep.py``).
"""
from __future__ import annotations

from .params import FEFET, RERAM, SOT_MRAM, SRAM, TechnologyParams

ANCHOR = "sot-mram"

_REGISTRY: dict = {}


class UnknownTechnologyError(ValueError):
    """An inventory or candidate referenced a technology the bank does not
    know. Carries the known names so callers can print an actionable list."""

    def __init__(self, name, known):
        self.name = name
        self.known = tuple(known)
        super().__init__(
            f"unknown device technology {name!r}; registered technologies: "
            f"{', '.join(self.known)}")


def register_technology(tech: TechnologyParams) -> TechnologyParams:
    """Add (or replace) one technology record; returns it for chaining."""
    if not isinstance(tech, TechnologyParams):
        raise TypeError(f"expected TechnologyParams, got {type(tech)!r}")
    _REGISTRY[tech.name] = tech
    return tech


def known_technologies() -> tuple:
    """Registered technology names, registration order."""
    return tuple(_REGISTRY)


def resolve_technology(tech) -> TechnologyParams:
    """Name or record → registered ``TechnologyParams``.

    Accepts a ``TechnologyParams`` (returned as-is — ad-hoc records need
    no registration) or a registered name; anything else raises
    ``UnknownTechnologyError`` naming the known technologies.
    """
    if isinstance(tech, TechnologyParams):
        return tech
    rec = _REGISTRY.get(tech)
    if rec is None:
        raise UnknownTechnologyError(tech, known_technologies())
    return rec


def anchor_technology() -> TechnologyParams:
    """The calibration-point record every scale factor is a ratio to."""
    return _REGISTRY[ANCHOR]


def primitive_scales(tech) -> tuple:
    """(latency_scale, energy_scale) of ``tech`` relative to the anchor.

    Read-path ratios: crossbar MVM passes and CAM searches are read
    operations (weights are programmed once per model load). The anchor's
    own scales are exactly (1.0, 1.0) — multiplying the calibrated
    primitives by them is the bit-for-bit identity.
    """
    t = resolve_technology(tech)
    a = anchor_technology()
    return (t.read_latency_s / a.read_latency_s,
            t.read_energy_j / a.read_energy_j)


def technology_table() -> list:
    """JSON-ready rows of every registered technology (docs/bench table)."""
    return [dict(name=t.name, read_latency_s=t.read_latency_s,
                 write_latency_s=t.write_latency_s,
                 read_energy_j=t.read_energy_j,
                 write_energy_j=t.write_energy_j,
                 cell_bits=t.cell_bits, on_off_ratio=t.on_off_ratio,
                 noise_sigma=t.noise_sigma, endurance=t.endurance)
            for t in _REGISTRY.values()]


for _t in (SOT_MRAM, RERAM, SRAM, FEFET):
    register_technology(_t)
del _t
