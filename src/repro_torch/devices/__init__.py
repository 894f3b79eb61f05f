"""Device-technology subsystem of the port.

The counterpart of ``repro.devices`` without ``calibrate`` (it needs the
tuning and cost-model packages, not ported yet):

  * **bank** — ``TechnologyParams`` records (SOT-MRAM / ReRAM / SRAM /
    FeFET) and the registry ``resolve_technology``.
  * **variation** — seeded Monte-Carlo conductance noise injected into the
    bit-accurate crossbar numerics; ``VariationBounds`` (mean/p99 output
    error, end-to-end logit flip rate) per technology.
"""
from .bank import (ANCHOR, UnknownTechnologyError, anchor_technology,
                   known_technologies, primitive_scales, register_technology,
                   resolve_technology, technology_table)
from .params import FEFET, RERAM, SOT_MRAM, SRAM, TechnologyParams
from .variation import (NOISE_GRID, VariationBounds, accuracy_bounds,
                        layer_noise, modeled_p99_error, mvm_error_bounds,
                        noisy_forward, sample_conductance_noise)

__all__ = [
    "ANCHOR", "UnknownTechnologyError", "anchor_technology",
    "known_technologies", "primitive_scales", "register_technology",
    "resolve_technology", "technology_table",
    "FEFET", "RERAM", "SOT_MRAM", "SRAM", "TechnologyParams",
    "NOISE_GRID", "VariationBounds", "accuracy_bounds", "layer_noise",
    "modeled_p99_error", "mvm_error_bounds", "noisy_forward",
    "sample_conductance_noise",
]
