"""Device-technology subsystem of the port.

The counterpart of ``repro.devices``:

  * **bank** — ``TechnologyParams`` records (SOT-MRAM / ReRAM / SRAM /
    FeFET) and the registry ``resolve_technology``.
  * **variation** — seeded Monte-Carlo conductance noise injected into the
    bit-accurate crossbar numerics; ``VariationBounds`` (mean/p99 output
    error, end-to-end logit flip rate) per technology.
  * **calibrate** — the per-pass primitives of the derived cost model,
    measured on the card's kernels (``HostCalibration``, stamped with the
    card's platform tag and stale on any other).
"""
from .bank import (ANCHOR, UnknownTechnologyError, anchor_technology,
                   known_technologies, primitive_scales, register_technology,
                   resolve_technology, technology_table)
from .calibrate import (CALIBRATION_PATH, CalibrationStaleError,
                        HostCalibration, calibrate, load_calibration,
                        measure_primitives, save_calibration)
from .params import FEFET, RERAM, SOT_MRAM, SRAM, TechnologyParams
from .variation import (NOISE_GRID, VariationBounds, accuracy_bounds,
                        layer_noise, modeled_p99_error, mvm_error_bounds,
                        noisy_forward, sample_conductance_noise)

__all__ = [
    "ANCHOR", "UnknownTechnologyError", "anchor_technology",
    "known_technologies", "primitive_scales", "register_technology",
    "resolve_technology", "technology_table",
    "CALIBRATION_PATH", "CalibrationStaleError", "HostCalibration",
    "calibrate", "load_calibration", "measure_primitives",
    "save_calibration",
    "FEFET", "RERAM", "SOT_MRAM", "SRAM", "TechnologyParams",
    "NOISE_GRID", "VariationBounds", "accuracy_bounds", "layer_noise",
    "modeled_p99_error", "mvm_error_bounds", "noisy_forward",
    "sample_conductance_noise",
]
