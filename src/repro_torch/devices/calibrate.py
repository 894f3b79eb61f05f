"""On-host auto-calibration of the costmodel's per-pass primitives.

The counterpart of ``repro.devices.calibrate``. The derived cost model
(``mapper.PassPrimitives``) normally inverts its per-pass latencies from
the paper's Table 1. This harness measures them instead, on the card: one
CAM search pass (``cam_search``), one aggregation-crossbar pass and one
fx-crossbar pass (``crossbar_matmul_quantized`` at the calibration
geometries) are timed with the tuner's protocol (CUDA events, the minimum
of ``iters`` calls after a warm-up: ``tuning.measure.time_callable``),
and the fit is written to a JSON artifact that
``costmodel.predict(mode="derived", calibration=...)`` (and
``compile_mapping(calibration=...)``) consumes in place of the Table-1
inversion — ``mode="derived"`` then prices the kernels of this card as the
modeled device's passes.

Staleness rule (DESIGN.md §13): the artifact records the platform tag it
was measured on (``tuning.current_platform()``: ``cuda:<device name>``).
Loading it on a different platform raises ``CalibrationStaleError`` unless
``strict=False``.
"""
from __future__ import annotations

import dataclasses
import json
import os

CALIBRATION_PATH = os.path.join("results", "host_calibration_torch.json")


class CalibrationStaleError(ValueError):
    """A calibration artifact measured on another platform was loaded
    strictly. Re-measure with ``calibrate()`` or pass ``strict=False``."""


@dataclasses.dataclass(frozen=True)
class HostCalibration:
    """Measured per-pass primitive latencies [s] on one host platform.

    ``t_cam`` — one CAM search pass (a query block against one
    ``cam_rows`` entry block); ``t_agg`` / ``t_fx`` — one full
    aggregation / feature-extraction crossbar pass at the calibration
    geometry (``agg_rows x agg_cols`` / ``fx_rows x fx_cols``). Geometry
    scaling on top of these is ``PassPrimitives.derive``'s job — the
    artifact is the measured anchor, not the whole model.
    """
    platform: str
    t_cam: float
    t_agg: float
    t_fx: float
    iters: int = 3
    seed: int = 0

    def __post_init__(self):
        for f in ("t_cam", "t_agg", "t_fx"):
            if getattr(self, f) <= 0:
                raise ValueError(f"measured {f} must be > 0, "
                                 f"got {getattr(self, f)}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HostCalibration":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def measure_primitives(hw=None, iters: int = 3, warmup: int = 1,
                       seed: int = 0, device="cuda") -> "HostCalibration":
    """Measure the three per-pass primitives on the card.

    Crossbar passes reuse the tuner's runners at the calibration
    geometries (an 8-row block of DAC codes over one full ``rows x cols``
    array: the launch computes exactly one logical pass); the CAM pass
    searches 8 queries against one ``cam_rows`` entry block. Min of
    ``iters`` CUDA-event times, the build and the warm-up excluded. Raises
    without a CUDA device."""
    from ..tuning.autotune import current_platform
    from ..tuning.measure import (cuda_device, make_inputs, make_runner,
                                  time_callable)
    from ..tuning.space import CamGeometry, CrossbarGeometry, default_config
    if hw is None:
        from ..core.costmodel import DEFAULT_HW
        hw = DEFAULT_HW
    dev = cuda_device(device)
    geoms = {
        "t_agg": CrossbarGeometry(m=8, k=hw.agg_rows, n=hw.agg_cols,
                                  rows_per_xbar=hw.agg_rows),
        "t_fx": CrossbarGeometry(m=8, k=hw.fx_rows, n=hw.fx_cols,
                                 rows_per_xbar=hw.fx_rows),
        "t_cam": CamGeometry(e=hw.cam_rows, q=8),
    }
    t = {}
    for name, g in geoms.items():
        run = make_runner(g, default_config(g), make_inputs(g, seed, dev))
        t[name] = time_callable(run, iters=iters, warmup=warmup)
    return HostCalibration(platform=current_platform(dev), t_cam=t["t_cam"],
                           t_agg=t["t_agg"], t_fx=t["t_fx"],
                           iters=iters, seed=seed)


def save_calibration(cal: HostCalibration,
                     path: str = CALIBRATION_PATH) -> str:
    """Write the artifact (deterministic JSON, the BENCH/cache convention)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(cal.as_dict(), sort_keys=True, indent=2) + "\n")
    return path


def load_calibration(path: str = CALIBRATION_PATH, strict: bool = True,
                     device="cuda") -> "HostCalibration":
    """Load an artifact; enforce the platform staleness rule.

    ``strict=True`` raises ``CalibrationStaleError`` when the artifact's
    platform tag differs from that of ``device``; ``strict=False`` returns
    it anyway (cross-platform inspection, comparison tables).
    """
    with open(path) as f:
        cal = HostCalibration.from_dict(json.load(f))
    if strict:
        from ..tuning.autotune import current_platform
        here = current_platform(device)
        if cal.platform != here:
            raise CalibrationStaleError(
                f"calibration artifact {path!r} was measured on "
                f"{cal.platform!r} but this host is {here!r}; re-run "
                f"devices.calibrate() here or load with strict=False")
    return cal


def calibrate(path: str | None = CALIBRATION_PATH, hw=None, iters: int = 3,
              warmup: int = 1, seed: int = 0,
              device="cuda") -> "HostCalibration":
    """Measure + persist in one call; ``path=None`` skips the write."""
    cal = measure_primitives(hw, iters=iters, warmup=warmup, seed=seed,
                             device=device)
    if path is not None:
        save_calibration(cal, path)
    return cal
