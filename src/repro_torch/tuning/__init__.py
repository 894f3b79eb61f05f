"""Roofline-guided tuning of the Hopper kernels' launch choices.

The counterpart of ``repro.tuning``, for the port's CUDA kernels:
enumerate the launch choices each kernel really makes per launch geometry
(``space``: rows and columns of a block, the depth of a K chunk, warps a
block, a CAM's query group and entries a chunk), prune them with their
roofline bounds on an H100 before anything is timed (``prune``), time the
survivors on the card with CUDA events (``measure``), and cache the winner
keyed by (geometry, platform) (``cache``). ``ExecutionPlan.tune_kernels``
threads the winners into serving via the hashable ``TunedKernels`` bundle
on ``GNNConfig.tuned``; the process-level ``registry`` is what the kernel
wrappers consult after it, and ``registry.resolve`` is the order: an
explicit choice, the bundle, the registry, the default.

Tuned choices never change numerics: every candidate launch gives the
default launch's bits (``chip_smoke.py`` holds each one to it with
``torch.equal`` on the card).
"""
from . import registry  # noqa: F401
from .autotune import current_platform, plan_geometries, tune, tune_plan
from .cache import DEFAULT_CACHE_PATH, TuneCache
from .prune import LaunchCost, launch_cost, prune, roofline_bound
from .space import (AggregateConfig, AggregateGeometry, CamConfig,
                    CamGeometry, CrossbarConfig, CrossbarGeometry,
                    FusedConfig, FusedGeometry, GEOMETRY_TYPES,
                    TunedKernels, candidates, default_config)

__all__ = [
    "registry", "current_platform", "plan_geometries", "tune", "tune_plan",
    "DEFAULT_CACHE_PATH", "TuneCache", "LaunchCost", "launch_cost", "prune",
    "roofline_bound", "AggregateConfig", "AggregateGeometry", "CamConfig",
    "CamGeometry", "CrossbarConfig", "CrossbarGeometry", "FusedConfig",
    "FusedGeometry", "GEOMETRY_TYPES", "TunedKernels", "candidates",
    "default_config",
]
