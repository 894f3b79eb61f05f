"""Monte-Carlo conductance-variation pass.

The counterpart of ``repro.devices.variation``. Programmed crossbar
conductances are not exact: every technology's ``noise_sigma`` is the
relative std of one stored level. This module samples that noise, injects
it into the bit-accurate crossbar numerics, and turns the trials into
per-technology accuracy bounds: mean/p99 relative output error of one MVM
and the end-to-end GNN logit flip rate on a dataset.

  * **Same draws as the reference.** Noise comes from numpy's seeded
    ``default_rng`` on the host, exactly as the reference draws it, and is
    quantized to a ``1/NOISE_GRID`` conductance-level grid so every
    partial sum stays exactly representable in f32. The error statistics
    are reduced in float64 numpy, so a bound is a function of
    ``(technology, seed)`` and of the MVM outputs alone.
  * **Equal across backends.** ``jnp`` runs the plain crossbar version
    and ``pallas`` the hand-written kernel (``crossbar_matmul_quantized``),
    which equals it bit for bit; the same seed gives the same bounds, field
    for field, on both.
  * **Same physical device, same noise.** A signed MVM drives the same
    programmed arrays twice (pos/neg DAC passes); one noise tensor per
    weight matrix is shared by both passes and, end to end, by every layer
    pass of a trial's forward.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..core import gnn
from ..core.graph import dataset_like
from ..kernels.crossbar_mvm import (CrossbarNumerics, crossbar_matmul_signed,
                                    crossbar_matmul_signed_ref)
from ..kernels.csr_aggregate import aggregate
from ..kernels.fused_layer import fused_gnn_layer
from .bank import resolve_technology

# noise codes land on a 1/8 conductance-level grid: fine enough that the
# quantization is ~1% of one level's sigma, coarse enough that every f32
# partial sum stays exactly representable
NOISE_GRID = 8

_Z99 = 2.326   # one-sided 99th-percentile z-score of a standard normal


def sample_conductance_noise(seed, shape, tech, cfg=None) -> np.ndarray:
    """One additive conductance-code noise draw, grid-quantized.

    ``seed`` may be an int or a sequence of ints (trial substreams derive
    as ``[seed, trial]``). Returns float32 ``shape``-d codes in units of
    conductance codes: multiples of ``1/NOISE_GRID``, std
    ``noise_sigma * w_levels``."""
    tech = resolve_technology(tech)
    cfg = cfg or CrossbarNumerics()
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(tuple(shape))
    delta = tech.noise_sigma * cfg.w_levels * eps
    return (np.round(delta * NOISE_GRID) / NOISE_GRID).astype(np.float32)


def layer_noise(seed, params, tech, cfg) -> list:
    """Per-layer weight-noise draws (numpy) for one GNN parameter list:
    one draw per programmed array, shared by every pass that reads it."""
    return [sample_conductance_noise([*np.atleast_1d(seed), i],
                                     tuple(layer["w"].shape), tech, cfg)
            for i, layer in enumerate(params)]


@dataclasses.dataclass(frozen=True)
class VariationBounds:
    """Accuracy bounds of one technology under conductance noise.

    ``mean_err`` / ``p99_err`` — relative output error (|noisy - clean| /
    max|clean|) over all elements and trials; ``ci95`` — 95% confidence
    half-width of ``mean_err`` over the per-trial means; ``flip_rate`` —
    fraction of nodes whose argmax logit flipped (end-to-end runs only).
    """
    technology: str
    trials: int
    seed: int
    mean_err: float
    p99_err: float
    ci95: float
    flip_rate: float | None = None

    def within_ci(self, other: "VariationBounds", k: float = 2.0) -> bool:
        """Same-population check: the two mean errors agree within ``k``x
        their combined confidence half-widths."""
        return abs(self.mean_err - other.mean_err) <= (
            k * (self.ci95 + other.ci95) + 1e-12)


def modeled_p99_error(tech, k_rows: int, cfg=None) -> float:
    """Closed-form first-order p99 relative MVM output error,
    ``z99 * sigma * sqrt(2 / r) / sqrt(n_k)`` for ``r`` active rows of a
    crossbar and ``n_k`` K tiles (the reference's cheap planner model)."""
    tech = resolve_technology(tech)
    if tech.noise_sigma <= 0.0:
        return 0.0
    cfg = cfg or CrossbarNumerics()
    r = max(1, min(int(k_rows), cfg.rows_per_xbar))
    n_k = max(1, math.ceil(int(k_rows) / cfg.rows_per_xbar))
    return _Z99 * tech.noise_sigma * math.sqrt(2.0 / r) / math.sqrt(n_k)


def _mvm(x, w, cfg, w_noise, backend: str) -> torch.Tensor:
    """One (optionally noisy) bit-accurate MVM on the requested backend."""
    if backend == "jnp":
        return crossbar_matmul_signed_ref(x, w, cfg, w_noise=w_noise)
    if backend != "pallas":
        raise ValueError(f"unknown crossbar backend {backend!r}")
    return crossbar_matmul_signed(x, w, cfg, w_noise=w_noise)


def _bounds_from_trials(tech, seed, clean: np.ndarray,
                        noisy: np.ndarray, flip_rate=None) -> VariationBounds:
    """Fold stacked per-trial outputs into a ``VariationBounds`` (float64
    numpy reductions)."""
    clean64 = np.asarray(clean, np.float64)
    noisy64 = np.asarray(noisy, np.float64)
    scale = max(float(np.abs(clean64).max()), 1e-30)
    err = np.abs(noisy64 - clean64[None]) / scale
    per_trial = err.reshape(err.shape[0], -1).mean(axis=1)
    trials = err.shape[0]
    ci95 = (1.96 * float(per_trial.std(ddof=1)) / math.sqrt(trials)
            if trials > 1 else 0.0)
    return VariationBounds(
        technology=resolve_technology(tech).name, trials=trials,
        seed=int(np.atleast_1d(seed)[0]),
        mean_err=float(err.mean()), p99_err=float(np.quantile(err, 0.99)),
        ci95=ci95, flip_rate=flip_rate)


def mvm_error_bounds(tech, cfg=None, m: int = 32, k: int = 216, n: int = 64,
                     trials: int = 8, seed: int = 0, backend: str = "jnp",
                     device="cuda") -> VariationBounds:
    """Monte-Carlo relative-error bounds of one noisy bit-accurate MVM.

    The input matrices are fixed (seed-independent), so every seed samples
    noise for the same workload and two seeds estimate one population
    mean. Each trial is one signed MVM on ``device``: on ``pallas``, two
    launches of the crossbar kernel (and two for the clean product)."""
    dev = resolve_device(device)
    tech = resolve_technology(tech)
    cfg = cfg or CrossbarNumerics()
    rng = np.random.default_rng(0x0DA7A)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.1)
                         .astype(np.float32))
    x, w = x.to(dev), w.to(dev)
    clean = _mvm(x, w, cfg, None, backend).cpu().numpy()
    noisy = np.stack([
        _mvm(x, w, cfg, torch.from_numpy(
            sample_conductance_noise([seed, t], (k, n), tech, cfg)).to(dev),
            backend).cpu().numpy()
        for t in range(trials)])
    return _bounds_from_trials(tech, seed, clean, noisy)


@torch.no_grad()
def noisy_forward(params, x: torch.Tensor, neighbors: torch.Tensor,
                  weights: torch.Tensor, cfg, noise: list) -> torch.Tensor:
    """GNN forward with per-layer conductance noise on any backend.

    Mirrors ``core.gnn.forward`` (same layer loop, same activations) with
    the draws of ``layer_noise`` (numpy arrays or tensors, ``None`` for a
    clean layer) on each layer's programmed weights. ``cfg`` is a
    ``GNNConfig`` with bit-accurate numerics. ``fused`` runs the fused
    kernels; ``jnp`` and ``pallas`` aggregate on their backend, then run
    the plain signed crossbar numerics."""
    if cfg.numerics.ideal:
        raise ValueError("conductance noise models the bit-accurate path "
                         "only")
    h = x
    n_layers = len(params)
    for i, layer in enumerate(params):
        nz = (None if noise[i] is None
              else torch.as_tensor(noise[i], dtype=torch.float32,
                                   device=x.device))
        act = i < n_layers - 1 or cfg.final_activation
        if cfg.backend == "fused":
            h = fused_gnn_layer(h, neighbors, weights, layer["w"],
                                layer["b"], cfg.numerics, relu=act,
                                tuned=cfg.tuned, w_noise=nz)
            continue
        z = aggregate(h, neighbors, weights, backend=cfg.backend,
                      tuned=cfg.tuned)
        h = crossbar_matmul_signed_ref(z, layer["w"], cfg.numerics,
                                       w_noise=nz) + layer["b"]
        if act:
            h = torch.clamp_min(h, 0.0)
    return h


def accuracy_bounds(tech, dataset: str = "taxi", scale: float = 0.02,
                    trials: int = 4, seed: int = 0, backend: str = "jnp",
                    hidden: int = 32, out_dim: int = 10, sample: int = 8,
                    cfg=None, device="cuda") -> VariationBounds:
    """End-to-end bounds: logit error and argmax flip rate on one dataset.

    Builds a downscaled ``dataset_like`` graph, runs the clean bit-accurate
    forward on ``device``, then ``trials`` noisy forwards (fresh per-layer
    draws each), and reports the relative logit error and the flip rate.
    Parameters come from the port's ``gnn.init_params(seed=seed)``."""
    dev = resolve_device(device)
    tech = resolve_technology(tech)
    g = dataset_like(dataset, scale=scale, seed=seed).gcn_normalize()
    numerics = cfg or CrossbarNumerics()
    gcfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(hidden,),
                         out_dim=out_dim, sample=sample, numerics=numerics,
                         backend=backend)
    params = gnn.init_params(gcfg, seed=seed, device=dev)
    nb, wt = g.neighbor_sample(sample)
    xs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (g.features, nb, wt))
    clean = gnn.forward(params, *xs, gcfg).cpu().numpy()
    noisy = np.stack([noisy_forward(
        params, *xs, gcfg, layer_noise([seed, t], params, tech, numerics)
    ).cpu().numpy() for t in range(trials)])
    flips = float((noisy.argmax(-1) != clean.argmax(-1)[None]).mean())
    return _bounds_from_trials(tech, seed, clean, noisy, flip_rate=flips)
