"""Public wrappers of the fused GNN-layer kernels (``csrc/fused_layer.cu``).

Three kernels share one gather, ``z = sum_s w[i,s] * x[nbr[i,s]]``
(``csrc/warp_gather.cuh``: a row per group of lanes, float4 loads, padding
slots skipped, the plain loop's bits), and keep Z out of device memory:

  * ``fused_ideal_layer`` — ``act(z @ W + b)`` with f32 accuracy: a tile of
    z gathered into shared memory, then the product on the TF32 tensor
    cores with the 3xTF32 split (``csrc/tf32_mma.cuh``), within rtol 1e-5
    of the plain f32 matmul. Any F (K in chunks where W does not fit in
    shared memory) and any H.
  * ``fused_zmax``        — per node ``(max(max(z,0)), max(max(-z,0)))``,
    the scale pass of the bit-accurate layer ([Nd, 2] instead of Z),
    equal to its plain version bit for bit.
  * ``fused_quant_layer`` — DAC codes of z against the two global scales,
    then the bit-serial crossbar MVM with an ADC per (K-tile, bit), its
    bit-plane products on the int8 tensor cores, against the weights'
    int8 digits (``program_conductances``, from ``crossbar_mvm``).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
PyTorch version beside it (``*_plain``) on a CPU tensor; it counts its
launches in ``<wrapper>.launches``. ``fused_gnn_layer`` is the layer the
``fused`` backend runs: one launch on the ideal path; zmax, the global
scales, the weight codes and the quant kernel on the bit-accurate one.
No padding to a block grid is needed: the kernels mask ragged edges.

The launch choices of the ideal and the quant layer (``FusedConfig``: a
block's rows ``bm`` and columns ``bn``, K's chunk ``depth``; 0 keeps the
default plan's; ``kernels.launch_plans`` computes every launch's plan,
the default's too, and the launcher only checks that it fits) resolve in
``fused_gnn_layer`` from its explicit ``config``, then ``tuned``, the
tuning registry and the default
(``tuning.registry.resolve``); every choice gives the same bits. The
reference's lane block ``bf`` has no counterpart: it is validated and
ignored.
"""
from __future__ import annotations

import ctypes

import torch

from ...tuning import registry as _registry
from ...tuning.space import FusedConfig, FusedGeometry
from .. import _build
from ..launch_plans import ideal_resolve, passes, quant_resolve
# the programming helpers live with the crossbar; re-exported for the
# quant layer's callers
from ..crossbar_mvm.ops import (DIGIT_BASE, GRID, MAX_DIGITS,  # noqa: F401
                                Conductances, _check_exact_partials,
                                _digits_for, check_in_bits, check_noise_grid,
                                conductance_digits, digit_count,
                                digit_tiles, program_conductances,
                                tile_depth)
from ..crossbar_mvm.ref import (CrossbarNumerics, _const,
                                crossbar_matmul_quantized_plain)
from ..csr_aggregate.ops import check_gather_inputs, stream_ptr
from ..csr_aggregate.ref import csr_aggregate_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_layer(x, neighbors, weights, w, b):
    check_gather_inputs(x, neighbors, weights)
    f, h = w.shape
    if f != x.shape[1] or b.shape != (h,):
        raise ValueError(f"want w [F, H] and b [H] for x [N, F]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if w.dtype != torch.float32 or b.dtype != torch.float32 \
            or w.device != x.device or b.device != x.device \
            or not (w.is_contiguous() and b.is_contiguous()):
        raise TypeError("w and b must be contiguous float32 on x's device")


# ---------------------------------------------------------------- ideal


def fused_ideal_layer_plain(x, neighbors, weights, w, b, *,
                            relu: bool = False) -> torch.Tensor:
    """Plain version of ``fused_ideal_layer``: Z materialized, then one
    matmul."""
    h = csr_aggregate_ref(x, neighbors, weights) @ w + b
    return torch.clamp_min(h, 0.0) if relu else h


def _is_default(config) -> bool:
    return config is None or config == FusedConfig()


def ideal_plan_args(f: int, h: int, config: FusedConfig | None) -> tuple:
    """(bm, bn, kc) of the ideal layer's launch plan for ``config`` (None:
    the default plan); raises ``ValueError`` where the choice does not fit
    the card."""
    c = config or FusedConfig()
    pl = ideal_resolve(f, h, c.bm, c.bn, c.depth)
    return pl.bm, pl.bn, pl.kc


def fused_ideal_layer(x: torch.Tensor, neighbors: torch.Tensor,
                      weights: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, *, relu: bool = False,
                      config: FusedConfig | None = None) -> torch.Tensor:
    """``act((A_hat @ X) @ W + b)`` in one kernel, ideal float numerics.

    x: [N, F]; neighbors/weights: [Nd, S]; w: [F, H]; b: [H].
    Returns [Nd, H] float32. ``config``: the launch choice (None: the
    default plan); one that does not fit the card raises ``ValueError``
    on every device."""
    _check_layer(x, neighbors, weights, w, b)
    nd, s = neighbors.shape
    f, h = w.shape
    if not _is_default(config) and f and h:
        ideal_plan_args(f, h, config)   # an illegal choice raises anywhere
    if x.device.type == "cpu":
        return fused_ideal_layer_plain(x, neighbors, weights, w, b,
                                       relu=relu)
    out = torch.empty((nd, h), dtype=torch.float32, device=x.device)
    if nd and h:
        plan = ideal_plan_args(f, h, config)
        fn = _build.c_function("fused_layer", "fused_ideal_layer_f32", (
            _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
            _I, _I, _P))
        _build.check(fn(x.data_ptr(), neighbors.data_ptr(),
                        weights.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), nd, s, f, h, int(relu), *plan,
                        stream_ptr(x)), "fused_ideal_layer")
        fused_ideal_layer.launches += 1
    return out


fused_ideal_layer.launches = 0


# ---------------------------------------------------------------- zmax


def fused_zmax_plain(x, neighbors, weights) -> torch.Tensor:
    """Plain version of ``fused_zmax``."""
    z = csr_aggregate_ref(x, neighbors, weights)
    return torch.stack([torch.clamp_min(z, 0.0).amax(dim=1),
                        torch.clamp_min(-z, 0.0).amax(dim=1)], dim=1)


def fused_zmax(x: torch.Tensor, neighbors: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Per-node ``(max(max(z, 0)), max(max(-z, 0)))`` of ``Z = A_hat @ X``
    without writing Z. Returns [Nd, 2] float32."""
    check_gather_inputs(x, neighbors, weights)
    if x.shape[1] == 0:
        raise ValueError("fused_zmax needs at least one feature column")
    if x.device.type == "cpu":
        return fused_zmax_plain(x, neighbors, weights)
    nd, s = neighbors.shape
    out = torch.empty((nd, 2), dtype=torch.float32, device=x.device)
    if nd:
        fn = _build.c_function("fused_layer", "fused_zmax_f32", (
            _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P))
        _build.check(fn(x.data_ptr(), neighbors.data_ptr(),
                        weights.data_ptr(), out.data_ptr(), nd, s,
                        x.shape[1], stream_ptr(x)), "fused_zmax")
        fused_zmax.launches += 1
    return out


fused_zmax.launches = 0


# ---------------------------------------------------------------- quant


def fused_quant_layer_plain(x, neighbors, weights, wq, b, scales,
                            cfg: CrossbarNumerics, *,
                            relu: bool = False) -> torch.Tensor:
    """Plain version of ``fused_quant_layer``."""
    z = csr_aggregate_ref(x, neighbors, weights)
    mvm = []
    for sign, scale in ((1.0, scales[0]), (-1.0, scales[1])):
        part = torch.clamp_min(sign * z, 0.0)
        codes = torch.clamp(torch.round(part / scale), 0, cfg.in_levels)
        mvm.append(crossbar_matmul_quantized_plain(codes.to(torch.int32), wq,
                                                   cfg))
    h = (mvm[0] * (scales[0] * scales[2])
         - mvm[1] * (scales[1] * scales[2])) + b
    return torch.clamp_min(h, 0.0) if relu else h


def quant_plan_args(f: int, h: int, ndigits: int, cfg: CrossbarNumerics,
                    config: FusedConfig | None) -> tuple:
    """(bn, mt, kc, carry) of the quant layer's launch plan for ``config``
    (None: the default plan) and ``ndigits`` conductance digits; raises
    ``ValueError`` where the choice does not fit the card."""
    c = config or FusedConfig()
    pl = quant_resolve(ndigits, passes(cfg.in_bits), h, cfg.rows_per_xbar,
                       tile_depth(f, cfg.rows_per_xbar), c.bm, c.bn,
                       c.depth)
    return pl.bn, pl.mt, pl.kc, int(pl.carry)


def fused_quant_layer(x: torch.Tensor, neighbors: torch.Tensor,
                      weights: torch.Tensor, codes: Conductances,
                      b: torch.Tensor, scales: torch.Tensor,
                      cfg: CrossbarNumerics, *,
                      relu: bool = False,
                      config: FusedConfig | None = None) -> torch.Tensor:
    """Bit-accurate fused layer on programmed conductance codes.

    codes: ``program_conductances`` of the layer's [F, H] weights (on the
    card, its int8 digits are what the kernel multiplies); b: [H];
    scales: [3] = (dac_scale_pos, dac_scale_neg, w_scale) on x's device.
    Returns [Nd, H] float32 == act(signed crossbar MVM of Z against
    codes.wq, rescaled, + b), rounded as the composed oracle
    ``crossbar_matmul_signed_ref`` rounds: each tile's shifted ADC outputs
    are summed before the cross-tile add, and each sign pass is scaled by
    ``scale * w_scale`` before the subtraction. The two bit-accurate paths
    therefore agree bit for bit on the same codes; a layer's output feeds
    the next layer's DAC, where one ulp can move a code and its ADC output
    by a whole step. Raises, on every device, where the partials leave f32
    exactness and for in_bits above MAX_IN_BITS (30). Any depth: DAC codes
    wider than a byte take passes of 8 bit planes, and where the digits do
    not fit the kernel's shared memory it stages K in chunks. ``config``:
    the launch choice (None: the default plan); one that does not fit
    the card for these codes raises ``ValueError`` on every device."""
    wq = codes.wq
    _check_layer(x, neighbors, weights, wq, b)
    if scales.shape != (3,) or scales.dtype != torch.float32 \
            or scales.device != x.device:
        raise ValueError("scales must be float32 [3] on x's device")
    _check_exact_partials(cfg)
    check_in_bits(cfg)
    nd, s = neighbors.shape
    f, h = wq.shape
    if x.device.type == "cpu":
        if not _is_default(config) and f and h:  # the card's digits
            top = float(wq.abs().max()) if wq.numel() else 0.0
            quant_plan_args(f, h, _digits_for(
                top, bool((wq == torch.round(wq)).all())), cfg, config)
        return fused_quant_layer_plain(x, neighbors, weights, wq, b, scales,
                                       cfg, relu=relu)
    if codes.digits is None or codes.digits.device != x.device:
        raise ValueError("codes were not programmed on x's device")
    out = torch.empty((nd, h), dtype=torch.float32, device=x.device)
    if nd and h:
        plan = quant_plan_args(f, h, codes.digits.shape[0], cfg, config)
        fn = _build.c_function("fused_layer", "fused_quant_layer_f32", (
            _P, _P, _P, _P, _I, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
            _I, _I, _I, ctypes.c_float, ctypes.c_float, ctypes.c_float, _I,
            _I, _I, _I, _I, _P))
        _build.check(fn(x.data_ptr(), neighbors.data_ptr(),
                        weights.data_ptr(), codes.digits.data_ptr(),
                        codes.digits.shape[0], b.data_ptr(),
                        scales.data_ptr(), out.data_ptr(), nd, s, f, h,
                        cfg.rows_per_xbar, codes.kp, cfg.in_bits,
                        cfg.full_scale, cfg.lsb, cfg.inv_lsb, int(relu),
                        *plan, stream_ptr(x)), "fused_quant_layer")
        fused_quant_layer.launches += 1
    return out


fused_quant_layer.launches = 0


# ---------------------------------------------------------------- layer


def quant_operands(zmax: torch.Tensor, w: torch.Tensor,
                   cfg: CrossbarNumerics,
                   w_noise: torch.Tensor | None = None):
    """(codes, scales) for ``fused_quant_layer`` from the zmax pass: the
    programmed, optionally perturbed, conductance codes
    (``program_conductances``) and the global DAC scales of max(Z, 0) and
    max(-Z, 0) (floor 1e-8, over ``in_levels``) beside their w_scale."""
    levels = _const(cfg.in_levels, zmax)
    scale_pos = torch.clamp_min(zmax[:, 0].max(), 1e-8) / levels
    scale_neg = torch.clamp_min(zmax[:, 1].max(), 1e-8) / levels
    codes = program_conductances(w, cfg, w_noise)
    return codes, torch.stack([scale_pos, scale_neg, codes.w_scale])


def fused_gnn_layer(x: torch.Tensor, neighbors: torch.Tensor,
                    weights: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    cfg: CrossbarNumerics = CrossbarNumerics(ideal=True),
                    *, relu: bool = False, bf: int | None = None,
                    config: FusedConfig | None = None, tuned=None,
                    w_noise: torch.Tensor | None = None) -> torch.Tensor:
    """``act((A_hat @ X) @ W + b)`` with Z kept out of device memory.

    Matches ``ref.fused_layer_ref`` for ideal and bit-accurate ``cfg``.
    The launch choice is ``config``, else ``tuned`` (a ``TunedKernels``),
    the tuning registry and the default, looked up by this launch's
    ``FusedGeometry``. ``bf`` (the reference's lane block) is validated and
    ignored: the kernels pad nothing. ``w_noise``: optional [F, H]
    conductance-code perturbation, ignored on the ideal path; on every
    device it must be multiples of 1/GRID, as
    ``devices.sample_conductance_noise`` draws them (raises otherwise)."""
    if bf is not None and int(bf) < 1:
        raise ValueError(f"bf must be a positive lane block, got {bf!r} "
                         f"(pass None for the default)")
    geom = FusedGeometry(nd=int(neighbors.shape[0]), n=int(x.shape[0]),
                         f_in=int(x.shape[1]), f_out=int(w.shape[1]),
                         sample=int(neighbors.shape[1]), ideal=cfg.ideal,
                         rows_per_xbar=cfg.rows_per_xbar)
    config = _registry.resolve(geom, config, tuned)
    if cfg.ideal:
        return fused_ideal_layer(x, neighbors, weights, w, b, relu=relu,
                                 config=config)
    zmax = fused_zmax(x, neighbors, weights)
    codes, scales = quant_operands(zmax, w, cfg, w_noise)
    return fused_quant_layer(x, neighbors, weights, codes, b, scales, cfg,
                             relu=relu, config=config)


def fused_gnn_forward(params: list, x: torch.Tensor, neighbors: torch.Tensor,
                      weights: torch.Tensor,
                      cfg: CrossbarNumerics = CrossbarNumerics(ideal=True),
                      *, final_activation: bool = False,
                      bf: int | None = None) -> torch.Tensor:
    """Multi-layer fused driver: the full-graph GNN forward, one fused
    kernel launch per layer (plus the zmax pass on the bit-accurate path).

    params: [{'w': [F_i, F_i+1], 'b': [F_i+1]}, ...]; x: [N, F_0];
    neighbors/weights: [N, S]. Semantics match ``core.gnn.forward``."""
    h = x
    n_layers = len(params)
    for i, layer in enumerate(params):
        relu = i < n_layers - 1 or final_activation
        h = fused_gnn_layer(h, neighbors, weights, layer["w"], layer["b"],
                            cfg, relu=relu, bf=bf)
    return h


def fused_gnn_forward_batched(params: list, x: torch.Tensor,
                              neighbors: torch.Tensor, weights: torch.Tensor,
                              cfg: CrossbarNumerics = CrossbarNumerics(
                                  ideal=True),
                              *, final_activation: bool = False,
                              bf: int | None = None) -> torch.Tensor:
    """Batched multi-layer driver over a leading cluster axis.

    x: [K, N, F]; neighbors/weights: [K, N, S]. Each cluster runs the fused
    multi-layer forward on its own subgraph. Returns [K, N, out_dim]."""
    return torch.stack([
        fused_gnn_forward(params, x[k], neighbors[k], weights[k], cfg,
                          final_activation=final_activation, bf=bf)
        for k in range(x.shape[0])])
