"""Public wrappers of the bit-serial crossbar kernel (csrc/crossbar_mvm.cu),
and the programming of weights onto crossbars that both bit-accurate
kernels multiply: int8 conductance digits for the tensor cores.

``crossbar_matmul_quantized`` (conductance codes) and
``crossbar_matmul_programmed`` (a ``Conductances`` from
``program_conductances``) launch the hand-written CUDA kernel on CUDA
tensors and run the plain version (``ref.crossbar_matmul_quantized_plain``)
on CPU tensors; there is no other fallback. Both count their launches in
``crossbar_matmul_quantized.launches``. ``crossbar_matmul`` and
``crossbar_matmul_signed`` program the weights once and wrap the kernel
with the DAC quantization and the final rescale, as the reference's ops
layer does, so that on the same device::

    crossbar_matmul(x, w, cfg)  ==  ref.crossbar_matmul_ref(x, w, cfg)

bit for bit. The kernel masks ragged M, N and K itself and takes any K:
nothing is padded to a block grid. Its launch choices (``CrossbarConfig``)
are ``bn``, the output columns of a block (8, 16, 32 or 64), and
``depth``, the crossbar tiles of a K chunk (dividing the crossbar count
ceil(K / rows_per_xbar), as the reference's must); 0 or ``None`` keeps the
default plan's (``kernels.launch_plans`` computes every launch's plan).
The reference's ``bm`` has no counterpart (a block's rows follow from its
8 warps): it is validated and ignored. ``crossbar_matmul``
and ``crossbar_matmul_signed`` resolve the choice from the explicit
``bn``/``depth``, then ``tuned``, the tuning registry and the default
(``tuning.registry.resolve``); the kernel-level entry points take the
explicit choice or the default. Every choice gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...tuning import registry as _registry
from ...tuning.space import CrossbarConfig, CrossbarGeometry
from .. import _build
from ..csr_aggregate.ops import stream_ptr
from ..launch_plans import crossbar_resolve, passes
from .ref import (CrossbarNumerics, apply_conductance_noise,
                  check_matmul_shapes, crossbar_matmul_quantized_plain,
                  quantize_inputs, quantize_weights)

_P = ctypes.c_void_p
_I = ctypes.c_int

# codes under conductance noise are multiples of 1/GRID
# (devices.variation.NOISE_GRID); GRID·code is split into int8 digits in
# base DIGIT_BASE, most significant first
GRID = 8
DIGIT_BASE = 128
DIGIT_BITS = 7
# the most digits the kernels take: 4 hold |GRID·code| < 2^28, beyond every
# code whose partials are exact in f32 (``_check_exact_partials``)
MAX_DIGITS = 4
# largest |code| that is one int8 digit
ONE_DIGIT_CODE = 127
# DAC codes the kernels take, in passes of 8 bit planes: up to 30 bits,
# where the top level 2^in_bits (2^in_bits - 1 rounds up to it in float32
# above 24 bits) still fits the int32 codes
MAX_IN_BITS = 30


# ------------------------------------------------------ programming


class Conductances(NamedTuple):
    """One weight matrix programmed onto crossbars (``program_conductances``).

    wq: [F, H] signed conductance codes, float32 (what the plain version
    multiplies); w_scale: their float32 0-dim scale; digits: on the card,
    the kernels' int8 operand [D, H, Kp] (``digit_tiles`` of
    ``conductance_digits``, D = ``digit_count``), None on the CPU; kp: its
    depth."""
    wq: torch.Tensor
    w_scale: torch.Tensor
    digits: torch.Tensor | None
    kp: int


def _check_exact_partials(cfg: CrossbarNumerics) -> None:
    """Raise unless every (crossbar tile, bit) partial sum is exact in f32:
    an integer count of eighths of magnitude <= rows_per_xbar · 8 ·
    w_levels, below 2^24. Above that the plain version's f32 matmul rounds
    in an order the kernels' int32 sums cannot follow."""
    if cfg.rows_per_xbar * GRID * cfg.w_levels >= 1 << 24:
        raise ValueError(
            f"rows_per_xbar * 8 * w_levels = "
            f"{cfg.rows_per_xbar * GRID * cfg.w_levels} >= 2^24: the "
            f"bit-plane partials are not exact in float32")


def check_in_bits(cfg: CrossbarNumerics) -> None:
    """Raise unless 1 <= in_bits <= MAX_IN_BITS. Above it the plain
    version's top DAC level, 2^in_bits - 1 rounded in float32, overflows
    its int32 codes."""
    if not 1 <= cfg.in_bits <= MAX_IN_BITS:
        raise ValueError(f"DAC codes of 1 to {MAX_IN_BITS} bits fit the "
                         f"int32 codes; in_bits={cfg.in_bits}")


def tile_depth(f: int, rows_per_xbar: int) -> int:
    """Depth of ``f`` rows with each crossbar tile of ``rows_per_xbar``
    rows starting at a multiple of 32: a multiple of 32."""
    if not f:
        return 0
    r = rows_per_xbar
    tiles = -(-f // r)
    last = f - (tiles - 1) * r
    return (tiles - 1) * (-(-r // 32) * 32) + -(-last // 32) * 32


def _digits_for(top: float, integer: bool) -> int:
    """Int8 digits for codes of magnitude <= ``top``: one for integer
    codes within +-127, else the fewest D >= 2 with |GRID·code| <
    2^(7 D)."""
    if integer and top <= ONE_DIGIT_CODE:
        return 1
    d = 2
    while GRID * top >= 1 << (DIGIT_BITS * d):
        d += 1
    return d


def digit_count(cfg: CrossbarNumerics, noisy: bool) -> int:
    """How many int8 digits programmed codes take, from the configuration
    and the noise flag alone (no read of the codes): one for clean codes
    within +-127; under conductance noise (multiples of 1/GRID) or beyond,
    two up to w_levels 2,047 (w_bits 12), three up to 262,143 (w_bits 19),
    else four."""
    return _digits_for(cfg.w_levels, not noisy)


def conductance_digits(wq: torch.Tensor, ndigits: int) -> torch.Tensor:
    """The int8 digits of conductance codes that the kernels' tensor cores
    multiply, [D, F, H], D = ``ndigits``.

    One digit: the code itself, for integer codes with |code| <= 127. D >=
    2: GRID·code, an integer for codes on the 1/GRID grid, in base
    ``DIGIT_BASE``, most significant first: GRID·code = sum_d
    128^(D - 1 - d) digit[d], the lower digits in [0, 127] and the top one
    in [-128, 127], which holds |GRID·code| < 2^(7 D). The codes are not
    read on the host; codes outside these cases give other digits
    (``program_conductances`` and ``crossbar_matmul_quantized`` make
    none)."""
    if ndigits == 1:
        return wq.to(torch.int8)[None]
    w8 = (wq * float(GRID)).to(torch.int32)
    shifts = [DIGIT_BITS * (ndigits - 1 - d) for d in range(ndigits)]
    return torch.stack([w8 >> shifts[0]] + [(w8 >> sh) & (DIGIT_BASE - 1)
                                            for sh in shifts[1:]]
                       ).to(torch.int8)


def digit_tiles(digits: torch.Tensor, rows_per_xbar: int):
    """``digits`` [D, F, H] in the kernels' layout, [D, H, Kp] with the
    depth contiguous: crossbar tile t's rows start at t·rpad, rpad =
    rows_per_xbar rounded up to 32, and the pads are 0. Returns
    (layout, Kp); Kp = ``tile_depth(F, rows_per_xbar)``."""
    d, f, h = digits.shape
    r = rows_per_xbar
    rpad = -(-r // 32) * 32
    tiles = -(-f // r)
    kp = tile_depth(f, r)
    by_tile = F.pad(digits.transpose(1, 2), (0, tiles * r - f))
    by_tile = F.pad(by_tile.reshape(d, h, tiles, r), (0, rpad - r))
    return by_tile.reshape(d, h, tiles * rpad)[:, :, :kp].contiguous(), kp


def check_noise_grid(w_noise: torch.Tensor) -> None:
    """Raise unless every entry of a conductance-noise draw is a finite
    multiple of 1/GRID, as ``devices.sample_conductance_noise`` draws them.
    One read of the draw (a host sync on the card)."""
    w8 = w_noise.float() * float(GRID)
    if not bool((torch.isfinite(w8) & (w8 == torch.round(w8))).all()):
        raise ValueError(f"conductance noise must be finite multiples of "
                         f"1/{GRID} (the 1/{GRID} grid of "
                         f"devices.sample_conductance_noise)")


def check_codes(wq: torch.Tensor, cfg: CrossbarNumerics) -> int:
    """Raise unless every conductance code is a finite multiple of 1/GRID
    whose partials stay exact in f32 (rows_per_xbar · 8 · max|code| <
    2^24, and ``_check_exact_partials``). Returns how many int8 digits the
    codes take (``_digits_for`` their largest magnitude; one for integer
    codes within +-127). One read of the codes (a host sync on the
    card)."""
    _check_exact_partials(cfg)
    check_in_bits(cfg)
    if not wq.numel():
        return 1
    w8 = wq * float(GRID)
    stats = torch.stack([
        (~(torch.isfinite(w8) & (w8 == torch.round(w8)))).any().float(),
        wq.abs().amax(), (wq != torch.round(wq)).any().float()])
    off_grid, top, fraction = stats.tolist()
    if off_grid:
        raise ValueError(f"conductance codes must be finite multiples of "
                         f"1/{GRID}")
    if cfg.rows_per_xbar * GRID * top >= 1 << 24:
        raise ValueError(f"rows_per_xbar * 8 * max|code| = "
                         f"{cfg.rows_per_xbar * GRID * top} >= 2^24: the "
                         f"bit-plane partials are not exact in float32")
    return _digits_for(top, not fraction)


def program_conductances(w: torch.Tensor, cfg: CrossbarNumerics,
                         w_noise: torch.Tensor | None = None
                         ) -> Conductances:
    """Program ``w`` [F, H] onto crossbars: symmetric conductance codes
    (``quantize_weights``), plus ``w_noise`` clipped to +-w_levels
    (``apply_conductance_noise``), and on the card the kernels' int8
    digits (``digit_count`` of them). Raises, on every device, for a draw
    off the 1/GRID grid and where the partials leave f32 exactness. Without
    ``w_noise`` nothing is read back to the host."""
    _check_exact_partials(cfg)
    if w_noise is not None:
        check_noise_grid(w_noise)
    wq, w_scale = quantize_weights(w, cfg)
    wq = apply_conductance_noise(wq, w_noise, cfg).contiguous()
    if wq.device.type == "cpu":
        return Conductances(wq, w_scale, None, 0)
    digits, kp = digit_tiles(
        conductance_digits(wq, digit_count(cfg, w_noise is not None)),
        cfg.rows_per_xbar)
    return Conductances(wq, w_scale, digits, kp)


# ------------------------------------------------------ the kernel


def _validate_blocks(k: int, cfg: CrossbarNumerics, bm, bn,
                     depth) -> CrossbarConfig | None:
    """The caller's launch choice, or None. Explicit blocks must be
    positive, and ``depth`` (crossbars per step) must divide the crossbar
    count ceil(K / rows_per_xbar); ``bm`` is validated and ignored."""
    for name, val in (("bm", bm), ("bn", bn)):
        if val is not None and int(val) < 1:
            raise ValueError(f"{name} must be a positive block size, got "
                             f"{val!r} (pass None for the default)")
    if depth is not None:
        crossbars = -(-k // cfg.rows_per_xbar)
        if int(depth) < 1 or crossbars % int(depth):
            raise ValueError(f"pipeline depth {depth} must divide the "
                             f"crossbar count ceil(K/rows_per_xbar) = "
                             f"{crossbars}")
    if bn is None and depth is None:
        return None
    return CrossbarConfig(int(bn or 0), int(depth or 0))


def crossbar_plan(k: int, n: int, ndigits: int, cfg: CrossbarNumerics,
                  config: CrossbarConfig | None):
    """(bn, kc) of the launch plan for ``config`` (None: the default
    plan), ``launch_plans.crossbar_resolve``; raises ``ValueError`` where
    the choice does not fit the card."""
    c = config or CrossbarConfig()
    r = cfg.rows_per_xbar
    pl = crossbar_resolve(ndigits, passes(cfg.in_bits), n, r,
                          tile_depth(k, r), -(-k // r), c.bn, c.depth)
    return pl.cols(ndigits), pl.kc


def _check_xq(xq: torch.Tensor, wq: torch.Tensor) -> None:
    check_matmul_shapes(xq, wq)
    if xq.dtype != torch.int32 or wq.dtype != torch.float32:
        raise TypeError(f"want int32 codes and float32 conductance codes; "
                        f"got {xq.dtype}, {wq.dtype}")
    if xq.device != wq.device:
        raise ValueError("xq and wq must share a device")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("xq and wq must be contiguous")


def _launch(xq: torch.Tensor, digits: torch.Tensor, kp: int, n: int,
            cfg: CrossbarNumerics,
            config: CrossbarConfig | None = None) -> torch.Tensor:
    """The kernel on int32 codes [M, K] and int8 digits [D, N, kp]."""
    m, k = xq.shape
    if not k:                       # an empty sum; nothing to launch
        return torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    bn, kc = crossbar_plan(k, n, digits.shape[0], cfg, config)
    if digits.device != xq.device or digits.dtype != torch.int8 \
            or digits.shape[1:] != (n, kp) \
            or not 1 <= digits.shape[0] <= MAX_DIGITS \
            or not digits.is_contiguous() or digits.data_ptr() % 16 \
            or kp != tile_depth(k, cfg.rows_per_xbar):
        raise ValueError("digits must be the contiguous int8 [D, N, Kp] "
                         "layout of digit_tiles on xq's device")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m and n:
        fn = _build.c_function(
            "crossbar_mvm", "crossbar_matmul_quantized_i8", (
                _P, _P, _I, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, _I, _I, _P))
        _build.check(fn(xq.data_ptr(), digits.data_ptr(), digits.shape[0],
                        out.data_ptr(), m, k, n, cfg.rows_per_xbar, kp,
                        cfg.in_bits, cfg.full_scale, cfg.lsb, cfg.inv_lsb,
                        bn, kc, stream_ptr(xq)), "crossbar_matmul_quantized")
        crossbar_matmul_quantized.launches += 1
    return out


def crossbar_matmul_quantized(xq: torch.Tensor, wq: torch.Tensor,
                              cfg: CrossbarNumerics, bm: int | None = None,
                              bn: int | None = None,
                              depth: int | None = None) -> torch.Tensor:
    """Bit-serial crossbar matmul on codes.

    xq: [M, K] int32 DAC codes (< 2**in_bits); wq: [K, N] float32 signed
    conductance codes, finite multiples of 1/8; contiguous, on one device.
    Returns the integer-domain [M, N] float32 sum (the caller rescales).
    Raises, on every device, for codes off the 1/8 grid or whose partials
    leave f32 exactness and for in_bits above MAX_IN_BITS (``check_codes``:
    one read of the codes, which also picks the number of int8 digits),
    and for a launch choice (``bn``/``depth``) that does not fit the
    card."""
    _check_xq(xq, wq)
    config = _validate_blocks(xq.shape[1], cfg, bm, bn, depth)
    ndigits = check_codes(wq, cfg)
    if config is not None:
        crossbar_plan(xq.shape[1], wq.shape[1], ndigits, cfg, config)
    if xq.device.type == "cpu":
        return crossbar_matmul_quantized_plain(xq, wq, cfg)
    digits, kp = digit_tiles(conductance_digits(wq, ndigits),
                             cfg.rows_per_xbar)
    return _launch(xq, digits, kp, wq.shape[1], cfg, config)


crossbar_matmul_quantized.launches = 0


def crossbar_matmul_programmed(xq: torch.Tensor, codes: Conductances,
                               cfg: CrossbarNumerics,
                               config: CrossbarConfig | None = None
                               ) -> torch.Tensor:
    """``crossbar_matmul_quantized`` of ``xq`` against programmed weights
    (``program_conductances`` with the same ``cfg``): on the card the
    kernel multiplies ``codes.digits`` with no read of the codes; on the
    CPU the plain version multiplies ``codes.wq``. ``config``: the launch
    choice (None: the default plan). Raises, on every device, for
    in_bits above MAX_IN_BITS; a choice that does not fit the card raises
    ``ValueError`` (on the CPU, checked for one digit)."""
    _check_xq(xq, codes.wq)
    check_in_bits(cfg)
    if xq.device.type == "cpu":
        if config is not None:
            crossbar_plan(xq.shape[1], codes.wq.shape[1], 1, cfg, config)
        return crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
    if codes.digits is None:
        raise ValueError("codes were not programmed on xq's device")
    return _launch(xq, codes.digits, codes.kp, codes.wq.shape[1], cfg,
                   config)


def _programmed_matmul(x, codes: Conductances, cfg,
                       config=None) -> torch.Tensor:
    xq, xs = quantize_inputs(x, cfg)
    return crossbar_matmul_programmed(xq, codes, cfg, config) * (
        xs * codes.w_scale)


def _resolve(x, w, cfg, bm, bn, depth, tuned) -> CrossbarConfig:
    """The launch choice of ``crossbar_matmul``: explicit ``bn``/``depth``
    first, then ``tuned``, the tuning registry, the default."""
    explicit = _validate_blocks(x.shape[1], cfg, bm, bn, depth)
    geom = CrossbarGeometry(m=int(x.shape[0]), k=int(x.shape[1]),
                            n=int(w.shape[1]),
                            rows_per_xbar=cfg.rows_per_xbar,
                            in_bits=cfg.in_bits)
    return _registry.resolve(geom, explicit, tuned)


def crossbar_matmul(x: torch.Tensor, w: torch.Tensor,
                    cfg: CrossbarNumerics = CrossbarNumerics(),
                    bm: int | None = None, bn: int | None = None,
                    depth: int | None = None, tuned=None,
                    w_noise: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w through the crossbar numerics, on the kernel.

    x: [M, K] float (clipped at 0); w: [K, N]; ``w_noise``: optional
    [K, N] conductance-code perturbation on the 1/8 grid, ignored on the
    ideal path."""
    if cfg.ideal:
        return x.float() @ w.float()
    check_matmul_shapes(x, w)
    config = _resolve(x, w, cfg, bm, bn, depth, tuned)
    return _programmed_matmul(x, program_conductances(w, cfg, w_noise), cfg,
                              config)


def crossbar_matmul_signed(x: torch.Tensor, w: torch.Tensor,
                           cfg: CrossbarNumerics = CrossbarNumerics(),
                           bm: int | None = None, bn: int | None = None,
                           depth: int | None = None, tuned=None,
                           w_noise: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Signed activations: two DAC passes recombined digitally; one
    ``w_noise`` draw is shared by both (same programmed arrays: the
    weights are programmed once)."""
    if cfg.ideal:
        return x.float() @ w.float()
    check_matmul_shapes(x, w)
    config = _resolve(x, w, cfg, bm, bn, depth, tuned)
    codes = program_conductances(w, cfg, w_noise)
    pos = _programmed_matmul(torch.clamp_min(x, 0.0), codes, cfg, config)
    neg = _programmed_matmul(torch.clamp_min(-x, 0.0), codes, cfg, config)
    return pos - neg
