"""Public wrappers of the bit-serial crossbar kernel (csrc/crossbar_mvm.cu).

``crossbar_matmul_quantized`` launches the hand-written CUDA kernel on
CUDA tensors and runs the plain version
(``ref.crossbar_matmul_quantized_plain``) on CPU tensors; there is no
other fallback. ``crossbar_matmul`` and ``crossbar_matmul_signed`` wrap it
with the global DAC/weight quantization and the final rescale, as the
reference's ops layer does, so that on the same device::

    crossbar_matmul(x, w, cfg)  ==  ref.crossbar_matmul_ref(x, w, cfg)

bit for bit. The kernel masks ragged M, N and K itself: nothing is padded
to a block grid. ``bm``/``bn``/``depth`` are kept for the reference's
contract and validated; the kernel's tiles are fixed and results do not
depend on them. ``crossbar_matmul_quantized.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..csr_aggregate.ops import stream_ptr
from .ref import (CrossbarNumerics, apply_conductance_noise,
                  check_matmul_shapes, crossbar_matmul_quantized_plain,
                  quantize_inputs, quantize_weights)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _validate_blocks(k: int, cfg: CrossbarNumerics, bm, bn, depth) -> None:
    """Explicit blocks must be positive, and ``depth`` (crossbars per
    step) must divide the crossbar count ceil(K / rows_per_xbar)."""
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


def _refuse_tuned(tuned) -> None:
    if tuned is not None:
        raise NotImplementedError(
            "kernel tuning is not ported to repro_torch yet (ROADMAP.md, "
            "port queue: tuning); pass tuned=None")


def crossbar_matmul_quantized(xq: torch.Tensor, wq: torch.Tensor,
                              cfg: CrossbarNumerics, bm: int | None = None,
                              bn: int | None = None,
                              depth: int | None = None) -> torch.Tensor:
    """Bit-serial crossbar matmul on codes.

    xq: [M, K] int32 DAC codes (< 2**in_bits); wq: [K, N] float32 signed
    conductance codes; contiguous, on one device. Returns the
    integer-domain [M, N] float32 sum (the caller rescales)."""
    check_matmul_shapes(xq, wq)
    if xq.dtype != torch.int32 or wq.dtype != torch.float32:
        raise TypeError(f"want int32 codes and float32 conductance codes; "
                        f"got {xq.dtype}, {wq.dtype}")
    if xq.device != wq.device:
        raise ValueError("xq and wq must share a device")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("xq and wq must be contiguous")
    m, k = xq.shape
    n = wq.shape[1]
    _validate_blocks(k, cfg, bm, bn, depth)
    if xq.device.type == "cpu":
        return crossbar_matmul_quantized_plain(xq, wq, cfg)
    if not 1 <= cfg.in_bits <= 8:
        raise ValueError(f"the crossbar kernel keeps DAC codes in 8 bits; "
                         f"in_bits={cfg.in_bits}")
    if not k:                       # an empty sum; nothing to launch
        return torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m and n:
        fn = _build.c_function(
            "crossbar_mvm", "crossbar_matmul_quantized_f32", (
                _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, _P))
        _build.check(fn(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k,
                        n, cfg.rows_per_xbar, cfg.in_bits, cfg.full_scale,
                        cfg.lsb, cfg.inv_lsb, stream_ptr(xq)),
                     "crossbar_matmul_quantized")
        crossbar_matmul_quantized.launches += 1
    return out


crossbar_matmul_quantized.launches = 0


def _crossbar_matmul(x, w, cfg, bm, bn, depth, w_noise):
    check_matmul_shapes(x, w)
    xq, xs = quantize_inputs(x, cfg)
    wq, ws = quantize_weights(w, cfg)
    wq = apply_conductance_noise(wq, w_noise, cfg).contiguous()
    return crossbar_matmul_quantized(xq, wq, cfg, bm, bn, depth) * (xs * ws)


def crossbar_matmul(x: torch.Tensor, w: torch.Tensor,
                    cfg: CrossbarNumerics = CrossbarNumerics(),
                    bm: int | None = None, bn: int | None = None,
                    depth: int | None = None, tuned=None,
                    w_noise: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w through the crossbar numerics, on the kernel.

    x: [M, K] float (clipped at 0); w: [K, N]; ``w_noise``: optional
    [K, N] conductance-code perturbation, ignored on the ideal path."""
    _refuse_tuned(tuned)
    if cfg.ideal:
        return x.float() @ w.float()
    return _crossbar_matmul(x, w, cfg, bm, bn, depth, w_noise)


def crossbar_matmul_signed(x: torch.Tensor, w: torch.Tensor,
                           cfg: CrossbarNumerics = CrossbarNumerics(),
                           bm: int | None = None, bn: int | None = None,
                           depth: int | None = None, tuned=None,
                           w_noise: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Signed activations: two DAC passes recombined digitally; one
    ``w_noise`` draw is shared by both (same programmed arrays)."""
    _refuse_tuned(tuned)
    if cfg.ideal:
        return x.float() @ w.float()
    pos = _crossbar_matmul(torch.clamp_min(x, 0.0), w, cfg, bm, bn, depth,
                           w_noise)
    neg = _crossbar_matmul(torch.clamp_min(-x, 0.0), w, cfg, bm, bn, depth,
                           w_noise)
    return pos - neg
