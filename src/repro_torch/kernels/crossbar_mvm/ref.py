"""Plain PyTorch oracle for the RRAM crossbar MVM numerics (IMA-GNN Fig. 2(b)).

The counterpart of ``repro.kernels.crossbar_mvm.ref``, step for step:

  1. DAC       — unsigned uniform quantization of the inputs to ``in_bits``,
                 applied bit-serially (one bit-plane per cycle).
  2. crossbar  — weights quantized symmetrically to ``w_bits`` signed
                 conductance codes; one bit-plane against the codes is an
                 integer matmul.
  3. ADC       — each partial sum is clipped to the full-scale range of one
                 ``rows_per_xbar`` tile and uniformly quantized.
  4. Shift&Add — bit-plane partials and crossbar row tiles are recombined
                 digitally after the ADC.

Codes are int32 where the reference uses uint32; they never exceed 255.
``torch.round`` rounds half to even, as ``jnp.round`` does.

The DAC divides by its runtime scale with IEEE division, by a tensor on the
input's device: PyTorch may turn a division by a Python number into a
multiplication by its reciprocal, which can move a code that sits on a
rounding tie. The ADC step ``lsb`` is a constant, and XLA rewrites the
reference's ``p / lsb`` as ``p * (1 / lsb)`` with the float32 reciprocal;
the ADC here multiplies by that same reciprocal (``inv_lsb``), so noisy
partial sums (multiples of 1/8) land on the reference's codes.

Gradients follow the reference's: ``round`` has none, so the codes are
constants of the backward pass and only the scales ``xs * ws`` carry it
(through the abs-max of the inputs and of the weights). The floors at
1e-8 and the split of signed inputs are ``torch.maximum``, which splits
the gradient of a tie in halves as ``jnp.maximum`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CrossbarNumerics:
    """Numeric configuration of one resistive MVM crossbar fabric."""

    in_bits: int = 8          # DAC resolution (input bit-serial width)
    w_bits: int = 8           # conductance levels per device pair (signed)
    adc_bits: int = 8         # ADC resolution per source line read-out
    rows_per_xbar: int = 512  # physical rows: K tile accumulated post-ADC
    ideal: bool = False       # True: skip quantization entirely (float matmul)

    @property
    def w_levels(self) -> int:
        return 2 ** (self.w_bits - 1) - 1

    @property
    def in_levels(self) -> int:
        return 2 ** self.in_bits - 1

    @property
    def full_scale(self) -> float:
        """ADC full-scale range: one active bit-plane over a full tile."""
        return float(self.rows_per_xbar * self.w_levels)

    @property
    def lsb(self) -> float:
        return self.full_scale / (2 ** self.adc_bits - 1)

    @property
    def inv_lsb(self) -> float:
        """float32 reciprocal of the float32 ADC step: what the ADC
        multiplies by."""
        return float(np.float32(1.0) / np.float32(self.lsb))


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, for an exact division; a fill
    on the device, so no copy from the host waits for the stream."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_inputs(x: torch.Tensor, cfg: CrossbarNumerics):
    """DAC input quantization: unsigned uniform over [0, max|x|].

    Returns (codes int32 [.., K], scale float32 0-dim tensor). Negative
    inputs clip to code 0; signed activations go through
    ``crossbar_matmul_signed_ref``."""
    x = x.float()
    x_max = torch.maximum(x.abs().max(), _const(1e-8, x))
    scale = x_max / _const(cfg.in_levels, x)
    codes = torch.clamp(torch.round(x.detach() / scale.detach()), 0,
                        cfg.in_levels)
    return codes.to(torch.int32), scale


def quantize_weights(w: torch.Tensor, cfg: CrossbarNumerics):
    """Symmetric weight quantization to signed conductance codes
    (float32, integer-valued) and their float32 0-dim scale."""
    w = w.float()
    w_max = torch.maximum(w.abs().max(), _const(1e-8, w))
    scale = w_max / _const(cfg.w_levels, w)
    codes = torch.clamp(torch.round(w.detach() / scale.detach()),
                        -cfg.w_levels, cfg.w_levels)
    return codes, scale


def apply_conductance_noise(wq: torch.Tensor, w_noise,
                            cfg: CrossbarNumerics) -> torch.Tensor:
    """Add a ``[K, N]`` conductance-code perturbation and clip to the code
    range; ``None`` is the clean path and returns ``wq`` untouched."""
    if w_noise is None:
        return wq
    return torch.clamp(wq + w_noise.float(), -cfg.w_levels, cfg.w_levels)


def _adc(partial: torch.Tensor, cfg: CrossbarNumerics) -> torch.Tensor:
    """ADC transfer function on one partial sum (integer domain):
    clip to the full scale, quantize to ``adc_bits`` mid-tread by a
    multiplication with the float32 reciprocal of the step."""
    fs = cfg.full_scale
    inv_lsb = _const(cfg.inv_lsb, partial)
    lsb = _const(cfg.lsb, partial)
    return torch.round(torch.clamp(partial, -fs, fs) * inv_lsb) * lsb


def crossbar_matmul_quantized_plain(xq: torch.Tensor, wq: torch.Tensor,
                                    cfg: CrossbarNumerics) -> torch.Tensor:
    """Plain version of the bit-serial crossbar kernel on codes.

    xq: [M, K] int32 DAC codes (bits at and above ``in_bits`` are not
    read); wq: [K, N] float32 signed conductance codes. Per
    ``rows_per_xbar`` K tile and per input bit: the 0/1 plane times the
    codes, the ADC, shift and add within the tile; then the digital add
    across tiles, in tile order. Returns the integer-domain [M, N]
    float32 sum (the caller rescales)."""
    r = cfg.rows_per_xbar
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=xq.device)
    for t0 in range(0, xq.shape[1], r):            # digital cross-tile add
        xq_t, wq_t = xq[:, t0:t0 + r], wq[t0:t0 + r]
        tile = torch.zeros_like(acc)
        for b in range(cfg.in_bits):               # bit-serial DAC cycles
            plane = ((xq_t >> b) & 1).float()
            tile = tile + _adc(plane @ wq_t, cfg) * (2.0 ** b)
        acc = acc + tile
    return acc


def check_matmul_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")


def crossbar_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                        cfg: CrossbarNumerics = CrossbarNumerics(),
                        w_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Behavioural crossbar MVM ``y = x @ w`` through DAC/crossbar/ADC.

    x: [M, K] float (clipped at 0), w: [K, N]; ``w_noise``: optional [K, N]
    conductance-code perturbation. Returns [M, N] float32."""
    if cfg.ideal:
        return x.float() @ w.float()
    check_matmul_shapes(x, w)
    xq, xs = quantize_inputs(x, cfg)
    wq, ws = quantize_weights(w, cfg)
    wq = apply_conductance_noise(wq, w_noise, cfg)
    return crossbar_matmul_quantized_plain(xq, wq, cfg) * (xs * ws)


def crossbar_matmul_signed_ref(x: torch.Tensor, w: torch.Tensor,
                               cfg: CrossbarNumerics = CrossbarNumerics(),
                               w_noise: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Signed activations: positive and negative parts driven in two DAC
    passes and recombined digitally; one ``w_noise`` draw serves both."""
    if cfg.ideal:
        return x.float() @ w.float()
    zero = _const(0.0, x)
    pos = crossbar_matmul_ref(torch.maximum(x, zero), w, cfg, w_noise)
    neg = crossbar_matmul_ref(torch.maximum(-x, zero), w, cfg, w_noise)
    return pos - neg
