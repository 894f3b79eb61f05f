"""Plain float32 pieces shared by the architecture references.

Everything here is ordinary PyTorch on float32 tensors. It imports
nothing of the program under test. ``allow_tf32`` is switched off for
matrix products and cuDNN, so a float32 product on the card is a float32
product.

``Precision`` names what the matrix products' operands are rounded to
before the product: ``"f32"`` leaves them as they are (the reference),
``"fp8"`` rounds each operand to float8 e4m3 with one scale a tensor
(its largest magnitude mapped to 448, the format's largest), the
rounding a float8 training recipe applies, and passes the gradient
through unchanged (the control of the benchmark's comparison).
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "fp8")
_E4M3_MAX = 448.0


def float32_products() -> None:
    """Matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    """Forward: the value rounded to e4m3 under a per-tensor scale.
    Backward: the gradient as it comes (straight through)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.abs().amax().clamp_min(1e-30)
        scale = _E4M3_MAX / amax
        q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32)
        return q / scale

    @staticmethod
    def backward(ctx, g):
        return g


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as a matrix product's operand in ``prec``."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _RoundFp8.apply(x)
    raise ValueError(f"precision {prec!r} is none of {PRECISIONS}")


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` with both operands in ``prec``."""
    return torch.einsum(eq, operand(a, prec), operand(b, prec))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the scale is stored as an offset from 1."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] moved one step later in time, zero at step 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy over the labelled positions (labels
    of -1 are not counted). logits [N, V], labels [N]."""
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[:, None])[:, 0]
    return torch.sum((logz - gold) * valid) / valid.sum().clamp_min(1)
