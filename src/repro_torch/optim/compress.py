"""int8 error-feedback gradient compression.

The counterpart of ``repro.optim.compress``: quantize (grad + residual) to
int8 with a per-tensor scale and keep the quantization error as the
residual for the next step. ``torch.round`` rounds half to even, as
``jnp.round`` does. The reference's ``compressed_psum`` all-reduces the
payload over a mesh axis; its port needs a process group and comes with
the multi-card runtime.
"""
from __future__ import annotations

import torch


def int8_compress(g: torch.Tensor, residual: torch.Tensor):
    """(int8 codes, float32 0-dim scale, float32 residual) of
    ``g + residual``."""
    g = g.float() + residual
    # true divisions by tensors on g's device, as the reference divides
    levels = torch.full((), 127.0, dtype=torch.float32, device=g.device)
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / levels
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_residual = g - q.float() * scale
    return q, scale, new_residual


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
