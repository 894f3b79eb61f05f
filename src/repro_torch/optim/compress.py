"""int8 error-feedback gradient compression.

The counterpart of ``repro.optim.compress``: quantize (grad + residual) to
int8 with a per-tensor scale and keep the quantization error as the
residual for the next step. ``torch.round`` rounds half to even, as
``jnp.round`` does. ``compressed_psum`` all-reduces the int8 payload
over a ``launch.mesh.Mesh`` (the reference's over a mesh axis inside
shard_map).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, mesh):
    """All-reduce a gradient tensor in int8 with error feedback over the
    ranks of ``mesh``. Returns (mean_grad, new_residual), as the
    reference's: the codes are summed as int32 (the sum must widen), the
    scales reduced by max, and the decompressed sum divided by the world
    size, a tensor on ``g``'s device."""
    q, scale, new_residual = int8_compress(g, residual)
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=mesh.group)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=mesh.group)
    n = torch.full((), float(mesh.size), dtype=torch.float32,
                   device=g.device)
    return summed.float() * scale_max / n, new_residual
