"""Plain PyTorch version of the AdamW kernels (``csrc/adamw.cu``): the
arithmetic of ``optim.adamw_update`` composed from PyTorch operations.

The wrappers (``ops.py``) run it on CPU tensors; ``chip_smoke.py`` holds
the kernels against it on the card. In float32, each operation rounded on
its own:

  * ``clip_scale``: the gradients' global L2 norm (``sum_squares``: each
    leaf's squares summed in float32, the leaves' sums added in order) and
    the clipping scale min(1, max_norm / max(gn, 1e-9)), a true division
    (``scale_of``);
  * ``adamw_leaf``: one leaf's clipped gradient, moments and parameter.
"""
from __future__ import annotations

import torch


def clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g`` in its dtype promoted with the scale's, times the scale."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def sum_squares(grads: list) -> torch.Tensor:
    """The gradient leaves' sum of squares, a 0-dim float32 tensor."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def scale_of(ss: torch.Tensor, max_norm: float) -> tuple:
    """(the clipping scale, the norm) of a sum of squares ``ss``."""
    gn = torch.sqrt(ss)
    # a true division by a tensor: PyTorch computes a Python number over
    # a tensor as the number times the tensor's reciprocal
    scale = torch.clamp_max(
        torch.full_like(gn, max_norm) / torch.clamp_min(gn, 1e-9), 1.0)
    return scale, gn


def clip_scale(grads: list, max_norm: float) -> tuple:
    """(the global-norm clipping scale, the norm before scaling) of the
    gradient leaves ``grads``."""
    return scale_of(sum_squares(grads), max_norm)


def adamw_leaf(p, g, m, v, scale, lr, b1c, b2c, cfg) -> tuple:
    """(new p in its dtype, new m, new v) of one leaf: ``g`` clipped by
    ``scale``, the float32 moments ``m``, ``v`` and ``p`` moved by AdamW at
    learning rate ``lr`` with bias corrections ``b1c``, ``b2c`` (0-dim
    float32 tensors) and ``cfg``'s b1, b2, eps and weight_decay."""
    g = clipped(g, scale).float()
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    u = u + cfg.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype), m, v
