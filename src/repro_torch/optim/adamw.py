"""AdamW with global-norm clipping: plain functions on trees of tensors.

The counterpart of ``repro.optim.adamw``. Not a ``torch.optim.Optimizer``:
``adamw_update`` returns new parameters and a new state, as the reference
does. The arithmetic is the reference's, in float32: the moments are
float32, each parameter keeps its dtype (bf16 stays bf16), ``step`` is a
0-dim int32 tensor on the parameters' device, and the bias corrections
are float32 powers of the step.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100


def adamw_init(params) -> dict:
    """Zero float32 moments shaped like ``params`` and step 0."""
    flat = _tree.leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": _tree.tree_map(zeros, params),
            "v": _tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _clip_scale(grads, max_norm: float):
    """(the global-norm clipping scale, the norm before scaling)."""
    flat = _tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat))
    # a true division by a tensor: PyTorch computes a Python number over
    # a tensor as the number times the tensor's reciprocal
    scale = torch.clamp_max(
        torch.full_like(gn, max_norm) / torch.clamp_min(gn, 1e-9), 1.0)
    return scale, gn


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before scaling). Leaves come back in their dtype promoted with
    float32, as the reference's product with its float32 scale."""
    scale, gn = _clip_scale(grads, max_norm)
    return _tree.tree_map(lambda g: _clipped(g, scale), grads), gn


def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step with linear warm-up. Returns (new params, new state,
    the gradients' global norm before clipping). Each leaf is clipped as
    it is updated (``clip_by_global_norm``'s values), so no clipped copy of
    the whole gradient tree is held at once."""
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    warmup = torch.full((), float(max(cfg.warmup, 1)), device=step.device)
    lr = cfg.lr * torch.clamp_max(step.float() / warmup, 1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = _clipped(g, scale).float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    flat_p, tdef = _tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tdef.flatten_up_to(grads), tdef.flatten_up_to(state["m"]),
        tdef.flatten_up_to(state["v"]))]
    new_p = tdef.unflatten(o[0] for o in out)
    new_m = tdef.unflatten(o[1] for o in out)
    new_v = tdef.unflatten(o[2] for o in out)
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
