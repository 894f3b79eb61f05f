"""Plain float32 AdamW with global-norm clipping and linear warm-up.

One step t (from 1), for every parameter p with gradient g:
    n     = the L2 norm of all gradients together
    g     = g * min(1, clip_norm / n)
    m     = b1 m + (1 - b1) g
    v     = b2 v + (1 - b2) g^2
    u     = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
    p     = p - lr min(t / warmup, 1) u
(Loshchilov and Hutter, arXiv:1711.05101: decoupled weight decay, scaled
by the learning rate.)

Departure: the configuration states the dtype each parameter is stored
in (bf16 weights, float32 norms), so after each update a
parameter is rounded to that dtype, as the trained model holds it. The
arithmetic, the moments and the gradients are float32.

A stacked tensor (one slice a layer on its leading axis) is updated a
slice at a time, so the temporaries stay one layer large.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100


def slices(t: torch.Tensor, stacked: bool) -> list:
    """A stacked ``t``'s slices along its leading axis; else ``[t]``."""
    return list(t.unbind(0)) if stacked else [t]


def global_norm(grads: dict, stacked: set) -> float:
    return math.sqrt(sum(float(torch.sum(g * g)) for k, t in grads.items()
                         for g in slices(t, k in stacked)))


def clip_scale(norm: float, hp: Hyper) -> float:
    return min(1.0, hp.clip_norm / max(norm, 1e-9))


def update(params: dict, grads: dict, m: dict, v: dict, t: int,
           hp: Hyper, stored: dict, stacked: set) -> None:
    """Step ``t`` in place on float32 ``params``, ``m``, ``v``; ``stored``
    maps each path to the dtype its parameter is kept in; ``stacked``
    holds the paths stacked over the layers."""
    scale = clip_scale(global_norm(grads, stacked), hp)
    lr = hp.lr * min(t / max(hp.warmup, 1), 1.0)
    b1c, b2c = 1.0 - hp.b1 ** t, 1.0 - hp.b2 ** t
    for path, p in params.items():
        cut = lambda t: slices(t, path in stacked)
        for ps, gs, ms, vs in zip(cut(p), cut(grads[path]), cut(m[path]),
                                  cut(v[path])):
            g = gs * scale
            ms.mul_(hp.b1).add_(g, alpha=1.0 - hp.b1)
            vs.mul_(hp.b2).add_(g * g, alpha=1.0 - hp.b2)
            u = (ms / b1c) / (torch.sqrt(vs / b2c) + hp.eps) \
                + hp.weight_decay * ps
            ps.copy_((ps - lr * u).to(stored[path]))
