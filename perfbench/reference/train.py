"""Follow the first training steps of a decoder LM in plain float32.

The model is an embedding lookup, ``n_layers`` blocks of one
architecture (``internlm2.block``), a final RMS norm,
an untied output head and next-token cross entropy; the optimizer is
``adamw``. The step is computed a layer at a time: the forward keeps
only each block's input, and the backward recomputes one block under
autograd, takes its gradients and frees it, so the reference fits on
the card beside nothing else at the benchmark's full size.

Parameters are a flat ``{path: tensor}``; a path under ``main.sub0.``
holds one slice a layer on its leading axis. A "leaf" below is one such
slice (``path[i]``), or a whole unstacked parameter.
"""
from __future__ import annotations

import time

import torch

from . import adamw
from .common import cross_entropy, float32_products, mm, rms_norm

STACK = "main.sub0."


def leaf_names(path: str, t: torch.Tensor) -> list:
    if path.startswith(STACK):
        return [f"{path}[{i}]" for i in range(t.shape[0])]
    return [path]


def leaf_norms(tree: dict, scale: float = 1.0) -> dict:
    """``{leaf: its L2 norm}`` of a flat tree, each times ``scale``."""
    out = {}
    for path, t in tree.items():
        parts = t.unbind(0) if path.startswith(STACK) else [t]
        for name, s in zip(leaf_names(path, t), parts):
            out[name] = float(torch.linalg.vector_norm(s.float())) * scale
    return out


def change_norms(after: dict, before: dict) -> dict:
    """``{leaf: ||after - before||}``, a leaf at a time."""
    out = {}
    for path, t in after.items():
        b = before[path]
        pairs = zip(t.unbind(0), b.unbind(0)) if path.startswith(STACK) \
            else [(t, b)]
        for name, (x, y) in zip(leaf_names(path, t), pairs):
            out[name] = float(torch.linalg.vector_norm(x.float() - y.float()))
    return out


def loss_and_grads(arch, m: dict, P: dict, batch: dict, prec: str) -> tuple:
    """(the batch's mean loss, ``{path: float32 gradient}``)."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    eps = m.get("norm_eps", 1e-5)
    stacked = [k for k in P if k.startswith(STACK)]
    n = P[stacked[0]].shape[0]

    def layer(i: int, grad: bool) -> dict:
        return {k[len(STACK):]: (P[k][i].detach().requires_grad_()
                                 if grad else P[k][i]) for k in stacked}

    with torch.no_grad():
        xs = [P["embed.tok"][tokens]]
        for i in range(n):
            xs.append(arch.block(layer(i, False), xs[-1], m, prec))
    grads = {}
    with torch.enable_grad():
        top = {k: P[k].detach().requires_grad_()
               for k in ("final_ln", "embed.head")}
        h = xs[n].detach().requires_grad_()
        logits = mm("bsd,dv->bsv", rms_norm(h, top["final_ln"], eps),
                    top["embed.head"], prec)
        loss = cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1))
        *gs, dx = torch.autograd.grad(loss, [*top.values(), h])
    del logits
    grads.update(zip(top, gs))
    for k in stacked:
        grads[k] = torch.empty_like(P[k])
    for i in reversed(range(n)):
        L = layer(i, True)
        x = xs[i].detach().requires_grad_()
        with torch.enable_grad():
            out = arch.block(L, x, m, prec)
            *gs, dx = torch.autograd.grad(out, [*L.values(), x], dx)
        for k, g in zip(stacked, gs):
            grads[k][i] = g
        xs[i + 1] = None
    tok = torch.zeros_like(P["embed.tok"])
    tok.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed.tok"] = tok
    return float(loss.detach()), grads


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def follow(arch, m: dict, weights: dict, batches: list, hp: adamw.Hyper,
           prec: str = "f32", note=None) -> dict:
    """Train from ``weights`` (as drawn, in their stored dtypes) over
    ``batches``, one step each. Returns the readings the benchmark
    compares: ``loss`` and ``gnorm`` (the gradients' global norm before
    clipping) of every step, ``grad`` (each leaf's gradient at step 1,
    before clipping) and ``delta`` (each leaf's change over all the
    steps).
    ``note``, if given, is called with a line of each step's seconds."""
    float32_products()
    dev = next(iter(weights.values())).device
    stored = {k: w.dtype for k, w in weights.items()}
    P = {k: w.to(torch.float32, copy=True) for k, w in weights.items()}
    M = {k: torch.zeros_like(p) for k, p in P.items()}
    V = {k: torch.zeros_like(p) for k, p in P.items()}
    stacked = {k for k in P if k.startswith(STACK)}
    out = {"loss": [], "gnorm": []}
    for t, batch in enumerate(batches, start=1):
        t0 = _clock(dev)
        loss, grads = loss_and_grads(arch, m, P, batch, prec)
        t1 = _clock(dev)
        norm = adamw.global_norm(grads, stacked)
        out["loss"].append(loss)
        out["gnorm"].append(norm)
        if t == 1:
            out["grad"] = leaf_norms(grads)
        adamw.update(P, grads, M, V, t, hp, stored, stacked)
        del grads
        if note is not None:
            note(f"reference step {t}: loss and gradients "
                 f"{t1 - t0:.3f} s, update {_clock(dev) - t1:.3f} s")
    out["delta"] = change_norms(P, weights)
    return out
