"""AdamW with global-norm clipping: plain functions on trees of tensors.

The counterpart of ``repro.optim.adamw``. Not a ``torch.optim.Optimizer``:
``adamw_update`` returns the parameters and a state, as the reference
does. The arithmetic is the reference's, in float32: the moments are
float32, each parameter keeps its dtype (bf16 stays bf16), ``step`` is a
0-dim int32 tensor on the parameters' device, and the bias corrections
are float32 powers of the step.

The step runs the wrappers of ``kernels.optim`` on the leaves, or on a
mesh on each rank's blocks of them. On the card they launch the
hand-written kernels and update the parameters and moments **in place**:
the tensors handed in are the tensors handed back, now updated, as the
reference's jitted step donates its parameters and moments
(``repro.launch.train``, ``donate_argnums=(0, 1)``). A caller on the card
that reads the old tree afterwards clones it first; a dry run's meta
tensors are updated in place too, as the card's, so its memory count is
the card's. On CPU tensors the wrappers run the plain version
(``kernels.optim.ref``) on clones, so the step builds new trees and leaves
its inputs as they were.

DTensors (the ZeRO-1 mesh path of ``launch.steps``): each leaf's
parameter and gradient are moved to its moments' placements, the
wrappers run on the local blocks, and the norm's partial sums of squares
are summed over the mesh between its two launches; a leaf replicated over
a mesh dimension counts in the norm only on that dimension's first rank.
The parameters come back in the moments' placements. ``update_paths()``
counts the calls by path.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _tree
from ..kernels.optim import ops as _kernel
from ..kernels.optim import ref as _plain

# ``adamw_update`` calls since the last reset, by path: the kernels (every
# leaf a plain CUDA tensor), the plain version (no leaf on CUDA), DTensors
# (the kernels or the plain version on each rank's blocks)
_UPDATE_PATHS = {"kernel": 0, "plain": 0, "dtensor": 0}


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


def update_paths() -> dict:
    """``{"kernel": n, "plain": n, "dtensor": n}``: ``adamw_update`` calls
    by the path they took since the last reset."""
    return dict(_UPDATE_PATHS)


def reset_update_paths() -> None:
    for key in _UPDATE_PATHS:
        _UPDATE_PATHS[key] = 0


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before scaling). Leaves come back in their dtype promoted with
    float32, as the reference's product with its float32 scale."""
    scale, gn = _plain.clip_scale(_tree.leaves(grads), max_norm)
    return _tree.tree_map(lambda g: _plain.clipped(g, scale), grads), gn


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _path(leaves: list) -> str:
    dtensor = [_is_dtensor(t) for t in leaves]
    if leaves and all(dtensor):
        return "dtensor"
    if any(dtensor):
        raise ValueError("adamw_update: some leaves are DTensors and some "
                         "are not")
    cuda = [t.is_cuda for t in leaves]
    if leaves and all(cuda):
        return "kernel"
    if any(cuda):
        raise ValueError("adamw_update: some leaves are on CUDA and some "
                         "are not")
    return "plain"


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def _blocks(flat_p, flat_g, flat_m, flat_v, copy: bool) -> tuple:
    """Each DTensor leaf's local blocks, contiguous, in its moments'
    placements, copies where ``copy``: (p, g, m, v blocks, the gradient
    blocks the norm counts, the mesh, a function from the updated blocks
    back to DTensors)."""
    from torch.distributed.tensor import DTensor
    mesh = flat_m[0].device_mesh
    coord = mesh.get_coordinate()
    out = ([], [], [], [], [])
    like = []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if any(t.device_mesh != mesh for t in (p, g, m, v)):
            raise ValueError("adamw_update: the leaves must share a mesh")
        pl = m.placements
        if v.placements != pl:
            raise ValueError("adamw_update: a leaf's two moments differ in "
                             "placement")
        p, g = (t if t.placements == pl else t.redistribute(mesh, pl)
                for t in (p, g))
        like.append((p, m, v))
        for i, t in enumerate((p, g, m, v)):
            loc = t.to_local()
            out[i].append(loc.clone(memory_format=torch.contiguous_format)
                          if copy and i != 1 else loc.contiguous())
        # a block repeated over a mesh dimension is counted once
        first = all(c == 0 for c, q in zip(coord, pl) if q.is_replicate())
        out[4].append(out[1][-1] if first else out[1][-1].new_empty(0))

    def wrap(ps, ms, vs):
        back = lambda loc, t: t if loc is t.to_local() else \
            DTensor.from_local(loc, mesh, t.placements, run_check=False,
                               shape=t.shape, stride=t.stride())
        return ([back(loc, t[k]) for loc, t in zip(blocks, like)]
                for k, blocks in enumerate((ps, ms, vs)))
    return (*out, mesh, wrap)


def _all_reduce(mesh):
    """A function summing a tensor in place over every rank of ``mesh``."""
    import torch.distributed as dist

    def reduce(t):
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                dist.all_reduce(t, group=mesh.get_group(d))
    return reduce


def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step with linear warm-up. Returns (params, state, the
    gradients' global norm before clipping). Each leaf is clipped as it is
    updated (``clip_by_global_norm``'s values), so no clipped copy of the
    whole gradient tree is held at once.

    On the card the parameters and moments are updated in place and handed
    back (the module's note): four launches a step where the tree has two
    dtype pairs, no host synchronisation. On the CPU new trees."""
    flat_p, tdef = _tree.flatten(params)
    flat_g, flat_m, flat_v = (tdef.flatten_up_to(t)
                              for t in (grads, state["m"], state["v"]))
    path = _path(flat_p + flat_g + flat_m + flat_v)
    _UPDATE_PATHS[path] += 1
    step = state["step"] + 1
    warmup = torch.full((), float(max(cfg.warmup, 1)), device=step.device)
    lr = cfg.lr * torch.clamp_max(step.float() / warmup, 1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr, b1c, b2c = (_local(t) for t in (lr, b1c, b2c))
    copy = _local(flat_m[0]).device.type == "cpu"
    if path == "dtensor":
        ps, gs, ms, vs, counted, mesh, wrap = _blocks(flat_p, flat_g, flat_m,
                                                      flat_v, copy)
        reduce = _all_reduce(mesh)
    else:
        ps, ms, vs = ([t.clone(memory_format=torch.contiguous_format)
                       for t in ts] if copy else ts
                      for ts in (flat_p, flat_m, flat_v))
        gs = counted = flat_g
        reduce = wrap = None
    scale, gnorm = _kernel.adamw_norm(counted, cfg.clip_norm, reduce)
    _kernel.adamw_update(ps, gs, ms, vs, scale, lr, b1c, b2c, cfg)
    if path == "kernel":
        return params, {"m": state["m"], "v": state["v"],
                        "step": step}, gnorm
    if wrap is not None:
        ps, ms, vs = wrap(ps, ms, vs)
    return tdef.unflatten(ps), {"m": tdef.unflatten(ms),
                                "v": tdef.unflatten(vs),
                                "step": step}, gnorm
