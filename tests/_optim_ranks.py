"""Rank function of the DTensor cases of ``tests/test_torch_optim.py`` and
``tests/test_torch_adamw.py``: it runs in a process that
``repro_torch.launch.mesh.spawn`` starts, on gloo ranks joined by a file
rendezvous. Imports no JAX."""
import types

import torch

from repro_torch import _tree
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               reset_update_paths, update_paths)
from repro_torch.optim import adamw as pt_adamw

CFG = AdamWConfig(lr=1e-2, warmup=1, clip_norm=0.5, weight_decay=0.1)


def _tree_of(device, seed: int = 0) -> tuple:
    """(params, grads): a bf16 matrix whose moments split its rows over
    "data", a float32 vector replicated, a float32 matrix whose moments
    split its columns over "model"."""
    gen = torch.Generator().manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=gen)
    params = {"w": draw(8, 6).bfloat16(), "b": draw(5), "u": draw(4, 6)}
    grads = {k: draw(*p.shape).to(p.dtype) for k, p in params.items()}
    return (_tree.tree_map(lambda t: t.to(device), params),
            _tree.tree_map(lambda t: t.to(device), grads))


def dtensor_step(rank: int, world: int, rdv: str, shape,
                 device: str) -> dict:
    """One ``adamw_update`` on DTensors over a ``shape`` mesh (parameters
    and gradients replicated, moments split as ``_tree_of`` says) and on
    the same leaves as plain tensors. Returns what rank 0 checks: the paths
    counted, the blocks the wrappers got and whether the norm was reduced,
    both norms, the largest error of each result leaf over max|plain|, and
    whether the inputs kept their values and their moments' storage."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_lm_mesh
    mesh = make_lm_mesh(shape, ("data", "model"), backend="gloo",
                        device=device, init_method=f"file://{rdv}",
                        rank=rank)
    try:
        params, grads = _tree_of(device)
        state = adamw_init(params)
        want_p, want_s, want_gn = adamw_update(
            _tree.tree_map(torch.clone, params), grads,
            _tree.tree_map(torch.clone, state), CFG)
        rep = [Replicate(), Replicate()]
        split = {"w": [Shard(0), Replicate()], "b": rep,
                 "u": [Replicate(), Shard(1)]}
        dist_t = lambda tree, pl: {k: distribute_tensor(t, mesh, pl(k))
                                   for k, t in tree.items()}
        d_p, d_g = (dist_t(t, lambda k: rep) for t in (params, grads))
        d_s = {"m": dist_t(state["m"], split.get),
               "v": dist_t(state["v"], split.get),
               "step": distribute_tensor(state["step"], mesh, rep)}
        before = [t.full_tensor().clone() for t in _tree.leaves((d_p, d_s))]
        ptrs = [t.to_local().data_ptr()
                for t in _tree.leaves((d_s["m"], d_s["v"]))]
        seen = {}
        real = pt_adamw._kernel

        def norm(grads_, max_norm, reduce=None):
            seen["norm"] = ([tuple(g.shape) for g in grads_],
                            reduce is not None)
            return real.adamw_norm(grads_, max_norm, reduce)

        def update(ps, *rest):
            seen["update"] = [tuple(p.shape) for p in ps]
            return real.adamw_update(ps, *rest)
        pt_adamw._kernel = types.SimpleNamespace(adamw_norm=norm,
                                                 adamw_update=update)
        reset_update_paths()
        try:
            got_p, got_s, got_gn = adamw_update(d_p, d_g, d_s, CFG)
        finally:
            pt_adamw._kernel = real
        errs = []
        for a, b in zip(_tree.leaves((got_p, got_s["m"], got_s["v"])),
                        _tree.leaves((want_p, want_s["m"], want_s["v"]))):
            a, b = a.full_tensor().float(), b.float()
            errs.append(float((a - b).abs().max() / b.abs().max()))
        unchanged = all(torch.equal(a, b.full_tensor()) for a, b in
                        zip(before, _tree.leaves((d_p, d_s))))
        same_storage = ptrs == [t.to_local().data_ptr() for t in
                                _tree.leaves((got_s["m"], got_s["v"]))]
        return dict(paths=update_paths(), seen=seen, errs=errs,
                    gn=(float(got_gn), float(want_gn)), unchanged=unchanged,
                    same_storage=same_storage,
                    step=int(got_s["step"].full_tensor()))
    finally:
        dist.destroy_process_group()
