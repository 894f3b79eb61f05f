"""Shared set-up of ``tests/test_torch_lm_mesh*.py``: the reference's
initial parameters, token batches and 3-step runs, the port's unsharded
runs of the same, and the spawn of the gloo ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import _lm_mesh_ranks as ranks
from repro.configs import get_config as jx_get_config
from repro.data.tokens import TokenStream as JxTokenStream
from repro.launch.steps import make_train_step as jx_make_train_step
from repro.models import build as jx_build
from repro.optim import AdamWConfig as JxAdamWConfig
from repro.optim import adamw_init as jx_adamw_init
from repro_torch import _tree
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw_init

DEADLINE = 240.0


def _jx_config(arch):
    cfg = dataclasses.replace(jx_get_config(arch, smoke=True),
                              dtype="float32")
    if arch == "grok-1-314b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    return cfg


def reference_runs(tmp) -> dict:
    """Per arch: the reference's run ("ref") and the port's unsharded run
    ("port") from the reference's parameters on its batches, each (losses,
    final parameter leaves); "path": the npz the ranks load."""
    out, arrays = {}, {}
    for arch in ranks.ARCHS:
        jm = jx_build(_jx_config(arch))
        jp = jm.init(jax.random.key(0))
        leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
        arrays[f"{arch}/n_leaves"] = np.asarray(len(leaves))
        arrays.update({f"{arch}/p{i}": a for i, a in enumerate(leaves)})
        stream = JxTokenStream(_jx_config(arch).vocab, ranks.BATCH,
                               ranks.SEQ, 0)
        batches = [{k: np.asarray(v) for k, v in stream.batch_at(s).items()}
                   for s in range(ranks.STEPS)]
        for s, b in enumerate(batches):
            arrays.update({f"{arch}/b{s}/{k}": v for k, v in b.items()})
        jstep = jax.jit(jx_make_train_step(jm, JxAdamWConfig(**ranks.OPT)))
        opt, losses = jx_adamw_init(jp), []
        for b in batches:
            jp, opt, m = jstep(jp, opt, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[arch] = {"ref": (losses, [np.asarray(x)
                                      for x in jax.tree.leaves(jp)])}
    path = str(tmp / "cases.npz")
    np.savez(path, **arrays)
    for arch in ranks.ARCHS:
        params, batches = ranks.load_case(path, arch)
        step = make_train_step(build(ranks.model_config(arch)),
                               AdamWConfig(**ranks.OPT))
        opt, losses = adamw_init(params), []
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        out[arch]["port"] = (losses, [x.numpy()
                                      for x in _tree.leaves(params)])
    out["path"] = path
    return out


def spawn_ranks(fn, world, tmp_path_factory, name, *args):
    rdv = str(tmp_path_factory.mktemp(name) / "rendezvous")
    return spawn(fn, world, (rdv,) + args, deadline=DEADLINE)
