"""Rank functions of ``tests/test_torch_recurrence.py``: smoke rwkv6-3b and
recurrentgemma-9b AdamW steps on a (data, model) mesh of gloo CPU ranks
(``launch.mesh.spawn``), and the same steps on one rank. Imports no JAX."""
import numpy as np

from _lm_mesh_ranks import OPT, _join, model_config
from repro_torch import _tree
from repro_torch.data import TokenStream
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import PartitionSpec as P, set_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
STEPS, BATCH, SEQ = 2, 4, 16


def _start(arch: str):
    cfg = model_config(arch)
    stream = TokenStream(cfg.vocab, BATCH, SEQ)
    return (cfg, build(cfg).init(0, device="cpu"),
            [stream.batch_at(i) for i in range(STEPS)])


def one_rank(arch: str):
    """(losses, final parameters as numpy) of the steps without a mesh."""
    cfg, params, batches = _start(arch)
    step = make_train_step(build(cfg), AdamWConfig(**OPT))
    opt, losses = adamw_init(params), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, [x.detach().numpy() for x in _tree.leaves(params)]


def sharded_steps(arch: str, mesh):
    cfg, params, batches = _start(arch)
    p_spec = S.param_shardings(params, cfg, mesh)
    m_spec = S.optimizer_shardings(p_spec, params, mesh)
    step = make_train_step(build(cfg), AdamWConfig(**OPT),
                           S.activation_rules(cfg, mesh),
                           shardings=(mesh, p_spec, m_spec))
    opt = S.distribute(adamw_init(params),
                       {"m": m_spec, "v": m_spec, "step": P()}, mesh)
    params = S.distribute(params, p_spec, mesh)
    b_spec = S.batch_shardings(mesh, "train", batches[0])
    losses = []
    with set_mesh(mesh):
        for b in batches:
            params, opt, m = step(params, opt, S.distribute(b, b_spec, mesh))
            losses.append(float(m["loss"]))
    return losses, [np.asarray(S.full(x).detach().numpy())
                    for x in _tree.leaves(params)]


def run_meshes(rank: int, world: int, rdv: str, meshes):
    """Both architectures on every mesh; rank 0 returns {(arch, mesh):
    (losses, params)}, the others their losses."""
    out = {}
    for shape in meshes:
        mesh = _join(rank, rdv, shape)
        for arch in ARCHS:
            losses, full = sharded_steps(arch, mesh)
            out[(arch, "x".join(map(str, shape)))] = (
                losses, full if rank == 0 else None)
    return out
