"""Rank functions of ``tests/test_torch_lm_mesh*.py``: each runs in a
process that ``repro_torch.launch.mesh.spawn`` starts, on gloo CPU ranks
joined by a file rendezvous. Imports no JAX."""
import dataclasses
import os
import shutil

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import (PartitionSpec as P, make_lm_mesh,
                                     preferred_mesh, set_mesh)
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import build
from repro_torch.models.common import InitKey
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ("internlm2-1.8b", "grok-1-314b", "deepseek-v3-671b")
STEPS, BATCH, SEQ = 3, 4, 16
# eps 1e-3 keeps AdamW's first steps a smooth function of the gradient
# (tests/test_torch_lm_launch.py): at 1e-8 an element within rounding of
# 0 moves by up to 2 * lr between two summation orders
OPT = dict(lr=1e-2, warmup=1, eps=1e-3)


def model_config(arch: str):
    """The smoke config at f32. grok-1's smoke MoE gets 3 experts, which
    a model axis of 2 does not divide: the expert-inner TP that grok-1's
    8 experts get on 16 (deepseek-v3's 4 divide it: EP)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if arch == "grok-1-314b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    return cfg


def _join(rank: int, rdv: str, shape) -> object:
    return make_lm_mesh(shape, ("data", "model"), backend="gloo",
                        device="cpu", init_method=f"file://{rdv}",
                        rank=rank, timeout=60.0)


def load_case(path: str, arch: str):
    """(initial params, batches) of ``arch`` from the npz the test
    wrote: the reference's parameters and token batches."""
    cfg = model_config(arch)
    with np.load(path) as f:
        n = int(f[f"{arch}/n_leaves"])
        leaves = [torch.from_numpy(f[f"{arch}/p{i}"]) for i in range(n)]
        batches = [{k: torch.from_numpy(f[f"{arch}/b{s}/{k}"])
                    for k in ("tokens", "labels")} for s in range(STEPS)]
    tdef = _tree.flatten(build(cfg).init(InitKey.abstract()))[1]
    return tdef.unflatten(leaves), batches


def sharded_steps(arch: str, mesh, params, batches):
    """``STEPS`` AdamW steps of the smoke model on ``mesh`` from
    ``params`` over ``batches``: (losses, final params gathered)."""
    cfg = model_config(arch)
    model = build(cfg)
    p_spec = S.param_shardings(params, cfg, mesh)
    m_spec = S.optimizer_shardings(p_spec, params, mesh)
    o_spec = {"m": m_spec, "v": m_spec, "step": P()}
    b_spec = S.batch_shardings(mesh, "train", batches[0])
    step = make_train_step(model, AdamWConfig(**OPT),
                           S.activation_rules(cfg, mesh),
                           shardings=(mesh, p_spec, m_spec))
    opt = S.distribute(adamw_init(params), o_spec, mesh)
    params = S.distribute(params, p_spec, mesh)
    losses = []
    with set_mesh(mesh):
        for b in batches:
            params, opt, m = step(params, opt, S.distribute(b, b_spec, mesh))
            losses.append(float(m["loss"]))
    full = [S.full(x).numpy() for x in _tree.leaves(params)]
    return losses, full


def run_meshes(rank: int, world: int, rdv: str, path: str, meshes):
    """Every arch on every mesh of ``world`` ranks; rank 0 returns
    {(arch, mesh): (losses, params)}, the others their losses."""
    out = {}
    for shape in meshes:
        mesh = _join(rank, rdv, shape)
        for arch in ARCHS:
            params, batches = load_case(path, arch)
            losses, full = sharded_steps(arch, mesh, params, batches)
            out[(arch, "x".join(map(str, shape)))] = (
                losses, full if rank == 0 else None)
    return out


class NodeFailure(Exception):
    """A simulated node failure: ``train()`` restores and retries."""


def fail_once_at(step: int):
    """A ``fault`` hook that raises ``NodeFailure`` the first time the
    loop reaches ``step``."""
    fired = []

    def fault(s):
        if s == step and not fired:
            fired.append(s)
            raise NodeFailure(f"simulated failure at step {s}")
    return fault


def run_elastic(rank: int, world: int, rdv: str, ckpt_root: str):
    """train() on 2x1 saving at step 3; the checkpoint resharded onto
    1x2 and onto one card, each continuing to step 6; an uninterrupted
    2x1 run; a 2x1 run that fails at step 4 and retries from its step-3
    checkpoint; and restores onto 2-D meshes. Returns what each rank
    saw."""
    arch = "internlm2-1.8b"
    cfg = model_config(arch)
    base = dict(arch=arch, batch=BATCH, seq=SEQ, log_every=100,
                dist_backend="gloo", device="cpu")

    def run(losses, hooks=None, **kw):
        return train(TrainConfig(**(base | kw)), model_cfg=cfg, hooks={
            "on_step": lambda s, m: losses.append((s, float(m["loss"]))),
            **(hooks or {})})
    _join(rank, rdv, (2, 1))
    ck = os.path.join(ckpt_root, "ckpt")
    first, full, grown, single, faulted = [], [], [], [], []
    run(first, mesh="2x1", steps=4, ckpt_dir=ck, ckpt_every=3)
    run(full, mesh="2x1", steps=6)
    run(faulted, {"fault": fail_once_at(4)}, mesh="2x1", steps=6,
        ckpt_dir=ck + "_fault", ckpt_every=3)
    torch.distributed.barrier()
    if rank == 0:
        shutil.copytree(ck, ck + "_one")
    torch.distributed.barrier()
    from repro_torch.launch.elastic import reshard
    mesh12 = _join(rank, rdv, (1, 2))
    params, opt, step = reshard(ck, arch, mesh12, model_cfg=cfg)
    tok = params["embed"]["tok"].to_local()
    blocks = {"step": step, "tok": tuple(tok.shape),
              "tok_storage": tok.untyped_storage().nbytes(),
              "placements": str(params["embed"]["tok"].placements)}
    run(grown, mesh="1x2", steps=6, ckpt_dir=ck, ckpt_every=100)
    run(single, mesh="", steps=6, ckpt_dir=ck + "_one", ckpt_every=100)
    restore = _restore_blocks(rank, rdv, ckpt_root)
    tp = preferred_mesh(cfg, 2, backend="gloo", device="cpu")
    return {"first": first, "full": full, "grown": grown, "single": single,
            "faulted": faulted, "resharded": blocks, "restore": restore,
            "preferred": tuple(tp.mesh.shape)}


def _restore_blocks(rank: int, rdv: str, root: str):
    """A tree saved by rank 0, restored onto 2x1 and 1x2 meshes with
    row, column and replicated specs: each rank's local blocks."""
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint

    d = os.path.join(root, "blocks")
    tree = {"a": torch.arange(24, dtype=torch.float32).reshape(6, 4),
            "b": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "c": torch.arange(6, dtype=torch.float32)}
    if rank == 0:
        save_checkpoint(d, 3, tree)
    torch.distributed.barrier()
    like = _tree.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                          tree)
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = _join(rank, rdv, shape)
        specs = {"a": P("data", "model"), "b": P(None, "model"),
                 "c": P()}
        got, step = CheckpointManager(d).restore(like, mesh=mesh,
                                                 shardings=specs)
        out["x".join(map(str, shape))] = (step, {
            k: (v.to_local().numpy(), str(v.placements),
                v.to_local().untyped_storage().nbytes())
            for k, v in got.items()})
    return out


DECODE_ARCHS = ("internlm2-1.8b", "deepseek-v3-671b")
DECODE_B, DECODE_CAP, DECODE_STEPS = 4, 16, 3


def decode_tokens(cfg):
    g = torch.Generator().manual_seed(5)
    return [torch.randint(0, cfg.vocab, (DECODE_B, 1), generator=g,
                          dtype=torch.int32) for _ in range(DECODE_STEPS)]


def plain_decode(arch: str) -> list:
    """The unsharded decode steps' logits (the seed's weights)."""
    from repro_torch.launch.steps import make_serve_step
    cfg = model_config(arch)
    model = build(cfg)
    params = model.init(0, device="cpu")
    caches = model.init_caches(DECODE_B, DECODE_CAP, device="cpu")
    step = make_serve_step(model)
    out = []
    for i, tok in enumerate(decode_tokens(cfg)):
        logits, caches = step(params, caches, tok, i)
        out.append(logits.numpy())
    return out


def run_decode(rank: int, world: int, rdv: str, shape):
    """The decode steps of ``plain_decode`` with the parameters and the
    caches placed by the rules on ``shape`` (the caches split over their
    slots where the KV heads or latents do not divide 'model')."""
    from repro_torch.launch.steps import make_serve_step
    mesh = _join(rank, rdv, shape)
    out = {}
    for arch in DECODE_ARCHS:
        cfg = model_config(arch)
        model = build(cfg)
        params = model.init(0, device="cpu")
        caches = model.init_caches(DECODE_B, DECODE_CAP, device="cpu")
        c_spec = S.cache_shardings(caches, cfg, mesh)
        params = S.distribute(params, S.param_shardings(params, cfg, mesh),
                              mesh)
        caches = S.distribute(caches, c_spec, mesh)
        step = make_serve_step(model, S.activation_rules(cfg, mesh))
        logits = []
        with set_mesh(mesh):
            for i, tok in enumerate(decode_tokens(cfg)):
                tok = S.place(tok, S.batch_shardings(mesh, "decode", tok),
                              mesh)
                lg, caches = step(params, caches, tok, i)
                logits.append(S.full(lg).numpy())
        out[arch] = (logits, [str(c.placements) for c in
                              _tree.leaves(caches)])
    return out
