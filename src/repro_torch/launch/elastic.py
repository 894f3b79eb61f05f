"""Elastic scaling: resume a checkpoint onto a different mesh.

The counterpart of ``repro.launch.elastic``. Checkpoints are stored
device-agnostic (the whole tree on the host), so re-sharding is a restore
with the new mesh's shardings: each rank keeps its blocks of every leaf
(``CheckpointManager.restore`` onto a ``DeviceMesh``). ``reshard`` is the
library entry; the CLI runs under ``torchrun`` (one process per rank):

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.elastic \
      --arch internlm2-1.8b --ckpt-dir /tmp/ckpt --mesh 1x2 --steps 3 \
      --dist-backend gloo --device cpu

Training continues from the last atomic checkpoint with the data order of
an uninterrupted run (the token stream is indexed by step).
"""
from __future__ import annotations

import argparse
import os

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..distributed.sharding import optimizer_shardings, param_shardings
from ..models import build
from ..models.common import InitKey
from ..optim import adamw_init
from .mesh import PartitionSpec as P, make_lm_mesh


def reshard(ckpt_dir: str, arch: str, mesh, *, smoke: bool = True,
            model_cfg=None):
    """Restore the latest checkpoint onto ``mesh`` (a ``DeviceMesh``).
    Returns (params, opt_state, step) as DTensors holding this rank's
    blocks, or (None, None, None). ``model_cfg`` replaces the registry's
    config for ``arch``."""
    cfg = model_cfg or get_config(arch, smoke=smoke)
    params_like = build(cfg).init(InitKey.abstract())
    opt_like = adamw_init(params_like)
    p_spec = param_shardings(params_like, cfg, mesh)
    m_spec = optimizer_shardings(p_spec, params_like, mesh)
    o_spec = {"m": m_spec, "v": m_spec, "step": P()}
    tree, step = CheckpointManager(ckpt_dir).restore(
        {"params": params_like, "opt": opt_like}, mesh=mesh,
        shardings={"params": p_spec, "opt": o_spec})
    if tree is None:
        return None, None, None
    return tree["params"], tree["opt"], step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mesh", default="",
                    help="DxM; empty = every rank on 'data'")
    ap.add_argument("--steps", type=int, default=0,
                    help="continue training this many extra steps")
    ap.add_argument("--dist-backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
    else:
        d, m = n, 1
    mesh = make_lm_mesh((d, m), ("data", "model"),
                        backend=args.dist_backend, device=args.device)
    params, _, step = reshard(args.ckpt_dir, args.arch, mesh)
    if params is None:
        raise SystemExit("no checkpoint found")
    from .. import _tree
    n_params = sum(x.numel() for x in _tree.leaves(params))
    if mesh.get_rank() == 0:
        print(f"resharded step-{step} checkpoint onto {d}x{m} mesh; "
              f"{n_params:,} params")
    if args.steps:
        from .train import TrainConfig, train
        cfg = TrainConfig(arch=args.arch, steps=step + 1 + args.steps,
                          ckpt_dir=args.ckpt_dir, mesh=f"{d}x{m}",
                          dist_backend=args.dist_backend,
                          device=args.device)
        out = train(cfg)
        if mesh.get_rank() == 0:
            print(out)


if __name__ == "__main__":
    main()
