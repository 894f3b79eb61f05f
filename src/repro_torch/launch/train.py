"""Fault-tolerant training driver, on one card.

The counterpart of ``repro.launch.train``. Config-driven: picks any
assigned architecture (full or smoke-reduced) and runs the train loop with
step-atomic checkpointing, deterministic step-indexed data (exact resume)
and crash retry. ``--mesh`` takes "" or "1x1": the sharding rules that
spread a model over more cards come with ROADMAP §1 item 3.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from .. import _tree
from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenStream
from ..models import build
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from .steps import make_train_step


@dataclasses.dataclass
class TrainConfig:
    arch: str = "internlm2-1.8b"
    smoke: bool = True
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 3e-4
    seed: int = 0
    mesh: str = ""              # "" or "1x1": one card
    accum_steps: int = 1        # gradient-accumulation microbatches
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    max_retries: int = 2        # crash retry-from-checkpoint budget
    device: str = "cuda"


def check_mesh(spec: str) -> None:
    """One card only: "" or "1x1"."""
    if spec not in ("", "1x1"):
        raise NotImplementedError(
            f"mesh {spec!r}: training runs on one card (mesh '' or '1x1'); "
            f"the sharding rules for a larger mesh come with ROADMAP §1 "
            f"item 3")


def train(cfg: TrainConfig, *, hooks=None,
          model_cfg: ModelConfig | None = None) -> dict:
    """Run the loop; returns final metrics. ``hooks`` (test seam): dict with
    optional ``on_step(step, metrics)`` and ``fault(step)`` callables --
    ``fault`` raising simulates a node failure mid-run. ``model_cfg``
    replaces the registry's config for ``cfg.arch``."""
    hooks = hooks or {}
    check_mesh(cfg.mesh)
    dev = resolve_device(cfg.device)
    mcfg = model_cfg or get_config(cfg.arch, smoke=cfg.smoke)
    model = build(mcfg)

    params = model.init(cfg.seed, device=dev)
    opt_state = adamw_init(params)
    stream = TokenStream(mcfg.vocab, cfg.batch, cfg.seq, cfg.seed)
    step_fn = make_train_step(model, AdamWConfig(lr=cfg.lr),
                              accum_steps=cfg.accum_steps)

    ckpt = CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every) \
        if cfg.ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored, at = ckpt.restore({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = at + 1
            print(f"[train] resumed from step {at}")

    metrics = {}
    retries = 0
    step = start
    t0 = time.time()
    while step < cfg.steps:
        try:
            if "fault" in hooks:
                hooks["fault"](step)
            batch = _tree.tree_map(lambda x: x.to(dev),
                                   stream.batch_at(step))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t0) / max(step - start + 1, 1)
                print(f"[train] step {step} loss {m['loss']:.4f} "
                      f"gnorm {m['gnorm']:.3f} {dt*1e3:.0f} ms/step",
                      flush=True)
            if "on_step" in hooks:
                hooks["on_step"](step, metrics)
            if ckpt is not None:
                ckpt.maybe_save(step, {"params": params, "opt": opt_state})
            step += 1
        except (RuntimeError, ValueError):
            raise
        except Exception as e:   # simulated node failure -> restart
            retries += 1
            if ckpt is None or retries > cfg.max_retries:
                raise
            print(f"[train] step {step} failed ({e}); "
                  f"restoring (retry {retries}/{cfg.max_retries})")
            restored, at = ckpt.restore({"params": params, "opt": opt_state})
            if restored is None:
                params = model.init(cfg.seed, device=dev)
                opt_state = adamw_init(params)
                step = 0
            else:
                params, opt_state = restored["params"], restored["opt"]
                step = at + 1
    if ckpt is not None:
        ckpt.maybe_save(cfg.steps, {"params": params, "opt": opt_state})
        ckpt.finalize()
    return {k: float(v) for k, v in metrics.items()} | {"last_step": step - 1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        if f.type in ("bool", bool):
            ap.add_argument(f"--{f.name.replace('_', '-')}",
                            action="store_true", default=f.default)
        else:
            ap.add_argument(f"--{f.name.replace('_', '-')}",
                            type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    out = train(cfg)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
