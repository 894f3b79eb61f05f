"""End-to-end LM training driver: ~100M-param model, a simulated fault.

The counterpart of the reference's ``examples/lm_train.py``: the
production train loop (checkpointing, deterministic resume, crash retry)
on a ~100M-parameter InternLM2-family config. It trains, fails at a step
(a simulated node failure, by default half-way), resumes from the latest
atomic checkpoint and checks the loss curve continues.

  PYTHONPATH=src python -m repro_torch.examples.lm_train --steps 200 \
      [--fault-at N] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import shutil
import tempfile

from ..configs import get_config
from ..launch.train import TrainConfig, train
from ..models.config import ModelConfig


def lm_100m() -> ModelConfig:
    """~100M-param GQA decoder (internlm2 family, scaled down)."""
    base = get_config("internlm2-1.8b")
    return dataclasses.replace(
        base, name="internlm2-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=8192)


class _Fault(Exception):
    pass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fault-at", type=int, default=-1,
                    help="simulate a node failure at this step (-1: half "
                         "way, 0: off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fault_at = args.steps // 2 if args.fault_at < 0 else args.fault_at

    cfg100 = lm_100m()
    n = cfg100.param_count()
    print(f"model: {cfg100.name}, {n/1e6:.1f}M params, device "
          f"{args.device}")

    ckpt_dir = tempfile.mkdtemp(prefix="lm100m_")
    try:
        losses, seen = [], []
        fired = {"done": False}

        def fault(step):
            if fault_at and step == fault_at and not fired["done"]:
                fired["done"] = True
                raise _Fault(f"simulated node failure at step {step}")

        def on_step(step, metrics):
            seen.append(step)
            losses.append(float(metrics["loss"]))

        out = train(TrainConfig(arch=cfg100.name, smoke=False,
                                steps=args.steps, batch=args.batch,
                                seq=args.seq, ckpt_dir=ckpt_dir,
                                ckpt_every=max(1, min(25, args.steps // 4)),
                                log_every=20, device=args.device),
                    hooks={"on_step": on_step, "fault": fault},
                    model_cfg=cfg100)
        tail = losses[-10:]
        ce0, ce1 = losses[0], sum(tail) / len(tail)
        print(f"\nfinal: loss {ce0:.3f} -> {ce1:.3f} over "
              f"{out['last_step'] + 1} steps "
              f"(random = {math.log(cfg100.vocab):.3f})")
        if ce1 >= ce0:
            raise RuntimeError("no learning")
        if fired["done"]:
            back = seen[seen.index(fault_at - 1) + 1]
            print(f"fault injected at step {fault_at}; resumed from the "
                  f"checkpoint of step {back - 1} at step {back}: OK")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
