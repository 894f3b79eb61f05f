"""Fault-tolerant training driver, on one card or over a (data, model)
mesh.

The counterpart of ``repro.launch.train``. Config-driven: picks any
assigned architecture (full or smoke-reduced) and runs the train loop with
step-atomic checkpointing, deterministic step-indexed data (exact resume)
and crash retry.

``--mesh DxM`` trains over a ``DeviceMesh`` of D x M ranks (``data``,
``model``) of the running process group, which the caller starts
(``torchrun``, or ``launch.mesh.spawn``) on ``--dist-backend``: the
parameters are DTensors placed by ``param_shardings``, the AdamW moments
by ``optimizer_shardings`` (ZeRO-1) and the batch by ``batch_shardings``,
with the activation rules installed (the reference's ``train.py:80-88``).
Every rank draws the same parameters and batches from the seed and keeps
its block. ``--mesh ""`` is one card: no process group, no DTensor.

``--trace PATH`` turns the port's telemetry on for the run and writes the
span trees it kept (the last 256) as JSONL at the end
(``telemetry.export_trace``): each step's ``train.step`` tree
(``launch/steps.py``), and the loop's own ``train.batch`` (the batch's
copy to the device and its placement), ``train.log`` (the metrics read
back to the host, a synchronise every ``log_every`` steps) and
``train.checkpoint`` (``maybe_save``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --mesh 2x2 --dist-backend gloo [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 3 --batch 2 --seq 32 --trace /tmp/train_spans.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from .. import _tree
from .. import telemetry as tel
from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenStream
from ..distributed import sharding
from ..models import build
from ..models.common import InitKey
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from .mesh import PartitionSpec as P, make_lm_mesh, set_mesh
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
    mesh: str = ""              # "DxM" over the running group; "": one card
    dist_backend: str = "nccl"  # the group's collective backend (a mesh)
    accum_steps: int = 1        # gradient-accumulation microbatches
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    max_retries: int = 2        # crash retry-from-checkpoint budget
    device: str = "cuda"


def build_mesh(spec: str, backend: str = "nccl", device="cuda"):
    """The (data, model) ``DeviceMesh`` of ``"DxM"`` over the running
    group (started from the environment when none runs); None for
    ``""``."""
    if not spec:
        return None
    d, m = (int(x) for x in spec.split("x"))
    return make_lm_mesh((d, m), ("data", "model"), backend=backend,
                        device=device)


class _Placer:
    """Where the trees of one run live: as they are (one card), or as
    DTensors placed by the rules on ``mesh``."""

    def __init__(self, mesh, mcfg: ModelConfig, model, stream):
        self.mesh = mesh
        self.rules = self.shardings = None
        self.restore_kw = {}
        if mesh is None:
            return
        shapes = model.init(InitKey.abstract())
        self.p_spec = sharding.param_shardings(shapes, mcfg, mesh)
        m_spec = sharding.optimizer_shardings(self.p_spec, shapes, mesh)
        self.o_spec = {"m": m_spec, "v": m_spec, "step": P()}
        self.b_spec = sharding.batch_shardings(mesh, "train",
                                               stream.batch_at(0))
        self.rules = sharding.activation_rules(mcfg, mesh)
        self.shardings = (mesh, self.p_spec, m_spec)
        self.restore_kw = {"mesh": mesh, "shardings": {
            "params": self.p_spec, "opt": self.o_spec}}

    def state(self, params):
        """(params, a fresh optimizer state), placed."""
        opt = adamw_init(params)
        if self.mesh is None:
            return params, opt
        return (sharding.distribute(params, self.p_spec, self.mesh),
                sharding.distribute(opt, self.o_spec, self.mesh))

    def batch(self, batch):
        if self.mesh is None:
            return batch
        return sharding.distribute(batch, self.b_spec, self.mesh)

    def context(self):
        return set_mesh(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()


def _grow_segments() -> None:
    """Have the CUDA caching allocator grow its segments in place from now
    on, unless ``PYTORCH_CUDA_ALLOC_CONF`` already decides it. AdamW's
    per-leaf float32 temporaries split fixed segments: at rwkv6-3b's full
    size (a 734M-element leaf, 2.7 GiB a temporary) the update was refused
    2.7 GiB with 60 GiB live and 16-17.5 GiB reserved and unused, at a
    batch of 4 x 512 and of 2 x 512 alike."""
    if "expandable_segments" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF",
                                               ""):
        return
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def train(cfg: TrainConfig, *, hooks=None,
          model_cfg: ModelConfig | None = None) -> dict:
    """Run the loop; returns final metrics. ``hooks`` (test seam): dict with
    optional ``on_step(step, metrics)``, ``fault(step)`` and
    ``on_end(params, opt_state)`` callables -- ``fault`` raising simulates
    a node failure mid-run. ``model_cfg`` replaces the registry's config
    for ``cfg.arch``."""
    hooks = hooks or {}
    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        _grow_segments()
    mesh = build_mesh(cfg.mesh, cfg.dist_backend, dev)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mcfg = model_cfg or get_config(cfg.arch, smoke=cfg.smoke)
    model = build(mcfg)
    stream = TokenStream(mcfg.vocab, cfg.batch, cfg.seq, cfg.seed)
    placer = _Placer(mesh, mcfg, model, stream)

    params, opt_state = placer.state(model.init(cfg.seed, device=dev))
    step_fn = make_train_step(model, AdamWConfig(lr=cfg.lr), placer.rules,
                              accum_steps=cfg.accum_steps,
                              shardings=placer.shardings)

    ckpt = CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every) \
        if cfg.ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored, at = ckpt.restore({"params": params, "opt": opt_state},
                                    **placer.restore_kw)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = at + 1
            print(f"[train] resumed from step {at}")

    metrics = {}
    retries = 0
    step = start
    t0 = time.time()
    with placer.context():
        while step < cfg.steps:
            try:
                if "fault" in hooks:
                    hooks["fault"](step)
                with tel.span("train.batch", step=step):
                    batch = placer.batch(_tree.tree_map(
                        lambda x: x.to(dev), stream.batch_at(step)))
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                if step % cfg.log_every == 0:
                    with tel.span("train.log", step=step):
                        m = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t0) / max(step - start + 1, 1)
                    print(f"[train] step {step} loss {m['loss']:.4f} "
                          f"gnorm {m['gnorm']:.3f} {dt*1e3:.0f} ms/step",
                          flush=True)
                if "on_step" in hooks:
                    hooks["on_step"](step, metrics)
                if ckpt is not None:
                    with tel.span("train.checkpoint", step=step):
                        ckpt.maybe_save(step, {"params": params,
                                               "opt": opt_state})
                step += 1
            except (RuntimeError, ValueError):
                raise
            except Exception as e:   # simulated node failure -> restart
                retries += 1
                if ckpt is None or retries > cfg.max_retries:
                    raise
                print(f"[train] step {step} failed ({e}); "
                      f"restoring (retry {retries}/{cfg.max_retries})")
                restored, at = ckpt.restore(
                    {"params": params, "opt": opt_state},
                    **placer.restore_kw)
                if restored is None:
                    params, opt_state = placer.state(
                        model.init(cfg.seed, device=dev))
                    step = 0
                else:
                    params, opt_state = restored["params"], restored["opt"]
                    step = at + 1
    if ckpt is not None:
        ckpt.maybe_save(cfg.steps, {"params": params, "opt": opt_state})
        ckpt.finalize()
    if "on_end" in hooks:
        hooks["on_end"](params, opt_state)
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry; export the recorded span trees "
                         "as JSONL to PATH at exit")
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    if args.trace:
        tel.enable()
    out = train(cfg)
    if args.trace:
        n = tel.export_trace(args.trace)
        print(f"telemetry: wrote {n} span trees to {args.trace}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
