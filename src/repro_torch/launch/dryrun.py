"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on meta
tensors over a fake 256- or 512-rank process group.

The counterpart of ``repro.launch.dryrun``. For each cell it builds the
production mesh (16x16 single-pod or 2x16x16 multi-pod, ``launch.mesh.
make_production_mesh``), constructs abstract params / optimizer state /
inputs / caches (the models on the meta device: nothing is allocated),
places them by the rules of ``repro_torch.distributed.sharding`` as
DTensors whose local shards are meta tensors, then runs one step under
``analysis.opcount.OpCounter``. A step that runs proves the distribution
config coherent on the port: every parameter / activation / cache spec
places, and every op of the step has a way to run on the shards.

Where the reference compiles, the port runs the step on meta shards:
FLOPs, bytes and collectives are counted per device as each rank's local
ops run, and memory is read from the storage they make:
``argument_bytes`` is the local shards of every input, ``temp_bytes``
the peak of storage the step allocated on top of them, ``live_bytes`` =
argument + temp - alias, as the reference computes it. ``alias_bytes``
is 0 and ``live_bytes`` is argument + temp: the training step's AdamW
writes the parameters and moments over its arguments (on the meta shards
as on the card: ``optim.adamw``), so the new ones make no storage, and
the other steps donate nothing (the caller holds the parameters and the
caches while the step builds the new ones). The roofline
uses ``analysis.roofline.H100`` (NVIDIA's data sheet, not a measurement),
and each record says so (``hw``).

The fake group becomes the process's default group, so the dry run owns
its process: run it as its own command (or a subprocess).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \
      --out results/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from .. import _tree
from ..analysis.opcount import OpCounter
from ..analysis.roofline import model_flops, roofline_terms
from ..configs import ARCHS, SHAPES, cells, get_config
from ..distributed.sharding import (activation_rules, batch_shardings,
                                    cache_shardings, local_block,
                                    optimizer_shardings, param_shardings,
                                    placements, spec_leaves)
from ..models import build
from ..models.common import InitKey, dtype_of
from ..optim import AdamWConfig, adamw_init
from .mesh import PartitionSpec as P, make_production_mesh, set_mesh
from .steps import (batch_struct, make_prefill_step, make_serve_step,
                    make_train_step)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _meta_leaf(like, spec, mesh):
    """A DTensor of ``like``'s shape and dtype placed by ``spec`` whose
    local shard is a meta tensor of this rank's block."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    full = torch.empty(tuple(like.shape), dtype=like.dtype, device="meta")
    local = local_block(full, pl, mesh).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _meta_tree(tree, specs, mesh):
    flat, tdef = _tree.flatten(tree)
    return tdef.unflatten(_meta_leaf(x, s, mesh) for x, s in
                          zip(flat, spec_leaves(specs)))


def _struct_tree(struct: dict) -> dict:
    """``batch_struct``'s (shape, dtype) pairs as meta tensors."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in struct.items()}


def _local_bytes(tree) -> int:
    total = 0
    for x in _tree.leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if type(x).__name__ == "DTensor" else x
            total += _nbytes(x)
    return total


@dataclasses.dataclass
class Lowered:
    """One cell ready to run: the step and its abstract arguments (built
    by ``build_args`` on the meta device)."""
    step: object
    build_args: object
    mesh: object

    def run(self):
        """Run the step once on the meta shards under an ``OpCounter``.
        Returns (counter, memory dict)."""
        args = self.build_args()
        arg_bytes = _local_bytes(args)
        with set_mesh(self.mesh), OpCounter() as counter:
            out = self.step(*args)
        out_bytes = _local_bytes(out)
        del args, out
        mem = {"argument_bytes": arg_bytes,
               "output_bytes": out_bytes,
               "temp_bytes": counter.peak_bytes,
               "alias_bytes": 0,        # the eager step donates nothing
               "live_bytes": arg_bytes + counter.peak_bytes}
        return counter, mem


def lower_cell(arch: str, shape_name: str, mesh, *, remat: str | None = None,
               overrides: dict | None = None, seq_parallel: bool = False,
               smoke: bool = False, spec=None):
    """Returns (lowered, cfg, meta) for one cell on ``mesh``. ``smoke``
    takes the architecture's smoke config; ``spec`` (a ``ShapeSpec``)
    replaces ``SHAPES[shape_name]`` (a cell cut to a smaller batch or
    sequence)."""
    cfg = get_config(arch, smoke=smoke)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    spec = spec or SHAPES[shape_name]
    model = build(cfg)
    rules = activation_rules(cfg, mesh, seq_parallel=seq_parallel)

    params_s = model.init(InitKey.abstract())
    p_spec = param_shardings(params_s, cfg, mesh)
    meta = {"arch": arch, "shape": shape_name, "kind": spec.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    b = spec.global_batch

    if spec.kind == "train":
        opt_s = adamw_init(params_s)
        m_spec = optimizer_shardings(p_spec, params_s, mesh)
        o_spec = {"m": m_spec, "v": m_spec, "step": P()}
        batch_s = _struct_tree(batch_struct(cfg, b, spec.seq_len))
        b_spec = batch_shardings(mesh, "train", batch_s)
        step = make_train_step(model, AdamWConfig(), rules,
                               shardings=(mesh, p_spec, m_spec))

        def build_args():
            return (_meta_tree(params_s, p_spec, mesh),
                    _meta_tree(opt_s, o_spec, mesh),
                    _meta_tree(batch_s, b_spec, mesh))
        n_tokens = b * spec.seq_len
    elif spec.kind == "prefill":
        # the prefill step reads no labels (the reference's jit drops the
        # unused argument)
        batch_s = _struct_tree({k: v for k, v in batch_struct(
            cfg, b, spec.seq_len).items() if k != "labels"})
        b_spec = batch_shardings(mesh, "prefill", batch_s)
        step = make_prefill_step(model, rules)

        def build_args():
            return (_meta_tree(params_s, p_spec, mesh),
                    _meta_tree(batch_s, b_spec, mesh))
        n_tokens = b * spec.seq_len
    else:  # decode
        caches_s = model.init_caches(b, spec.seq_len, device="meta")
        c_spec = cache_shardings(caches_s, cfg, mesh)
        tok_s = torch.empty((b, 1), dtype=torch.int32, device="meta")
        t_spec = batch_shardings(mesh, "decode", tok_s)
        pos_s = torch.empty((), dtype=torch.int32, device="meta")
        if cfg.is_encdec:
            enc_s = _enc_struct(model, cfg, b)
            e_spec = batch_shardings(mesh, "decode", enc_s)
            step = make_serve_step(model, rules, with_enc=True)

            def build_args():
                return (_meta_tree(params_s, p_spec, mesh),
                        _meta_tree(caches_s, c_spec, mesh),
                        _meta_leaf(tok_s, t_spec, mesh),
                        _meta_leaf(pos_s, P(), mesh),
                        _meta_tree(enc_s, e_spec, mesh))
        else:
            step = make_serve_step(model, rules)

            def build_args():
                return (_meta_tree(params_s, p_spec, mesh),
                        _meta_tree(caches_s, c_spec, mesh),
                        _meta_leaf(tok_s, t_spec, mesh),
                        _meta_leaf(pos_s, P(), mesh))
        n_tokens = b  # one new token per sequence
    meta["n_tokens"] = n_tokens
    return Lowered(step, build_args, mesh), cfg, meta


def _enc_struct(model, cfg, b: int):
    """The cross-attention KVs of an encoder output [B, T, D], as meta
    tensors (the reference's ``eval_shape`` of ``_cross_kvs``)."""
    params = model.init(InitKey.abstract())
    frames = torch.empty((b, cfg.encoder.n_frames, cfg.d_model),
                         dtype=dtype_of(cfg.dtype), device="meta")
    with torch.no_grad():
        return model._cross_kvs(params, model.encode(params, frames))


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             remat: str | None = None, overrides: dict | None = None,
             seq_parallel: bool = False, mesh=None, smoke: bool = False,
             spec=None) -> dict:
    """One cell's record. ``mesh``: an explicit ``DeviceMesh`` (over the
    process's fake group) for ablations; the default is the production
    mesh."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    t0 = time.time()
    lowered, cfg, meta = lower_cell(arch, shape_name, mesh, remat=remat,
                                    overrides=overrides,
                                    seq_parallel=seq_parallel, smoke=smoke,
                                    spec=spec)
    t1 = time.time()
    counter, mem = lowered.run()
    t2 = time.time()
    mc = counter.cost()
    mf = model_flops(cfg, meta["n_tokens"], meta["kind"]) / n_dev
    rt = roofline_terms(mc, model_flops=mf)

    rec = dict(meta)
    rec.update({
        "mesh": _mesh_name(mesh),
        "n_devices": n_dev,
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),     # the fake step's run
        "memory": mem,
        "roofline": rt.as_dict(),
        "precision": mc.precision,
        "hw": "H100 SXM data sheet (modeled, not measured)",
        "collective_counts": dict(mc.collective_counts),
        "collective_bytes_by_kind": counter.collective_bytes_by_kind(),
        "while_trips": mc.while_trips[:8],
        "ok": True,
    })
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        for a, s, skip, reason in cells(ARCHS):
            todo.append((a, s, skip, reason))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        sk = [c for c in cells([args.arch]) if c[1] == args.shape][0]
        todo.append(sk)

    if args.multi_pod == "both":
        # one process holds one fake group: each layout runs in its own
        for mp in (False, True):
            _run_child(argv, mp)
        return
    mp = args.multi_pod == "on"
    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done.add((r.get("arch"), r.get("shape"), r.get("mesh")))

    n_fail = 0
    for arch, shape, skip, reason in todo:
        mesh_name = "2x16x16" if mp else "16x16"
        key = (arch, shape, mesh_name)
        if key in done:
            print(f"[skip-done] {arch} x {shape} @ {mesh_name}")
            continue
        if skip:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "ok": True, "skipped": True, "reason": reason}
            print(f"[SKIP] {arch} x {shape}: {reason}")
        else:
            print(f"[dryrun] {arch} x {shape} @ {mesh_name} ...",
                  flush=True)
            # train steps default to full remat, as the reference's
            remat = args.remat
            if remat is None and SHAPES[shape].kind == "train":
                remat = "full"
            try:
                rec = run_cell(arch, shape, multi_pod=mp, remat=remat)
                print(summary(rec), flush=True)
            except Exception as e:
                n_fail += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"  FAIL: {type(e).__name__}: {e}")
                traceback.print_exc()
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    print("all cells ok")


def _run_child(argv, multi_pod: bool) -> None:
    """Rerun this CLI with ``--multi-pod on|off`` in a new process."""
    import subprocess
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--multi-pod")
    argv[i + 1] = "on" if multi_pod else "off"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                       + argv)
    if r.returncode:
        raise SystemExit(r.returncode)


def summary(rec: dict) -> str:
    """The one-line report of a record."""
    r, m = rec["roofline"], rec["memory"]
    return (f"  ok: run={rec['compile_s']}s "
            f"args={m['argument_bytes']/2**30:.3f}GiB/dev "
            f"live={m['live_bytes']/2**30:.3f}GiB/dev "
            f"flops={r['flops']:.4e} "
            f"compute={r['compute_s']*1e3:.3f}ms "
            f"memory={r['memory_s']*1e3:.3f}ms "
            f"collective={r['collective_s']*1e3:.3f}ms "
            f"dominant={r['dominant']} useful={r['useful_ratio']:.3f} "
            f"(H100 data sheet, modeled)")


if __name__ == "__main__":
    main()
