"""Readings from which a cell's limits are set, at the cell's own size.

  python3 perfbench/tools/readings.py --workload <name> \
      --seeds 1,2,... [--control-seeds a,b,c] [--fault-seeds a,b,c] \
      [--dtype float32] [--layers n] [--out readings.jsonl]

In one process, for each seed: the program's first steps from the seed's
weights and batches (set-up as a run makes it, without the window), then
the float32 reference over the same steps; the compared numbers of the
program against the reference are the sound readings. For each control
seed the reference computed with float8 (e4m3) operands (the control)
against the float32 one; for each fault seed the program with half of
every batch left out, and with every step returning its state unchanged.
``--dtype`` and ``--layers`` run both sides with the configuration's
parameters in another dtype or with fewer layers: a witness beside the
cell, not the cell. Prints one JSON line a reading, with each side's
losses and gradient norms of the steps, and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def half_batch(step):
    """The step on the first half of every batch (the mean over it)."""
    return lambda p, o, b: step(p, o, {k: v[: v.shape[0] // 2]
                                       for k, v in b.items()})


def unchanged(step):
    """The step's metrics, with the state handed back as it came."""
    def broken(p, o, b):
        return p, o, step(p, o, b)[2]
    return broken


FAULTS = {"half_batch": half_batch, "unchanged": unchanged}


def free(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--dtype", default="")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import compare, harness

    seeds = lambda s: [int(x) for x in s.split(",") if x]
    cell = harness.Cell.load(args.workload)
    if args.dtype or args.layers:
        cell.model = dict(cell.model, dtype=args.dtype or cell.model["dtype"],
                          n_layers=args.layers or cell.model["n_layers"])
        cell.specs = cell.arch.param_specs(cell.model)
    dev = torch.device("cuda")
    rows = []

    def emit(kind, seed, got, ref, seconds):
        values, where = compare.numbers(got, ref)
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "dtype": cell.model["dtype"],
               "layers": cell.model["n_layers"], "values": values,
               "where": where, "loss": [got["loss"], ref["loss"]],
               "gnorm": [got["gnorm"], ref["gnorm"]], "seconds": seconds}
        rows.append(row)
        print(json.dumps(row), flush=True)

    every = sorted(set(seeds(args.seeds) + seeds(args.control_seeds)
                       + seeds(args.fault_seeds)))
    for seed in every:
        batches = cell.batches(seed, dev)
        t0 = time.perf_counter()
        state, step, got = cell.program(seed, dev, batches)
        del state, step
        free(dev)
        t1 = time.perf_counter()
        ref = cell.reference(seed, dev, batches)
        free(dev)
        t2 = time.perf_counter()
        if seed in seeds(args.seeds):
            emit("program", seed, got, ref,
                 {"program": t1 - t0, "reference": t2 - t1})
        if seed in seeds(args.control_seeds):
            ctl = cell.reference(seed, dev, batches, "fp8")
            free(dev)
            emit("control_fp8", seed, ctl, ref,
                 {"control": time.perf_counter() - t2})
        if seed in seeds(args.fault_seeds):
            for name, hook in FAULTS.items():
                t3 = time.perf_counter()
                state, step, bad = cell.program(seed, dev, batches, hook)
                del state, step
                free(dev)
                emit(f"fault_{name}", seed, bad, ref,
                     {"program": time.perf_counter() - t3})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
