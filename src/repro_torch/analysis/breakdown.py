"""Per-op HBM/FLOP breakdown of a dry-run cell: the counterpart of
``repro.analysis.breakdown``.

The reference lists every charged HLO instruction of the compiled
per-device module; here the rows are the ops one rank ran in the dry
run's fake step (``analysis.opcount.OpCounter``), one row per (op,
operand shapes, result shapes) with the number of runs as the multiplier.

Usage (the CLI starts the dry run's fake process group, so it owns its
process):
  PYTHONPATH=src python -m repro_torch.analysis.breakdown --arch yi-34b \
      --shape decode_32k [--multi-pod] [--top 30] [--collectives]
"""
from __future__ import annotations

import argparse

from .opcount import _COLLECTIVES


def instruction_rows(counter):
    """[(bytes, flops, mult, op, description)] for every charged op of an
    ``OpCounter``; the rows sum to its ``cost()`` totals."""
    return counter.rows()


def main(argv=None) -> None:
    from ..launch.dryrun import lower_cell
    from ..launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--collectives", action="store_true")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    remat = args.remat
    if remat is None and args.shape.startswith("train"):
        remat = "full"
    lowered, cfg, meta = lower_cell(args.arch, args.shape, mesh, remat=remat,
                                    seq_parallel=args.seq_parallel)
    counter, _ = lowered.run()
    rows = instruction_rows(counter)
    rows.sort(key=lambda r: r[0], reverse=True)
    tot_b = sum(r[0] for r in rows)
    tot_f = sum(r[1] for r in rows)
    print(f"total bytes {tot_b/1e9:.2f} GB   total product flops "
          f"{tot_f/1e12:.3f} TFLOP   ({len(rows)} charged op shapes)")
    print(f"{'GB':>9} {'GFLOP':>9} {'x':>5}  op")
    for b, f, m, op, line in rows[:args.top]:
        print(f"{b/1e9:9.3f} {f/1e9:9.1f} {m:5d}  {line[:140]}")
    if args.collectives:
        print("\ncollectives:")
        kinds = set(_COLLECTIVES.values())
        for b, f, m, op, line in rows:
            if op in kinds:
                print(f"{b/1e9:9.3f}GB x{m:4d}  {line[:130]}")


if __name__ == "__main__":
    main()
