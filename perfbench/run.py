"""Run one cell of the port's benchmark once, on the card it starts on.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout. The cells, metrics and bounds are in
``BENCHMARK.json``; the rest lies under ``perfbench/`` (``harness.py``).
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and what the profiler saw. The last
line of standard output is the result as one JSON object; the last lines
of standard error are the numbers compared with the reference, each
beside its limit. Exits non-zero, printing no result, where no card is
there, where the program's package is not in the checkout, or where the
process has loaded JAX or the JAX package by the time the window closes.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(names=None) -> list:
    """The top-level names among ``names`` (default: ``sys.modules``) that
    are JAX or the JAX package, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(BANNED))


def plain(x):
    """``x`` with every float that is not finite written as a string."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # this folder's modules are reached as ``perfbench.*``, never as
    # top-level names (``tokens``, ``weights`` ...)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache inside the checkout, at a fixed path
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch

    from perfbench import harness

    harness.log(f"imports {time.perf_counter() - T0:.3f} s")

    cell = harness.Cell.load(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.spec["chips"]:
        print(f"perfbench: {args.workload} needs {cell.spec['chips']} "
              f"CUDA device(s); this machine has {cards}", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T0, cell=cell)
    found = banned_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
