"""What the program's spans cost, and how closely their clock joins the
profiler's, at a cell's own size.

  python3 perfbench/tools/spancost.py --workload <name> --seed <n> \
      [--seconds 2.5] [--rounds 12] [--out spancost.jsonl]

In one process on the card: set-up as a run makes it (no reference), then
short windows of whole steps, unprofiled, with telemetry off and on in
turns (off, on, on, off a round, so that the host's drift over the run
falls on both): on against off, a ratio a round, their median and
quartiles. Then a profiled stretch of ``harness.PROFILED`` steps whose
marker launches each sit inside a host interval read on the wall clock
just before and after the launch: the launch's ``ts`` after the trace's
own ``baseTimeNanoseconds`` against that interval (the join's error), the
base ``spantrace`` finds against the trace's, and ``spantrace``'s
attribution of the same trace (its witness, the share of kernel time
inside the steps' roots, the four metrics beside ``adamw_ms`` and
``model_kernel_ms``). Last, two profiled stretches with the spans
following the profiler and without: the kernels launched a step in each,
which must be equal. Prints one JSON object a reading and writes them to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def profiled_with_hosts(step, box, batches, first, steps):
    """``steps`` profiled steps, a marker before the first and after
    each, the wall clock read around each marker's launch: (the trace's
    events, its ``baseTimeNanoseconds``, [(ns before, ns after)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    hosts = []

    def mark():
        a = time.time_ns()
        torch.cuda._sleep(1)
        hosts.append((a, time.time_ns()))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark()
        for i in range(steps):
            params, opt, _ = step(*box.pop(),
                                  batches[(first + i) % len(batches)])
            box.append((params, opt))
            del params, opt
            mark()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    return data["traceEvents"], data["baseTimeNanoseconds"], hosts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.5)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import devtrace, harness, spantrace
    from repro_torch import telemetry as tel

    rows = []

    def emit(**row):
        row = {"workload": args.workload, "seed": args.seed, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    dev = torch.device("cuda")
    cell = harness.Cell.load(args.workload)
    batches = cell.batches(args.seed, dev)
    state, step, _ = cell.program(args.seed, dev, batches)
    box, at = [state], harness.FIRST
    del state

    ratios, ms = [], {"off": [], "on": []}
    for _ in range(args.rounds):
        got = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            tel.reset()
            (tel.enable if mode == "on" else tel.disable)()
            n, s = harness.timed(step, box, batches, args.seconds, at, dev)
            at += n
            got[mode].append(1e3 * s / n)
        ratios.append(statistics.mean(got["on"])
                      / statistics.mean(got["off"]) - 1.0)
        for mode in got:
            ms[mode] += got[mode]
    tel.disable()
    emit(reading="windows", ms_a_step=ms)
    emit(reading="on_cost", rounds=len(ratios),
         on_over_off_median=statistics.median(ratios),
         on_over_off_quartiles=statistics.quantiles(ratios, n=4),
         off_ms=statistics.median(ms["off"]),
         on_ms=statistics.median(ms["on"]))

    tracer = tel.get_tracer()
    tel.reset()
    n = harness.PROFILED
    events, base, hosts = profiled_with_hosts(step, box, batches, at, n)
    at += n
    tr = devtrace.Trace(events, n)
    marks = spantrace.marker_launches(tr)
    if len(marks) == len(hosts):
        before = [(base + m["ts"] * 1e3 - a) / 1e3
                  for m, (a, _) in zip(marks, hosts)]
        after = [(b - base - (m["ts"] + m["dur"]) * 1e3) / 1e3
                 for m, (_, b) in zip(marks, hosts)]
        emit(reading="join", markers=len(marks),
             inside=sum(x >= 0 and y >= 0 for x, y in zip(before, after)),
             launch_after_host_us=[min(before), max(before)],
             host_after_launch_us=[min(after), max(after)],
             host_interval_us=sorted((b - a) / 1e3 for a, b in hosts))
    else:
        emit(reading="join", markers=len(marks), hosts=len(hosts),
             kernels=len(tr.kernels), lost=True)
    roots = list(tracer.roots)
    period = spantrace.KINETO_BASE_S * 10 ** 9
    first = min(roots, key=lambda r: r.t_start)
    guess = first.wall_ns(first.t_start) - marks[0]["ts"] * 1e3
    recs = spantrace.program_records(tr, roots)
    att = spantrace.Attribution(tr, recs)
    emit(reading="threads",
         span_threads=sorted({(sp.tid, spantrace.trace_tid(sp.ident))
                              for r in roots for sp in r.walk()}),
         trace_tids=sorted({e["tid"] for e in tr.calls}))
    after_us = tr.phase_us("after")
    model_us = tr.phase_us("forward", "between", "backward")
    emit(reading="attribution", kernels_a_step=len(tr.kernels) / n,
         base_found_equals_trace=round(guess / period) * period == base,
         witness=att.join_witness(), step_share=att.step_share(),
         mixer_kernel_ms=att.kernel_ms(*spantrace.MIXER),
         mixer_idle_ms=att.idle_ms(*spantrace.MIXER),
         optimizer_kernel_ms=att.kernel_ms(*spantrace.OPTIMIZER),
         optimizer_idle_ms=att.idle_ms(*spantrace.OPTIMIZER),
         adamw_ms=None if after_us is None else after_us / 1e3 / n,
         model_kernel_ms=None if model_us is None else model_us / 1e3 / n,
         by_span=att.by_span())

    launches = {}
    for follow in (True, False):
        tracer.follow_profiler = follow
        tel.reset()
        n, tr = harness.profiled(step, box, batches, at, dev)
        at += n
        launches[follow] = len(tr.kernels) / n
        emit(reading="launches", spans=follow,
             launches_per_step=launches[follow],
             roots=len(tracer.roots))
    tracer.follow_profiler = True
    emit(reading="launches_equal", equal=launches[True] == launches[False])
    if args.out:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
