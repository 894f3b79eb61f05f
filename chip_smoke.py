#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines, each failing the run on any error:

  1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
     nvcc versions; the kernels built from ``src/repro_torch/csrc`` (one
     nvcc per source, all started together).
  2. each of the six kernels against its plain PyTorch version on the
     same inputs, at the shapes its path gives it:
       * the serving kernels at collab-like F=496 -> H=64 and 64 -> 16,
         S=8, 372,475 destination rows with some zero-degree rows, on
         ideal, default bit-accurate and 12-bit-ADC/64-row numerics and
         both ``relu`` values; the quant layer also on ReRAM-noisy codes
         (its two-digit int8 path), at a ragged 67 -> 64 and, on 3,000
         rows, at the F of cora (1433), citeseer (3703) and 3704 -> 64,
         where its shared memory holds fewer columns a block; aggregation,
         zmax and the ideal layer also at F=67, with an x off 16-byte
         alignment (the scalar variants) and on rows whose only live slot
         is slot 5; the ideal layer also, on 3,000 rows, at 496 -> 130
         (ragged column tiles) and 1433, 3703 and 3704 -> 64 (K in
         chunks). Aggregation, zmax and the quant layer must be equal bit
         for bit; the ideal layer agrees within rtol 1e-5, atol 1e-5 *
         max|ref| (its 3xTF32 product sums in another order).
       * the wide and deep cases of the bit-accurate kernels, bit for bit
         on 3,000 rows, clean and noisy: the quant layer with K in chunks
         at tile-padded depths 4,960 (F 3,703 at rows_per_xbar 48), 3,712
         (F 3,703 at 64) and 4,800 (F 4,769 at 512, and at 4,096 rows: a
         tile deeper than a chunk, also with two passes), with 16-bit DAC
         codes at F 3,703 (64 and 48 rows: two passes), with 13-bit
         conductance codes at F 4,769 and 256 rows (three digits) and with
         both at F 3,703 and 64 rows; both the quant layer and the
         crossbar with 12-, 16- and 30-bit DAC codes (default and 64-row
         numerics) and 12- and 16-bit conductance codes at 64 rows.
       * the four serving kernels at the shapes a bucket of the bucketed
         layout gives them: Nd = 8 and 40 rows over a table of Nd + 16,
         S = 1, 2 and 4 with padding slots, F = 16 and 496.
       * ``cam_search`` at one k-NN launch of the recsys scenario at 20,000
         nodes (Q = 104 tagged query ids against E = 160,000 entries), at
         a ragged Q = 7, E = 160,001, with negative queries, and at
         Q = 600,000, E = 64 (past the grid's query limit): exact.
       * ``crossbar_matmul_quantized`` at 32 x 216 x 64 (the variation
         bounds), 372,475 x 496 x 64 (layer 1 of the centralized collab
         path) and, on 3,000 rows, at K = 1,100 (ragged crossbar tiles)
         and K = 5,000 (K in chunks of the staged depth), through the
         conductance-code and the programmed-weights entry points,
         default and 12-bit-ADC/64-row numerics, clean and noisy
         conductance codes: exact; and ``crossbar_matmul_signed`` on the
         kernel equal to ``crossbar_matmul_signed_ref`` bit for bit.
  3. the paths, each driven through its entry points with the launch
     counters set to 0 just before and read just after; every kernel a
     path runs must have launched:
       * serving: ``GNNServer`` with GNNConfig(in_dim=496, hidden_dims=(64,),
         out_dim=16, sample=8), centralized on collab at scale 1.0,
         decentralized on 8 clusters in both exchange modes and semi on
         4 heads x 4 spokes at scale 0.1, each refreshed and answering 64
         batches of 16 lookups on ``fused`` and ``pallas`` with ideal and
         bit-accurate numerics, against ``jnp`` on the card at rtol and
         atol 1e-4 * max|ref|.
       * path A, CAM-built k-NN serving: the recsys and anomaly graphs at
         20,000 nodes (F=32, 8 bands x 8 bits, k=8) built on the
         ``cam-pallas``, ``cam`` and ``topk`` paths must be equal bit for
         bit, ``cam_search`` launched ceil(N / 13) times per build; a
         centralized plan on that graph served as above (in_dim=32); and
         the CLI driven once with ``--dataset recsys --neighbor-mode
         cam-pallas --setting centralized --scale 0.1``.
       * path B, conductance-variation bounds: ``mvm_error_bounds`` for the
         four technologies, ``pallas`` (18 crossbar launches each) equal
         to ``jnp`` field for field; ``noisy_forward`` with ReRAM noise on
         collab at scale 0.1, 4 trials, on ``fused`` and ``pallas`` against
         ``jnp`` at 1e-4 * max|ref|; ``accuracy_bounds`` for the same
         configuration, printed.
       * path C, the capacity-bucketed layout: C1, collab at scale 0.1
         (F 496 -> 64 -> 16, S 8) decentralized on 16 edge-balanced
         clusters and semi 4 x 4, ``buckets="auto"``, on every backend
         with ideal and bit-accurate numerics, in both halo schedules
         (``overlap`` on a side stream, ``serial``): overlap equal to
         serial bit for bit, the embeddings equal to the dense plan's on
         the same partition bit for bit (the ``jnp``/``pallas`` ideal
         layer's ``torch.matmul``: within 1e-4 * max|ref|); C2, the
         million-node configuration of ``benchmarks/scale_serve.py``
         (random graph, 1,000,000 nodes, 4,000,000 edges, F 16, hidden 16,
         out 8, 64 clusters) on ``fused`` and ``pallas`` against the
         bucketed ``jnp`` backend within 1e-4 * max|ref|, with the padding
         gate (bucketed waste at most half the dense layout's, priced by
         ``layout_stats``). Each prints its layout, host set-up, the warm
         refresh of each schedule (median of 3, taking turns) and the
         launches of one refresh.
       * path D, streaming serving through ``StreamingGNNServer``, the
         launch counters set to 0 before each part: D1, centralized collab
         1.0 on ``fused``, ideal numerics, policy ``eager``, the
         ``cam-pallas`` frontier: a cold refresh and 6 ticks of feature
         churn at 0.001 of the nodes (372 rows a tick), each printing its
         commit seconds, recompute fraction, ``cam_search`` calls and the
         split of the commit between ``apply_deltas``, the frontier and
         the dirty-row steps (from the telemetry's spans); the served
         embeddings against a fresh ``make_forward`` of the shared plan on
         ``fused`` and ``jnp`` (rtol 1e-4, atol 1e-4 * max|ref|); one
         tick's frontier in ``numpy``, ``cam`` and ``cam-pallas`` mode,
         equal bit for bit; one bit-accurate commit, which must fall back
         to a full refresh equal bit for bit to a ``GNNServer`` refresh.
         D2, collab 0.1: decentralized on 8 clusters in both exchange
         modes, semi 4 x 4 and C1's bucketed plan, on ``fused`` and
         ``pallas``, policy ``interval`` (2), 4 ticks of feature churn at
         0.01 with 16 added and 4 removed edges: the embeddings against a
         centralized ``jnp`` forward of the mutated graph within 1e-4 *
         max|ref|, the summed incremental traffic at most the full
         exchange's bytes times the commits. Over path D
         ``fused_ideal_layer``, ``csr_aggregate``, ``cam_search``,
         ``fused_zmax`` and ``fused_quant_layer`` must each launch.
       * the traced refresh: one warm ``GNNServer`` refresh of
         centralized collab 1.0 on ``fused``, ideal and bit-accurate, with
         the port's telemetry on (``[trace]`` lines: ``server.refresh``,
         ``plan.forward`` closed by its device sync, and the rest, the
         scatter and its copy to the host), then under ``torch.profiler``
         with the spans mirrored into ``record_function``: the device-busy
         share of the ``server.refresh`` window (the chrome traces go to
         ``chiprun_out/``).
       * path E, the kernels' launch choices, tuning and calibration:
         E1 runs every tuning candidate (``tuning.candidates``) of every
         kernel at collab 1.0's layer 1 and layer 2, at the largest
         bucket of C1's bucketed plan, at the repaired deep shapes (F
         3,703 at 48 and 64 rows, 8- and 16-bit DAC codes, clean and
         noisy, and 13-bit conductance codes: the quant layer and the
         crossbar, whose carried sums a chunk depth must keep) and at the
         CAM's k-NN and frontier launches, each equal to the default
         launch with ``torch.equal``, and prints its CUDA-event ms; E2
         runs ``ExecutionPlan.tune_kernels`` on centralized collab 1.0
         (``fused`` ideal and bit-accurate, ``pallas``) and C1's bucketed
         plan on ``fused`` into a temporary ``TuneCache``: each winner no
         slower than the default, a second tune answered from the cache
         with no measurement and no launch, a tuned ``GNNServer`` refresh
         equal to the untuned one bit for bit; E3 calibrates the cost
         model's per-pass primitives on the card (``devices.calibrate``),
         loads them back strictly under the card's platform tag and prices
         the plan with them; E4 runs ``python -m repro_torch.launch.gnn
         --setting centralized --dataset collab --scale 0.1 --tune
         --tune-cache <tmp> --mapping --tech reram`` and holds its
         cost-model and mapper lines equal to the same plan's in this
         process. E2 and E3 must launch every kernel.
       * path F, the planner (``repro_torch.planner``), host code whose
         plans are served on the kernels: F1 runs ``plan`` model-only on
         the statistics of taxi and the four Table-2 datasets under the
         three objectives, static and mixed (churn 0.01, 64 lookups a
         tick), each recommendation the exhaustive argmin of
         ``score_candidate`` (taxi mixed must recommend semi), then the
         CLI's measured phase on collab 1.0 (shortlist 2), the ranking
         unchanged by it; F2, the load loops of ``benchmarks/load_serve.py
         --auto`` at collab 0.1 on ``fused`` with the ``cam-pallas``
         frontier, for centralized, decentralized 8, semi 4 x 4 (``eager``)
         and the planner's recommendation with a ``ReplanMonitor``
         attached: a closed loop, then an open loop of Poisson arrivals at
         0.8 of the closed loop's capacity, each 64 requests of 16 lookups
         with a tick of 1 % churn every 4 requests; every lookup served,
         percentiles monotone, a commit in the loops, the final embeddings
         equal to a centralized ``jnp`` forward of the mutated graph within
         1e-4 * max|ref|; F3, a pinned decentralized 8 ``pallas`` plan
         under a ``ReplanMonitor(window=2, tol=2.0, cooldown=1)``: 4
         ticks of 1 % churn, then ticks of 90 % until drift re-plans and
         swaps the plan on the card (measured above tol x reference,
         measured churn above 4x the assumed, a new configuration); F3b,
         a drift fed through ``observe`` with samples of the mixed
         workload swaps a pinned centralized server to the bucketed
         recommendation; after each swap the parameters are the same
         tensors, the first commit is a full refresh the ledger skips,
         the new backend's kernel launches and the lookups equal a fresh
         ``jnp`` forward of the live graph; F4 runs ``python -m
         repro_torch.launch.gnn --plan auto --dataset collab --scale 0.1``
         and the same with ``--stream 8 --neighbor-mode cam-pallas`` (at
         once), each one's summary equal to the same ``plan(...)`` made in
         this process. Over path F ``fused_ideal_layer`` and
         ``cam_search`` must launch.
  4. each kernel's time (CUDA events) beside its plain version's, its
     bound on an H100 SXM and, for aggregation, ``torch.sparse.mm`` of the
     CSR sample matrix as the library yardstick: the serving kernels at
     layer 1 and layer 2 of the centralized path (the quant layer with
     the programming of its weights, as every serving call runs it, and
     per numerics and codes also its launch alone; zmax and the ideal
     layer also by the device time of the launch alone and beside their
     composed yardstick: aggregation then the row max and min, and the
     ``pallas`` backend's aggregation, matmul, bias and relu),
     ``cam_search`` at Q = 104, E = 160,000 (with the k-NN build's
     shares: its CAM calls and its bitmap folds) and
     ``crossbar_matmul_quantized`` at 372,475 x 496 x 64 (both numerics,
     clean and noisy codes), 372,475 x 64 x 16 and 32 x 216 x 64. These
     two are timed per wrapper call and by the device time of the launch
     alone (the profiler's kernel time). The wide and deep cases are timed by
     their launch at layer 1 (12-, 16- and 30-bit DAC codes, 12- and
     16-bit conductance codes) and on 3,000 rows at the deep cases. The
     build lines give each kernel's
     registers and spills.

The last lines are the card line, one JSON object with a record per
kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import devices, neighbors  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.core import dataset_like, gnn, random_graph  # noqa: E402
from repro_torch.core.graph import TABLE2_DATASETS, TAXI_STATS  # noqa: E402
from repro_torch.core.partition import plan_execution  # noqa: E402
from repro_torch.kernels import (_build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels import crossbar_mvm as xb  # noqa: E402
from repro_torch.kernels.cam_match import (  # noqa: E402
    cam_search, cam_search_ref)
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics  # noqa: E402
from repro_torch.kernels.csr_aggregate.ops import csr_aggregate  # noqa: E402
from repro_torch.kernels.csr_aggregate.ref import (  # noqa: E402
    csr_aggregate_ref)
from repro_torch.kernels.fused_layer import ops as fl  # noqa: E402
from repro_torch.launch import gnn as cli  # noqa: E402
from repro_torch.launch.gnn import GNNServer  # noqa: E402
from repro_torch.neighbors import knn  # noqa: E402
from repro_torch.planner import (OBJECTIVES, Candidate,  # noqa: E402
                                 CommitSample, PlanContext,
                                 ReplanMonitor, WorkloadProfile,
                                 candidate_space, plan,
                                 score_candidate)
from repro_torch.streaming import (StreamingGNNServer,  # noqa: E402
                                   expand_frontier)
from repro_torch import tuning  # noqa: E402
from repro_torch.tuning import (AggregateGeometry, CamGeometry,  # noqa: E402
                                CrossbarGeometry, FusedGeometry, TuneCache,
                                candidates, default_config, plan_geometries,
                                registry)
from repro_torch.analysis.roofline import H100  # noqa: E402
from repro_torch.tuning.autotune import plan_tables  # noqa: E402
from repro_torch.tuning.measure import measurer, time_callable  # noqa: E402

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 flop/s on the CUDA
# cores, int8 op/s on the tensor cores.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TF32_OPS = 494.7e12     # dense, on the tensor cores
INT8_OPS = 1979e12

HIDDEN, OUT, SAMPLE = 64, 16, 8
QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
SCENARIO_NODES = 20_000        # the CLI's --scale 0.1 (200,000 * 0.1)
TECHS = ("sot-mram", "reram", "sram", "fefet")

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "fused_ideal_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:142"),
    "fused_zmax": ("src/repro_torch/csrc/fused_layer.cu",
                   "src/repro/kernels/fused_layer/fused_layer.py:176"),
    "fused_quant_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:202"),
    "csr_aggregate": ("src/repro_torch/csrc/csr_aggregate.cu",
                      "src/repro/kernels/csr_aggregate/csr_aggregate.py:39"),
    "crossbar_matmul_quantized": (
        "src/repro_torch/csrc/crossbar_mvm.cu",
        "src/repro/kernels/crossbar_mvm/crossbar_mvm.py:59"),
    "cam_search": ("src/repro_torch/csrc/cam_match.cu",
                   "src/repro/kernels/cam_match/cam_match.py:34"),
}


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def profiled_ms(fn, kernel: str, calls: int, tries: int = 3) -> tuple:
    """(mean device ms of one launch of the kernel whose name holds
    ``kernel``, how it was timed) over ``calls`` calls of ``fn``.

    The time is the kernel's own device time from ``torch.profiler``. The
    profiler's CUDA trace now and then comes back without the kernel; after
    ``tries`` such traces the launch is timed with CUDA events around
    ``calls`` back-to-back calls instead, and the text says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total += evt.device_time_total
                count += evt.count
        if count and total > 0:
            return total / count / 1e3, f"profiler, {count} launches"
    print(f"[time] the profiler showed no device time for {kernel} in "
          f"{tries} traces: timed with CUDA events", flush=True)
    return cuda_ms(fn, calls), f"CUDA events, {calls} calls"


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after two
    warm-up calls, from CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 2


def record(err: dict, name, got, ref, exact, label) -> None:
    """Hold one kernel output to its plain version's; fold the error into
    ``err[name]``."""
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == ref.dtype
            and bool(torch.isfinite(got).all()),
            f"{name} {label}: shape, type or non-finite values")
    diff = (got.double() - ref.double()).abs()
    e = float(diff.max()) if diff.numel() else 0.0
    err[name] = max(err[name], e)
    if exact:
        ok = torch.equal(got, ref)
        tol = "exact"
    else:
        scale = float(ref.abs().max()) or 1.0
        ok = bool((diff <= 1e-5 * scale + 1e-5 * ref.abs()).all())
        tol = f"rtol 1e-5 atol {1e-5 * scale:.3e}"
    print(f"[kernels] {name:18s} {label:34s} max|err| {e:.3e} ({tol}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} {label} disagrees with its plain version")


def kernel_checks(x1, x2, nbr, wts, params, device, err: dict) -> None:
    """The serving kernels against their plain versions on the same
    inputs; aggregation, zmax and the quant layer bit for bit. Beside the
    serving shapes: a ragged F = 67 and an x that is not 16-byte aligned
    (the scalar variants), and rows whose only live slot is slot 5."""
    gen = torch.Generator(device=device).manual_seed(7)
    x67 = x1[:, :67].contiguous()
    x_off = x1.reshape(-1)[1:1 + x1.numel() - x1.shape[1]].view(
        -1, x1.shape[1])            # N - 1 rows of F = 496, 4 bytes off 16
    nbr_off = torch.clamp_max(nbr, x_off.shape[0] - 1)
    wts_late = wts.clone()
    wts_late[1::5] = 0.0
    wts_late[1::5, 5] = 0.5         # only slot 5 live
    for x, nb, w_, tag in ((x1, nbr, wts, "F=496"), (x2, nbr, wts, "F=64"),
                           (x67, nbr, wts, "F=67 (scalar variant)"),
                           (x1, nbr, wts_late, "F=496 only slot 5 live"),
                           (x_off, nbr_off, wts, "F=496 x 4 B off 16 "
                                                 "(scalar variant)")):
        record(err, "csr_aggregate", csr_aggregate(x, nb, w_),
               csr_aggregate_ref(x, nb, w_), True, tag)
    w1, w67 = params[0]["w"], params[0]["w"][:67].contiguous()
    for x, nb, w_, w, tag in (
            (x1, nbr, wts, w1, "F=496 (496->64)"),
            (x2, nbr, wts, params[1]["w"], "F=64 (64->16)"),
            (x67, nbr, wts, w67, "F=67 (67->64, scalar variant)"),
            (x1, nbr, wts_late, w1, "F=496 only slot 5 live"),
            (x_off, nbr_off, wts, w1, "F=496 x 4 B off 16 (scalar "
                                      "variant)")):
        record(err, "fused_zmax", fl.fused_zmax(x, nb, w_),
               fl.fused_zmax_plain(x, nb, w_), True, tag)
        ideal_check(err, x, nb, w_, w, gen, tag)
    numerics = {"default": CrossbarNumerics(), "QUANT": CrossbarNumerics(
        **QUANT)}
    for x, w, tag in ((x1, w1, "496->64"), (x2, params[1]["w"], "64->16"),
                      (x67, w67, "67->64 (scalar variant)")):
        b = 0.1 * torch.randn(w.shape[1], generator=gen, device=device)
        for relu in (True, False):
            for nname, cfg in numerics.items():
                for noisy in (False, True):
                    nz = torch.from_numpy(devices.sample_conductance_noise(
                        3, tuple(w.shape), "reram", cfg)).to(device) \
                        if noisy else None
                    quant_check(err, x, nbr, wts, w, b, cfg, nz, relu,
                                f"{tag} {nname} noisy={noisy} relu={relu}")
    src = 4000                      # rows of x for the wide-F checks
    nbr_w = torch.remainder(nbr[:3000], src)
    wts_w = wts[:3000].contiguous()
    x = torch.randn((src, x1.shape[1]), generator=gen, device=device)
    ideal_check(err, x, nbr_w, wts_w,
                0.05 * torch.randn((x1.shape[1], 130), generator=gen,
                                   device=device), gen,
                "3000 rows 496->130 (ragged column tiles)")
    for f in (1433, 3703, 3704):
        x = torch.randn((src, f), generator=gen, device=device)
        w = 0.05 * torch.randn((f, HIDDEN), generator=gen, device=device)
        ideal_check(err, x, nbr_w, wts_w, w, gen,
                    f"3000 rows {f}->64 (K in chunks)")
        b = 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
        for nname, cfg in numerics.items():
            for noisy in (False, True):
                nz = torch.from_numpy(devices.sample_conductance_noise(
                    f, (f, HIDDEN), "reram", cfg)).to(device) \
                    if noisy else None
                quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                            f"3000 rows {f}->64 {nname} noisy={noisy}")


# the numerics of the wide cases: DAC codes of two bytes (in_bits 12,
# 16) and of four (30, the widest the kernels take) and conductance codes
# of two or three int8 digits (w_bits 12, 16)
WIDE = {"in_bits=12": dict(in_bits=12),
        "in_bits=12 64-row": dict(in_bits=12, adc_bits=12, rows_per_xbar=64),
        "in_bits=16": dict(in_bits=16),
        "in_bits=16 64-row": dict(in_bits=16, adc_bits=12, rows_per_xbar=64),
        "in_bits=30": dict(in_bits=30),
        "w_bits=12 64-row": dict(w_bits=12, rows_per_xbar=64),
        "w_bits=16 64-row": dict(w_bits=16, rows_per_xbar=64)}

# the deep cases of the quant layer, (F, numerics): depths whose digits do
# not fit a block's shared memory beside a row tile's codes, so K goes in
# chunks, with one pass and one or two digits (citeseer's F = 3,703 at
# rows_per_xbar 48, depth 4,960, and at 64, depth 3,712; F = 4,769 at 512,
# depth 4,800), with two passes of bit planes (in_bits 16 at 64 and 48
# rows), with three digits (w_bits 13 at 256 rows) and with both; and
# crossbar tiles of 4,096 rows, deeper than a chunk, whose sums are
# carried across chunks (one pass, and two with the chunks staged again)
DEEP = ((3703, dict(rows_per_xbar=48)), (3703, dict(rows_per_xbar=64)),
        (4769, dict(rows_per_xbar=512)),
        (4769, dict(rows_per_xbar=4096)),
        (4769, dict(in_bits=16, rows_per_xbar=4096)),
        (3703, dict(in_bits=16, rows_per_xbar=64)),
        (3703, dict(in_bits=16, rows_per_xbar=48)),
        (4769, dict(w_bits=13, rows_per_xbar=256)),
        (3703, dict(in_bits=16, w_bits=13, rows_per_xbar=64)))


def deep_inputs(device, seed: int) -> dict:
    """F -> (x [4000, F], w [F, 64], b [64]) of the deep cases."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for f in sorted({f for f, _ in DEEP}):
        out[f] = (torch.randn((4000, f), generator=gen, device=device),
                  0.05 * torch.randn((f, HIDDEN), generator=gen,
                                     device=device),
                  0.1 * torch.randn(HIDDEN, generator=gen, device=device))
    return out


def numerics_tag(numerics: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in numerics.items())


def wide_deep_checks(x1, nbr, wts, device, err: dict) -> None:
    """The wide and deep cases of the bit-accurate kernels, against their
    plain versions bit for bit on 3,000 rows, clean and ReRAM-noisy: the
    quant layer at the DEEP depths (K in chunks, with passes and three
    digits), and both kernels at F = 496 with the WIDE numerics."""
    gen = torch.Generator(device=device).manual_seed(11)
    src = 4000
    nbr_w = torch.remainder(nbr[:3000], src)
    wts_w = wts[:3000].contiguous()
    deep = deep_inputs(device, 11)
    for f, numerics in DEEP:
        x, w, b = deep[f]
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                f, (f, HIDDEN), "reram", cfg)).to(device) if noisy else None
            quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                        f"3000 rows {f}->64 {numerics_tag(numerics)} depth "
                        f"{fl.tile_depth(f, cfg.rows_per_xbar)} "
                        f"noisy={noisy}")
    x = x1[:src].contiguous()
    w = 0.05 * torch.randn((x.shape[1], HIDDEN), generator=gen,
                           device=device)
    b = 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
    z = csr_aggregate_ref(x, nbr_w, wts_w)
    for name, numerics in WIDE.items():
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                5, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                        f"3000 rows 496->64 {name} noisy={noisy}")
            xq, _ = xb.quantize_inputs(torch.clamp_min(z, 0.0), cfg)
            codes = xb.program_conductances(w, cfg, nz)
            ref = xb.crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_quantized(xq, codes.wq, cfg), ref,
                   True, f"3000x496x64 {name} noisy={noisy} codes")
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_programmed(xq, codes, cfg), ref, True,
                   f"3000x496x64 {name} noisy={noisy} programmed")


def small_shape_checks(device, err: dict) -> None:
    """The four serving kernels at the shapes a bucket of the bucketed
    layout gives them, against their plain versions: Nd = 8 and 40 owned
    rows over a table of Nd + 16 halo rows, neighbor widths S = 1, 2 and
    4 (some slots padding), F = 16 and 496; aggregation, zmax and the
    quant layer bit for bit, the ideal layer within rtol 1e-5."""
    gen = torch.Generator(device=device).manual_seed(13)
    for nd in (8, 40):
        for s in (1, 2, 4):
            for f, h in ((16, 8), (496, 64)):
                n = nd + 16
                x = torch.randn((n, f), generator=gen, device=device)
                nbr = torch.randint(0, n, (nd, s), generator=gen,
                                    device=device, dtype=torch.int32)
                wts = torch.rand((nd, s), generator=gen, device=device)
                wts[1::3, -1] = 0.0          # padding slots
                w = 0.1 * torch.randn((f, h), generator=gen, device=device)
                b = 0.1 * torch.randn(h, generator=gen, device=device)
                tag = f"Nd={nd} S={s} F={f}->{h}"
                record(err, "csr_aggregate", csr_aggregate(x, nbr, wts),
                       csr_aggregate_ref(x, nbr, wts), True, tag)
                record(err, "fused_zmax", fl.fused_zmax(x, nbr, wts),
                       fl.fused_zmax_plain(x, nbr, wts), True, tag)
                ideal_check(err, x, nbr, wts, w, gen, tag)
                for nname, cfg in (("default", CrossbarNumerics()),
                                   ("QUANT", CrossbarNumerics(**QUANT))):
                    quant_check(err, x, nbr, wts, w, b, cfg, None, True,
                                f"{tag} {nname}")


def ideal_check(err, x, nbr, wts, w, gen, label) -> None:
    """The ideal layer against its plain version, with both ``relu``
    values, within rtol 1e-5, atol 1e-5 * max|ref|."""
    b = 0.1 * torch.randn(w.shape[1], generator=gen, device=x.device)
    for relu in (True, False):
        record(err, "fused_ideal_layer",
               fl.fused_ideal_layer(x, nbr, wts, w, b, relu=relu),
               fl.fused_ideal_layer_plain(x, nbr, wts, w, b, relu=relu),
               False, f"{label} relu={relu}")


def quant_check(err, x, nbr, wts, w, b, cfg, nz, relu, label) -> None:
    """The quant layer on programmed codes against its plain version, bit
    for bit."""
    codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nbr, wts), w,
                                      cfg, nz)
    record(err, "fused_quant_layer",
           fl.fused_quant_layer(x, nbr, wts, codes, b, scales, cfg,
                                relu=relu),
           fl.fused_quant_layer_plain(x, nbr, wts, codes.wq, b, scales, cfg,
                                      relu=relu),
           True, label)


def cam_inputs(device) -> tuple:
    """(entries [E], queries [Q]) of one k-NN launch of the recsys scenario
    at SCENARIO_NODES nodes: every node's tagged band signatures, and the
    tagged signatures of the first query chunk."""
    x, _ = neighbors.scenario_features("recsys", n_nodes=SCENARIO_NODES,
                                       feature_len=32)
    sigs = neighbors.lsh_signatures(x)
    n, b = sigs.shape
    chunk = knn._BITMAP_BUDGET // (n * b * b)
    entries = torch.from_numpy(neighbors.tag_bands(sigs)).to(device)
    return entries, entries[:chunk * b].clone()


def mvm_inputs(device) -> tuple:
    """(x, w) of ``mvm_error_bounds`` at its default 32 x 216 x 64."""
    rng = np.random.default_rng(0x0DA7A)
    x = torch.from_numpy(rng.standard_normal((32, 216)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((216, 64)) * 0.1)
                         .astype(np.float32))
    return x.to(device), w.to(device)


def crossbar_codes(x, w, cfg, noisy: bool) -> tuple:
    """(xq, codes) the kernel gets from ``crossbar_matmul`` on (x, w): DAC
    codes of max(x, 0) and the weights programmed with a ReRAM noise draw
    (``codes.wq`` the conductance codes, ``codes.digits`` their int8
    digits)."""
    xq, _ = xb.quantize_inputs(torch.clamp_min(x, 0.0), cfg)
    nz = torch.from_numpy(devices.sample_conductance_noise(
        1, tuple(w.shape), "reram", cfg)).to(w.device) if noisy else None
    return xq, xb.program_conductances(w, cfg, nz)


def crossbar_check(err, x, w, tag) -> None:
    """The crossbar kernel through both entry points (conductance codes and
    programmed weights) against its plain version, bit for bit, in both
    numerics on clean and noisy codes."""
    for nname, cfg in (("default", CrossbarNumerics()),
                       ("QUANT", CrossbarNumerics(**QUANT))):
        for noisy in (False, True):
            xq, codes = crossbar_codes(x, w, cfg, noisy)
            ref = xb.crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_quantized(xq, codes.wq, cfg), ref,
                   True, f"{tag} {nname} noisy={noisy} codes")
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_programmed(xq, codes, cfg), ref, True,
                   f"{tag} {nname} noisy={noisy} programmed")


def new_kernel_checks(z1, w1, device, err: dict) -> None:
    """``cam_search`` and ``crossbar_matmul_quantized`` against their
    plain versions, exactly, at their paths' shapes; the CAM also past the
    grid's query limit, the crossbar also at a ragged K of three 512-row
    crossbar tiles and at a K that goes in chunks."""
    entries, queries = cam_inputs(device)
    ragged_e = torch.cat([entries, entries[:1]])
    negative = queries.clone()
    negative[::5] = -1
    negative[1::7] = -(1 << 20)
    gen = torch.Generator(device=device).manual_seed(3)
    few = entries[:64].clone()
    many = few[torch.randint(0, 64, (600_000,), generator=gen,
                             device=device)]
    many[::9] = -1
    for ci, q, tag in ((entries, queries, "Q=104 E=160000"),
                       (ragged_e, queries[:7].clone(), "Q=7 E=160001"),
                       (entries, negative, "Q=104 negative queries"),
                       (few, many, "Q=600000 E=64 (group loop)")):
        match, counts = cam_search(ci, q)
        ref_match, ref_counts = cam_search_ref(ci, q)
        record(err, "cam_search", match, ref_match, True, f"{tag} bitmap")
        record(err, "cam_search", counts, ref_counts, True, f"{tag} counts")
    x_small, w_small = mvm_inputs(device)
    crossbar_check(err, x_small, w_small, "32x216x64")
    crossbar_check(err, z1, w1, "372475x496x64")
    for k in (1100, 5000):
        x = torch.randn((3000, k), generator=gen, device=device)
        w = 0.05 * torch.randn((k, HIDDEN), generator=gen, device=device)
        crossbar_check(err, x, w, f"3000x{k}x64")
    for nname, cfg in (("default", CrossbarNumerics()),
                       ("QUANT", CrossbarNumerics(**QUANT))):
        nz = torch.from_numpy(devices.sample_conductance_noise(
            2, (216, 64), "reram", cfg)).to(device)
        got = xb.crossbar_matmul_signed(x_small, w_small, cfg, w_noise=nz)
        ref = xb.crossbar_matmul_signed_ref(x_small, w_small, cfg,
                                            w_noise=nz)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref)
        print(f"[kernels] crossbar_matmul_signed 32x216x64 {nname} noisy: "
              f"equal to crossbar_matmul_signed_ref: {ok}", flush=True)
        require(ok, "crossbar_matmul_signed differs from its oracle")


# ------------------------------------------------------------------ phase 3

EXPECTED = {("fused", True): ("fused_ideal_layer",),
            ("fused", False): ("fused_zmax", "fused_quant_layer"),
            ("pallas", True): ("csr_aggregate",),
            ("pallas", False): ("csr_aggregate",)}


def serve_cases(plan, cfg, modes, device, counted: bool, totals: dict,
                batches: int = 64, batch: int = 16) -> None:
    """Serve ``plan`` on fused and pallas with ideal and bit-accurate
    numerics, against the jnp backend on the same device."""
    n = plan.graph.n_nodes
    for mode in modes:
        for ideal in (True, False):
            c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                ideal=ideal))
            ref_srv = GNNServer(dataclasses.replace(plan, backend="jnp"), c,
                                mode=mode, device=device)
            t_ref = ref_srv.refresh()
            ref = ref_srv.embeddings
            del ref_srv
            scale = float(np.abs(ref).max()) or 1.0
            for backend in ("fused", "pallas"):
                srv = GNNServer(dataclasses.replace(plan, backend=backend),
                                c, mode=mode, device=device)
                reset_launch_counts()
                rng = np.random.default_rng(0)
                t0 = time.perf_counter()
                for _ in range(batches):
                    ids = rng.integers(0, n, batch)
                    out = srv.query(ids)
                    require(out.shape == (batch, cfg.out_dim)
                            and np.isfinite(out).all(),
                            "query returned a wrong shape or non-finite "
                            "values")
                t_cold = time.perf_counter() - t0
                counts = launch_counts()
                t_warm = srv.refresh()
                got = srv.embeddings
                require(got.shape == (n, cfg.out_dim), "embedding shape")
                diff = np.abs(got - ref)
                ok = bool((diff <= 1e-4 * scale + 1e-4 * np.abs(ref)).all())
                label = (f"{plan.setting:13s} {mode:9s} {backend:6s} "
                         f"{'ideal' if ideal else 'bit-accurate':12s}")
                print(f"[serve] {label} refresh+{batches}x{batch} lookups "
                      f"{t_cold * 1e3:.1f} ms, warm refresh "
                      f"{t_warm * 1e3:.1f} ms (jnp {t_ref * 1e3:.1f} ms); "
                      f"max|err| {float(diff.max()):.3e} vs jnp "
                      f"(tol {1e-4 * scale:.3e}) {'ok' if ok else 'FAIL'}; "
                      f"launches {json.dumps(counts)}", flush=True)
                require(ok, f"{label} disagrees with the jnp backend")
                require(srv.refreshes == 2, "the server refreshed more than "
                        "once for one version")
                if counted:
                    for k in EXPECTED[(backend, ideal)]:
                        require(counts[k] > 0, f"{label}: {k} never "
                                f"launched on its path")
                for k, v in counts.items():
                    totals[k] += v
                del srv


def counted(what: str, fn, expect: dict, totals: dict):
    """Run ``fn`` with every launch counter at 0 and read the counters
    after it: ``expect`` maps a kernel to its exact launch count, or to
    None for "at least once". Adds the counts to ``totals``; returns what
    ``fn`` returns."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[launches] {what}: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    for k, n in expect.items():
        require(counts[k] > 0 if n is None else counts[k] == n,
                f"{what}: {k} launched {counts[k]} times, want "
                f"{'> 0' if n is None else n}")
    for k, v in counts.items():
        totals[k] += v
    return out


def path_a(device, totals: dict) -> dict:
    """CAM-built k-NN serving: both scenarios' graphs on the three paths,
    a centralized plan served on them, and the CLI. Returns each
    scenario's build seconds on ``cam-pallas`` (host clock)."""
    n = SCENARIO_NODES
    per_launch = knn._BITMAP_BUDGET // (n * 64)        # query nodes
    launches = -(-n // per_launch)
    cfg = gnn.GNNConfig(in_dim=32, hidden_dims=(HIDDEN,), out_dim=OUT,
                        sample=SAMPLE)
    builds = {}
    for name in neighbors.SCENARIOS:
        graphs = {}
        for mode, backend in (("cam", "pallas"), ("cam", "jnp"),
                              ("topk", "jnp")):
            t0 = time.perf_counter()
            graphs[mode, backend] = counted(
                f"{name} k-NN {mode}/{backend}",
                lambda mode=mode, backend=backend: neighbors.scenario_graph(
                    name, n_nodes=n, feature_len=32, k=SAMPLE,
                    neighbor_mode=mode, backend=backend, device=device),
                {"cam_search": launches if backend == "pallas" else 0},
                totals)
            secs = time.perf_counter() - t0
            if backend == "pallas":
                builds[name] = secs
            g = graphs[mode, backend]
            print(f"[pathA] {name} {mode}/{backend}: {g.n_nodes} nodes, "
                  f"{g.n_edges} edges, built in {secs:.3f} s (host clock)",
                  flush=True)
        ref = graphs["cam", "pallas"]
        for (mode, backend), g in graphs.items():
            require(all(np.array_equal(getattr(g, a), getattr(ref, a))
                        for a in ("indptr", "indices", "edge_weight")),
                    f"{name}: the {mode}/{backend} graph differs from "
                    f"cam/pallas")
        print(f"[pathA] {name}: cam-pallas, cam and topk graphs equal bit "
              f"for bit ({launches} cam_search launches per build)",
              flush=True)
        plan = plan_execution(ref.gcn_normalize(), "centralized",
                              sample=SAMPLE)
        serve_cases(plan, cfg, ("alltoall",), device, True, totals)
    counted("CLI --dataset recsys --neighbor-mode cam-pallas",
            lambda: cli.main(["--dataset", "recsys", "--neighbor-mode",
                              "cam-pallas", "--setting", "centralized",
                              "--scale", "0.1"]),
            {"cam_search": launches, "fused_ideal_layer": None}, totals)
    return builds


def path_b(device, g, totals: dict) -> None:
    """Conductance-variation bounds: MVM bounds of the four technologies
    on both crossbar backends, noisy forwards on the three GNN backends,
    and the end-to-end bounds."""
    for tech in TECHS:
        plain = counted(
            f"mvm_error_bounds {tech} jnp",
            lambda tech=tech: devices.mvm_error_bounds(
                tech, backend="jnp", device=device),
            {"crossbar_matmul_quantized": 0}, totals)
        kernel = counted(
            f"mvm_error_bounds {tech} pallas",
            lambda tech=tech: devices.mvm_error_bounds(
                tech, backend="pallas", device=device),
            {"crossbar_matmul_quantized": 18}, totals)
        print(f"[pathB] mvm_error_bounds {tech}: pallas == jnp field for "
              f"field: {kernel == plain}; {kernel}", flush=True)
        require(kernel == plain, f"mvm_error_bounds {tech}: the backends "
                f"differ")
    numerics = CrossbarNumerics()
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE, numerics=numerics)
    params = gnn.init_params(cfg, seed=0, device=device)
    nb, wt = g.neighbor_sample(SAMPLE)
    xs = tuple(torch.from_numpy(a).to(device) for a in (g.features, nb, wt))
    noise = [devices.layer_noise([0, t], params, "reram", numerics)
             for t in range(4)]

    def trials(backend):
        c = dataclasses.replace(cfg, backend=backend)
        return [devices.noisy_forward(params, *xs, c, nz).cpu().numpy()
                for nz in noise]
    ref = trials("jnp")
    for backend, expect in (("fused", {"fused_zmax": None,
                                       "fused_quant_layer": None}),
                            ("pallas", {"csr_aggregate": None})):
        t0 = time.perf_counter()
        outs = counted(f"noisy_forward reram {backend}",
                       lambda backend=backend: trials(backend), expect,
                       totals)
        dt = time.perf_counter() - t0
        for t, (got, r) in enumerate(zip(outs, ref)):
            scale = float(np.abs(r).max()) or 1.0
            diff = np.abs(got - r)
            ok = bool((diff <= 1e-4 * scale + 1e-4 * np.abs(r)).all()
                      and got.shape == (g.n_nodes, OUT))
            print(f"[pathB] noisy_forward reram collab 0.1 {backend:6s} "
                  f"trial {t}: max|err| {float(diff.max()):.3e} vs jnp "
                  f"(tol {1e-4 * scale:.3e}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"noisy_forward {backend} trial {t} disagrees "
                    f"with jnp")
        print(f"[pathB] noisy_forward {backend}: 4 trials in {dt:.2f} s "
              f"(host clock)", flush=True)
    acc = counted(
        "accuracy_bounds reram collab 0.1 fused",
        lambda: devices.accuracy_bounds(
            "reram", dataset="collab", scale=0.1, trials=4,
            backend="fused", hidden=HIDDEN, out_dim=OUT, sample=SAMPLE,
            device=device),
        {"fused_zmax": None, "fused_quant_layer": None}, totals)
    require(np.isfinite([acc.mean_err, acc.p99_err, acc.ci95,
                         acc.flip_rate]).all(), "accuracy_bounds not finite")
    print(f"[pathB] accuracy_bounds reram collab 0.1 (hidden 64, out 16, "
          f"S=8, 4 trials): {acc}", flush=True)


def bucketed_case(label, bplan, cfg, params, backend, ideal, device,
                  totals, ref=None, ref_exact=True, reps: int = 3) -> dict:
    """Refresh ``bplan`` (bucketed) on ``backend`` with both halo
    schedules, as ``GNNServer.refresh`` does (``make_forward`` once, then
    ``scatter`` of the forward's per-bucket outputs, which ends in the copy
    to the host); the overlapped embeddings must equal the serial ones bit
    for bit, and ``ref`` (global node order) exactly where ``ref_exact``,
    else within the serving tolerance. The launch counts are those of the
    first warm refresh; the times are the median of ``reps`` warm
    refreshes a mode, the two modes taking turns. Returns {mode: (warm
    refresh s, embeddings, counts)}."""
    c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
    plan = dataclasses.replace(bplan, backend=backend)
    n = plan.graph.n_nodes
    forwards = {mode: plan.make_forward(c, overlap=mode, device=device)
                for mode in ("overlap", "serial")}
    for forward in forwards.values():
        plan.scatter(forward(params))               # cold
    times = {mode: [] for mode in forwards}
    runs = {}
    for rep in range(reps):
        for mode, forward in forwards.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            emb = plan.scatter(forward(params))
            times[mode].append(time.perf_counter() - t0)
            counts = launch_counts()
            if rep:
                continue
            require(emb.shape == (n, cfg.out_dim)
                    and np.isfinite(emb).all(),
                    f"{label}: embedding shape or non-finite values")
            for k in EXPECTED.get((backend, ideal), ()):
                require(counts[k] > 0, f"{label} {mode}: {k} never "
                        f"launched on its path")
            for k, v in counts.items():
                totals[k] += v
            runs[mode] = [0.0, emb, counts]
    for mode in forwards:
        runs[mode][0] = float(np.median(times[mode]))
    del forwards
    same = np.array_equal(runs["overlap"][1], runs["serial"][1])
    require(same, f"{label}: overlap and serial schedules differ")
    got = runs["overlap"][1]
    text = ""
    if ref is not None:
        scale = float(np.abs(ref).max()) or 1.0
        diff = np.abs(got - ref)
        exact = bool(np.array_equal(got, ref))
        ok = exact if ref_exact else bool(
            (diff <= 1e-4 * scale + 1e-4 * np.abs(ref)).all())
        text = (f"; max|err| {float(diff.max()):.3e} "
                f"({'exact' if ref_exact else f'tol {1e-4 * scale:.3e}'}"
                f", equal bit for bit: {exact}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: the bucketed embeddings differ from the "
                f"reference")
    t_o, t_s = runs["overlap"][0], runs["serial"][0]
    print(f"[pathC] {label}: warm refresh (median of {reps}) overlap "
          f"{t_o * 1e3:.2f} ms, serial {t_s * 1e3:.2f} ms (overlap/serial "
          f"{t_o / t_s:.3f}); "
          f"overlap == serial bit for bit{text}; launches "
          f"{json.dumps({k: v for k, v in runs['overlap'][2].items() if v})}",
          flush=True)
    return runs


def layout_line(tag, plan, cfg, secs) -> dict:
    ls = plan.layout_stats(cfg)
    bp = plan.bucketed
    print(f"[pathC] {tag}: {plan.graph.n_nodes} nodes, {plan.n_clusters} "
          f"clusters in {bp.n_buckets} buckets, n_caps {bp.n_caps}, h_caps "
          f"{bp.h_caps}, s_caps {bp.s_caps}, clusters per bucket "
          f"{[len(cl) for cl in bp.clusters]}; host set-up {secs:.2f} s; "
          f"layout_stats {json.dumps(ls)}", flush=True)
    return ls


def path_c1(g01, device, totals: dict) -> None:
    """The bucketed layout at full width on collab at scale 0.1 (F 496 ->
    64 -> 16, S 8): decentralized on 16 edge-balanced clusters and semi on
    4 heads x 4 spokes, ``buckets="auto"``; every backend, ideal and
    bit-accurate, both halo schedules, against the dense plan on the same
    partition and backend (bit for bit, but the ``torch.matmul`` of the
    ``jnp``/``pallas`` ideal layer: serving tolerance)."""
    cfg = gnn.GNNConfig(in_dim=g01.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    params = gnn.init_params(cfg, seed=0, device=device)
    for setting, kw in (("decentralized", dict(n_clusters=16,
                                               partition_method="edge")),
                        ("semi", dict(n_clusters=4, spokes_per_head=4))):
        t0 = time.perf_counter()
        bplan = plan_execution(g01, setting, sample=SAMPLE, buckets="auto",
                               **kw)
        secs = time.perf_counter() - t0
        dense = plan_execution(g01, setting, sample=SAMPLE, **kw)
        layout_line(f"C1 collab 0.1 {setting}", bplan, cfg, secs)
        for backend in ("jnp", "pallas", "fused"):
            for ideal in (True, False):
                c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                    ideal=ideal))
                srv = GNNServer(dataclasses.replace(dense, backend=backend),
                                c, params=params, device=device)
                srv.refresh()
                t_dense = srv.refresh()
                ref = srv.embeddings
                del srv
                runs = bucketed_case(
                    f"C1 {setting:13s} {backend:6s} "
                    f"{'ideal' if ideal else 'bit-accurate':12s}", bplan,
                    cfg, params, backend, ideal, device, totals, ref=ref,
                    ref_exact=not (ideal and backend != "fused"))
                print(f"[pathC] C1 {setting} {backend} "
                      f"{'ideal' if ideal else 'bit-accurate'}: dense plan "
                      f"warm refresh {t_dense * 1e3:.2f} ms, bucketed "
                      f"{runs['overlap'][0] * 1e3:.2f} ms (overlap)",
                      flush=True)


# the million-node configuration of benchmarks/scale_serve.py's defaults
C2_NODES, C2_EDGES, C2_FEATURES = 1_000_000, 4_000_000, 16
C2_HIDDEN, C2_OUT, C2_CLUSTERS = 16, 8, 64


def path_c2(device, totals: dict) -> None:
    """The million-node configuration of ``benchmarks/scale_serve.py``
    (random_graph(1,000,000, 4,000,000, 16, seed=0), hidden 16, out 8, S 8,
    64 edge-balanced clusters, ``buckets="auto"``): ``fused`` and
    ``pallas``, ideal and bit-accurate, both halo schedules, against the
    bucketed ``jnp`` backend within the serving tolerance. The dense
    layout is priced by ``layout_stats`` only; the bucketed waste must be
    at most half of the dense waste."""
    t0 = time.perf_counter()
    g = random_graph(C2_NODES, C2_EDGES, C2_FEATURES,
                     seed=0).gcn_normalize()
    bplan = plan_execution(g, "decentralized", sample=SAMPLE,
                           n_clusters=C2_CLUSTERS, buckets="auto",
                           partition_method="edge")
    secs = time.perf_counter() - t0
    cfg = gnn.GNNConfig(in_dim=C2_FEATURES, hidden_dims=(C2_HIDDEN,),
                        out_dim=C2_OUT, sample=SAMPLE)
    ls = layout_line("C2 random 1M scale_serve", bplan, cfg, secs)
    waste, dense_waste = ls["padding_ratio"] - 1, ls["dense_padding_ratio"] - 1
    print(f"[pathC] C2 padding gate: bucketed waste {waste:.4f} <= 0.5 x "
          f"dense waste {dense_waste:.4f}: {waste <= 0.5 * dense_waste}",
          flush=True)
    require(waste <= 0.5 * dense_waste, "C2: bucketed padding waste above "
            "half of the dense layout's")
    params = gnn.init_params(cfg, seed=0, device=device)
    for ideal in (True, False):
        ref_runs = bucketed_case(
            f"C2 jnp    {'ideal' if ideal else 'bit-accurate':12s}", bplan,
            cfg, params, "jnp", ideal, device, totals)
        ref = ref_runs["overlap"][1]
        for backend in ("pallas", "fused"):
            bucketed_case(
                f"C2 {backend:6s} {'ideal' if ideal else 'bit-accurate':12s}",
                bplan, cfg, params, backend, ideal, device, totals, ref=ref,
                ref_exact=False)


# the streaming path: D1 at collab 1.0, D2 at collab 0.1
D1_TICKS, D1_CHURN = 6, 0.001
D2_TICKS, D2_CHURN, D2_ADD, D2_REMOVE = 4, 0.01, 16, 4
PATH_D = ("fused_ideal_layer", "csr_aggregate", "cam_search", "fused_zmax",
          "fused_quant_layer")
D_SPANS = ("engine.apply_deltas", "engine.frontier", "engine.dirty_rows")


def own_feats(plan):
    """``plan`` with copies of its feature tables: the streaming engine
    writes the mutated rows into the plan it serves, in place."""
    feats = (tuple(f.copy() for f in plan.feats)
             if isinstance(plan.feats, tuple) else plan.feats.copy())
    return dataclasses.replace(plan, feats=feats)


def churn_rows(rng, g, frac):
    n = max(int(g.n_nodes * frac), 1)
    return (rng.choice(g.n_nodes, n, replace=False),
            rng.normal(size=(n, g.feature_len)).astype(np.float32))


def close(got, ref, rtol: float) -> tuple:
    """(ok, max|err|, tolerance at max|ref|) at atol 1e-4 * max|ref|."""
    scale = float(np.abs(ref).max()) or 1.0
    diff = np.abs(got - ref)
    ok = bool(got.shape == ref.shape and np.isfinite(got).all()
              and (diff <= 1e-4 * scale + rtol * np.abs(ref)).all())
    return ok, float(diff.max()), 1e-4 * scale


def path_d1(plan_c, cfg, params, device, d_totals: dict) -> None:
    """The streaming path at full width: centralized collab 1.0 on
    ``fused``, ideal numerics, policy ``eager``, the ``cam-pallas``
    frontier; a cold refresh and D1_TICKS ticks of feature churn, then the
    checks against a fresh forward of the shared plan, the frontier modes
    against each other, and one bit-accurate commit against a
    ``GNNServer`` refresh."""
    g = plan_c.graph
    nbytes = g.features.nbytes
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        g.features.copy()
        copies.append(time.perf_counter() - t0)
    print(f"[pathD] D1 host copy of the feature table ({nbytes / 1e6:.1f} "
          f"MB, what apply_deltas and the server's live view copy each "
          f"commit): median of 3 {np.median(copies) * 1e3:.1f} ms",
          flush=True)
    plan = own_feats(dataclasses.replace(plan_c, backend="fused"))
    last = {}

    def stream():
        t0 = time.perf_counter()
        srv = StreamingGNNServer(plan, cfg, params=params, policy="eager",
                                 frontier_mode="cam-pallas", device=device)
        t_set = time.perf_counter() - t0
        t_cold = srv.refresh()
        print(f"[pathD] D1 collab 1.0 centralized fused ideal eager "
              f"cam-pallas: server set-up {t_set:.2f} s (host), cold full "
              f"refresh {t_cold * 1e3:.1f} ms", flush=True)
        rng = np.random.default_rng(17)
        tel.enable()
        try:
            for tick in range(D1_TICKS):
                nodes, rows = churn_rows(rng, g, D1_CHURN)
                tel.reset()
                cam0 = launch_counts()["cam_search"]
                upd = srv.ingest(nodes=nodes, rows=rows)
                cams = launch_counts()["cam_search"] - cam0
                spans = tel.snapshot()["spans"]
                require(upd is not None and not upd.full,
                        "D1: an eager tick did not commit incrementally")
                parts = {k: spans[k]["total_s"] for k in D_SPANS}
                commit = spans["server.commit"]["total_s"]
                rest = commit - sum(parts.values())
                last["dirty"] = upd.frontier.masks[0]
                print(f"[pathD] D1 tick {tick}: {len(nodes)} rows, commit "
                      f"{upd.seconds * 1e3:.1f} ms (engine), server.commit "
                      f"{commit * 1e3:.1f} ms = "
                      + ", ".join(f"{k.split('.')[1]} {v * 1e3:.1f}"
                                  for k, v in parts.items())
                      + f", rest (live-view copy, scatter) "
                      f"{rest * 1e3:.1f} ms; recompute fraction "
                      f"{upd.recompute_fraction:.5f}, dirty rows by level "
                      f"{upd.frontier.counts().tolist()}; cam_search calls "
                      f"{cams}", flush=True)
        finally:
            tel.disable()
            tel.reset()
        return srv

    srv = counted("D1 streaming ticks", stream,
                  {"fused_ideal_layer": None, "cam_search": None}, d_totals)
    served = srv.embeddings
    require(served.shape == (g.n_nodes, cfg.out_dim)
            and np.isfinite(served).all(), "D1: embeddings")
    require(plan.graph is srv.engine.graph, "D1: the plan does not track "
            "the live graph")
    for backend in ("fused", "jnp"):
        fresh = dataclasses.replace(plan, backend=backend)
        ref = fresh.scatter(fresh.make_forward(cfg, device=device)(params))
        ok, err, tol = close(served, ref, 1e-4)
        print(f"[pathD] D1 served after {D1_TICKS} ticks vs a fresh "
              f"make_forward of the shared plan on {backend}: max|err| "
              f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}; equal "
              f"bit for bit: {np.array_equal(served, ref)}", flush=True)
        require(ok, f"D1: incremental embeddings differ from {backend}")
    fd = last["dirty"]
    nbr, wts = srv.engine._gnbr, srv.engine._gwts
    fronts = {}
    for mode in ("numpy", "cam", "cam-pallas"):
        t0 = time.perf_counter()
        fronts[mode] = expand_frontier(nbr, wts, fd, np.zeros_like(fd), 2,
                                       mode=mode, device=device).masks
        print(f"[pathD] D1 frontier of tick {D1_TICKS - 1} on {mode}: "
              f"{time.perf_counter() - t0:.3f} s (host clock), counts "
              f"{fronts[mode].sum(axis=1).tolist()}", flush=True)
    same = all(np.array_equal(m, fronts["numpy"]) for m in fronts.values())
    print(f"[pathD] D1 frontier masks of numpy, cam and cam-pallas equal "
          f"bit for bit: {same}", flush=True)
    require(same, "D1: the frontier modes differ")
    del srv

    c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=False))

    def bit_accurate():
        srv = StreamingGNNServer(plan, c, params=params, policy="eager",
                                 frontier_mode="cam-pallas", device=device)
        srv.refresh()
        nodes, rows = churn_rows(np.random.default_rng(18), g, D1_CHURN)
        return srv, srv.ingest(nodes=nodes, rows=rows)
    srv, upd = counted("D1 bit-accurate commit", bit_accurate,
                       {"fused_zmax": None, "fused_quant_layer": None,
                        "cam_search": None}, d_totals)
    ref_srv = GNNServer(plan, c, params=params, device=device)
    ref_srv.refresh()
    exact = np.array_equal(srv.embeddings, ref_srv.embeddings)
    print(f"[pathD] D1 bit-accurate commit: full={upd.full}, "
          f"{upd.seconds * 1e3:.1f} ms; equal bit for bit to a GNNServer "
          f"refresh of the same plan: {exact}", flush=True)
    require(upd.full, "D1: a bit-accurate commit did not fall back to a "
            "full refresh")
    require(exact, "D1: the bit-accurate commit differs from GNNServer")


def d2_tick(srv, rng):
    """One D2 tick: feature churn at D2_CHURN, D2_ADD random edges added
    and D2_REMOVE edges of the live graph removed."""
    live = srv.engine.graph
    nodes, rows = churn_rows(rng, live, D2_CHURN)
    gone = rng.choice(live.n_edges, D2_REMOVE, replace=False)
    dst = np.searchsorted(live.indptr, gone, side="right") - 1
    return srv.ingest(nodes=nodes, rows=rows,
                      add_edges=(rng.integers(0, live.n_nodes, D2_ADD),
                                 rng.integers(0, live.n_nodes, D2_ADD)),
                      remove_edges=(dst, live.indices[gone]))


def path_d2(plans: dict, g01, cfg, params, device, d_totals: dict) -> None:
    """The exchange settings at collab 0.1 through ``StreamingGNNServer``
    on ``fused`` and ``pallas``, ideal numerics, policy ``interval``
    (every 2 ticks), D2_TICKS ticks of feature churn plus D2_ADD added and
    D2_REMOVE removed edges (so the plan's structure is rebuilt): the
    final embeddings against a centralized ``jnp`` forward of the mutated
    graph, the summed incremental traffic against the full exchange's
    bytes times the commits."""
    for (label, mode), base in plans.items():
        for backend in ("fused", "pallas"):
            plan = own_feats(dataclasses.replace(base, backend=backend))
            tag = f"D2 {label} {mode} {backend}"
            split = []

            def stream():
                srv = StreamingGNNServer(plan, cfg, params=params, mode=mode,
                                         policy="interval", interval=2,
                                         device=device)
                srv.refresh()
                rng = np.random.default_rng(23)
                tel.reset()
                tel.enable()
                try:
                    ups = [d2_tick(srv, rng) for _ in range(D2_TICKS)]
                    split[:] = [tel.snapshot()["spans"][k]["total_s"]
                                for k in ("server.commit", *D_SPANS)]
                finally:
                    tel.disable()
                    tel.reset()
                return srv, [u for u in ups if u is not None]
            t0 = time.perf_counter()
            srv, ups = counted(tag, stream, {
                "fused_ideal_layer" if backend == "fused"
                else "csr_aggregate": None}, d_totals)
            secs = time.perf_counter() - t0
            require(len(ups) == D2_TICKS // 2 and not any(u.full
                                                          for u in ups),
                    f"{tag}: not one incremental commit every 2 ticks")
            g = srv.engine.graph
            cent = plan_execution(g, "centralized", backend="jnp",
                                  sample=SAMPLE)
            ref = cent.scatter(cent.make_forward(cfg, device=device)(params))
            ok, err, tol = close(srv.embeddings, ref, 0.0)
            inc = sum(u.traffic.total_bytes() for u in ups)
            full = plan.measured_traffic(srv.cfg, mode=mode).total_bytes()
            print(f"[pathD] {tag}: {len(ups)} commits in {secs:.2f} s (host, "
                  f"set-up included), commit "
                  + "/".join(f"{u.seconds * 1e3:.1f}" for u in ups)
                  + " ms (engine; server.commit "
                  + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in zip(
                      ("total", "apply_deltas with the structure rebuild",
                       "frontier", "dirty_rows"), split))
                  + " ms over both), recompute fraction "
                  + "/".join(f"{u.recompute_fraction:.4f}" for u in ups)
                  + f"; vs centralized jnp of the mutated graph ({g.n_edges} "
                  f"edges) max|err| {err:.3e} (tol {tol:.3e}) "
                  f"{'ok' if ok else 'FAIL'}; incremental traffic {inc:,} B "
                  f"<= full {full:,} B x {len(ups)} commits: "
                  f"{inc <= full * len(ups)}", flush=True)
            require(ok, f"{tag}: embeddings differ from the centralized "
                    f"forward")
            require(inc <= full * len(ups), f"{tag}: incremental traffic "
                    f"above the full exchange's")


def refresh_window(trace_path: str) -> tuple | None:
    """(window us, kernel us, copy us) of the ``server.refresh`` range in a
    ``torch.profiler`` chrome trace: the device time of the kernels and
    memory copies that start inside the range, clipped to it; None where
    the trace holds no kernel."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    win = [e for e in events if e.get("name") == "server.refresh"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    busy = {"kernel": 0.0, "gpu_memcpy": 0.0}
    for e in events:
        cat = e.get("cat")
        if cat in busy and lo <= float(e["ts"]) <= hi:
            busy[cat] += min(float(e["ts"]) + float(e["dur"]), hi) \
                - float(e["ts"])
    if not busy["kernel"]:
        return None
    return hi - lo, busy["kernel"], busy["gpu_memcpy"]


def trace_refresh(plan_c, cfg, params, device) -> None:
    """One warm ``GNNServer`` refresh of centralized collab 1.0 on
    ``fused``, ideal and bit-accurate, with the port's telemetry on: the
    span split (``server.refresh``; ``plan.forward`` closed by its device
    sync; the rest, ``scatter`` and its copy to the host), then the same
    refresh under ``torch.profiler`` with the spans mirrored into
    ``record_function``: the device-busy share of the ``server.refresh``
    window (kernel time over the window's length)."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for ideal in (True, False):
        name = "ideal" if ideal else "bit-accurate"
        c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
        srv = GNNServer(dataclasses.replace(plan_c, backend="fused"), c,
                        params=params, device=device)
        srv.refresh()
        t_off = srv.refresh()
        tel.reset()
        tel.enable()
        try:
            t = srv.refresh()
            spans = tel.snapshot()["spans"]
        finally:
            tel.disable()
        r = spans["server.refresh"]["total_s"]
        f = spans["plan.forward"]["total_s"]
        sync = spans["plan.forward.sync"]["total_s"]
        print(f"[trace] centralized collab 1.0 fused {name} warm refresh "
              f"{t * 1e3:.3f} ms (telemetry off just before: "
              f"{t_off * 1e3:.3f} ms): server.refresh {r * 1e3:.3f} ms = "
              f"plan.forward {f * 1e3:.3f} ms (launches {(f - sync) * 1e3:.3f}"
              f" ms on the host, then its device sync {sync * 1e3:.3f} ms) "
              f"+ scatter and copy to the host {(r - f) * 1e3:.3f} ms",
              flush=True)
        path = os.path.join(out_dir, f"refresh_trace_{name}.json")
        window = None
        for attempt in range(3):
            tel.reset()
            tel.enable(profiler_annotations=True)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    srv.refresh()
            finally:
                tel.disable()
            prof.export_chrome_trace(path)
            window = refresh_window(path)
            if window is not None:
                break
        if window is None:
            print(f"[trace] {name}: device-busy share not measured (the "
                  f"profiler's trace held no kernel in the window, 3 tries)",
                  flush=True)
            continue
        span, kern, copy = window
        print(f"[trace] {name} under torch.profiler: server.refresh window "
              f"{span / 1e3:.3f} ms, kernels {kern / 1e3:.3f} ms "
              f"(device-busy share {kern / span:.3f}), device-to-host copy "
              f"{copy / 1e3:.3f} ms ({copy / span:.3f}); trace "
              f"chiprun_out/{os.path.basename(path)}", flush=True)
        del srv
    tel.reset()


# ------------------------------------------------------------------ path E


def event_ms(fn) -> float:
    """The tuner's protocol: min CUDA-event ms of 3 calls after one."""
    return 1e3 * time_callable(fn, iters=3, warmup=1)


def candidate_sweep(label: str, geom, run, card: str) -> int:
    """E1: every candidate of ``geom``, run by ``run(config)``, equal to
    the default launch (candidate #0) with ``torch.equal``; prints each
    candidate's CUDA-event ms."""
    cands = candidates(geom)
    ref = run(cands[0])
    ref = ref if isinstance(ref, tuple) else (ref,)
    times = []
    for c in cands:
        out = run(c)
        out = out if isinstance(out, tuple) else (out,)
        require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                f"E1 {label}: candidate {c} differs from the default launch")
        times.append(f"{tuple(c.as_dict().values())} "
                     f"{event_ms(lambda: run(c)):.4f}")
    print(f"[pathE] E1 {label}: {len(cands)} candidates equal to the "
          f"default launch bit for bit; ms (candidate #0 first): "
          f"{'; '.join(times)} ({card})", flush=True)
    return len(cands)


def layer_sweeps(tag, x, nbr, wts, w, b, card, numerics=None,
                 noise=None) -> int:
    """E1 at one layer's shape: the ideal layer, the quant layer (its launch
    alone, on the numerics' programmed codes), the aggregation and the
    crossbar (on the DAC codes of Z); ``numerics`` set: only the two
    bit-accurate kernels."""
    nd, s = nbr.shape
    n, f = x.shape
    h = w.shape[1]
    swept = 0
    if numerics is None:
        swept += candidate_sweep(
            f"{tag} fused_ideal_layer", FusedGeometry(nd, n, f, h, s, True),
            lambda c: fl.fused_ideal_layer(x, nbr, wts, w, b, relu=True,
                                           config=c), card)
        swept += candidate_sweep(
            f"{tag} csr_aggregate", AggregateGeometry(nd, n, f, s),
            lambda c: csr_aggregate(x, nbr, wts, config=c), card)
    cfg = CrossbarNumerics(**(numerics or {}))
    zmax = fl.fused_zmax(x, nbr, wts)
    codes, scales = fl.quant_operands(zmax, w, cfg, noise)
    swept += candidate_sweep(
        f"{tag} fused_quant_layer",
        FusedGeometry(nd, n, f, h, s, False, cfg.rows_per_xbar),
        lambda c: fl.fused_quant_layer(x, nbr, wts, codes, b, scales, cfg,
                                       relu=True, config=c), card)
    xq, _ = xb.quantize_inputs(torch.clamp_min(
        csr_aggregate_ref(x, nbr, wts), 0.0), cfg)
    swept += candidate_sweep(
        f"{tag} crossbar_matmul_quantized",
        CrossbarGeometry(nd, f, h, cfg.rows_per_xbar, cfg.in_bits),
        lambda c: xb.crossbar_matmul_programmed(xq, codes, cfg, config=c),
        card)
    return swept


def path_e1(x1, x2, nbr, wts, params, plan_b, device, card) -> None:
    """E1: every tuning candidate of every kernel equals the default launch
    at collab 1.0's layers 1 and 2, at C1's largest bucket, at the repaired
    deep shapes (F 3,703 at 48 and 64 rows, 8- and 16-bit DAC codes, clean
    and ReRAM-noisy; 13-bit conductance codes) and at the CAM's k-NN and
    frontier launches."""
    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(device)
    for name, want in (("shared_memory_per_block_optin", H100.smem_bytes),
                       ("shared_memory_per_multiprocessor",
                        H100.sm_smem_bytes)):
        got = getattr(props, name, None)
        require(got in (None, want), f"E1: the card's {name} is {got}, "
                f"the launch plans assume {want}")
        print(f"[pathE] E1 the launch plans' {name} {want}, the card's "
              f"{'not reported' if got is None else got}", flush=True)
    gen = torch.Generator(device=device).manual_seed(17)
    swept = 0
    for tag, x, layer in (("layer1 496->64", x1, params[0]),
                          ("layer2 64->16", x2, params[1])):
        swept += layer_sweeps(tag, x, nbr, wts, layer["w"], layer["b"], card)
    bp = plan_b.bucketed
    big = max(range(bp.n_buckets), key=lambda i: bp.n_caps[i])
    nd, n, s = bp.n_caps[big], bp.n_caps[big] + bp.h_caps[big], \
        bp.s_caps[big]
    for f, layer in ((x1.shape[1], params[0]), (x2.shape[1], params[1])):
        xb_ = torch.randn((n, f), generator=gen, device=device)
        nb = torch.randint(0, n, (nd, s), generator=gen, device=device,
                           dtype=torch.int32)
        wb = torch.rand((nd, s), generator=gen, device=device)
        wb[:, s // 2:] = 0.0                   # padding slots
        swept += layer_sweeps(f"C1 bucket {nd}x{s} of {n} rows F={f}", xb_,
                              nb, wb, layer["w"], layer["b"], card)
    deep = deep_inputs(device, 11)
    nbr_w = torch.remainder(nbr[:3000], 4000)
    wts_w = wts[:3000].contiguous()
    x, w, b = deep[3703]
    for numerics in (dict(rows_per_xbar=48), dict(rows_per_xbar=64),
                     dict(in_bits=16, rows_per_xbar=48),
                     dict(in_bits=16, rows_per_xbar=64),
                     dict(in_bits=16, w_bits=13, rows_per_xbar=64)):
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            swept += layer_sweeps(
                f"3000 rows 3703->64 {numerics_tag(numerics)} "
                f"noisy={noisy}", x, nbr_w, wts_w, w, b, card,
                numerics=numerics, noise=nz)
    entries, queries = cam_inputs(device)
    swept += candidate_sweep(
        f"cam_search k-NN Q={queries.shape[0]} E={entries.shape[0]}",
        CamGeometry(entries.shape[0], queries.shape[0]),
        lambda c: cam_search(entries, queries, config=c), card)
    ci = torch.randint(0, 400, (525,), generator=gen, device=device,
                       dtype=torch.int32)
    qs = torch.randint(-1, 400, (45_100,), generator=gen, device=device,
                       dtype=torch.int32)
    swept += candidate_sweep("cam_search frontier Q=45100 E=525",
                             CamGeometry(525, 45_100),
                             lambda c: cam_search(ci, qs, config=c), card)
    print(f"[pathE] E1: {swept} candidate launches, all equal to their "
          f"default launch; {time.perf_counter() - t0:.1f} s", flush=True)


def _refuse_measure(geom, config):
    raise RuntimeError(f"E2: a cached geometry was measured again: {geom}")


def confirm_winner(label, geom, winner, tables, device, card) -> None:
    """E2: a winner that took the default's place, timed again beside the
    default on the same tables in turns (default, winner, winner,
    default), is no slower than the default within this run's spread: its
    fastest timing is at most the default's slowest."""
    default = default_config(geom)
    fn = measurer(seed=1, iters=3, warmup=1, device=device, tables=tables)
    t = {default: [], winner: []}
    for c in (default, winner, winner, default):
        t[c].append(1e3 * fn(geom, c))
    require(min(t[winner]) <= max(t[default]),
            f"E2 {label}: winner {winner} slower than the default "
            f"({t[winner]} against {t[default]} ms)")
    print(f"[pathE] E2 {label} {geom.key()[1:]}: retimed in turns, default "
          f"{' / '.join(f'{v:.4f}' for v in t[default])} ms, winner "
          f"{' / '.join(f'{v:.4f}' for v in t[winner])} ms ({card})",
          flush=True)


def path_e2(plan_c, plan_b, cfg, params, device, card) -> None:
    """E2: ``tune_kernels`` on the card for centralized collab 1.0 on
    ``fused`` (ideal and bit-accurate) and ``pallas``, and C1's bucketed
    plan on ``fused``, into one ``TuneCache`` in a temporary file, each
    geometry timed on the plan's own tables; each winner that took the
    default's place retimed beside it in turns and no slower within the
    run's spread; a second ``tune_kernels`` answered from the cache with no
    measurement and no launch; a ``GNNServer`` refresh with the tuned plan
    equal to the untuned refresh bit for bit."""
    t0 = time.perf_counter()
    platform = tuning.current_platform(device)
    quant = dataclasses.replace(cfg, numerics=CrossbarNumerics())
    cases = (("centralized collab 1.0 fused ideal", plan_c, "fused", cfg),
             ("centralized collab 1.0 fused bit-accurate", plan_c, "fused",
              quant),
             ("centralized collab 1.0 pallas ideal", plan_c, "pallas", cfg),
             ("C1 bucketed 16 fused ideal", plan_b, "fused", cfg))
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuneCache(os.path.join(tmp, "tuned_configs_torch.json"))
        for label, base, backend, c in cases:
            plan = dataclasses.replace(base, backend=backend, tuned=None,
                                       mapping=None)
            registry.clear()
            untuned = GNNServer(plan, c, params=params, device=device)
            untuned.refresh()
            t1 = time.perf_counter()
            tuned = plan.tune_kernels(c, cache=cache, device=device,
                                      iters=3, warmup=1)
            t_tune = time.perf_counter() - t1
            geoms = plan_geometries(plan, plan.gnn_config(c))
            require(len(tuned) == len({g.key() for g in geoms}) > 0,
                    f"E2 {label}: {len(tuned)} tuned geometries")
            tables = plan_tables(plan)
            for geom in dict.fromkeys(geoms):
                rec = cache.entries["|".join(
                    str(v) for v in (*geom.key(), platform))]
                winner = tuned.lookup(geom.key())
                print(f"[pathE] E2 {label} {geom.kernel} {geom.key()[1:]}: "
                      f"default {rec['default_s'] * 1e3:.4f} ms, fastest "
                      f"of {rec['n_measured']} "
                      f"{tuple(rec['fastest'].values())} lead "
                      f"{rec['lead_s'] * 1e3:.4f} ms, spread "
                      f"{rec['spread_s'] * 1e3:.4f} ms: winner "
                      f"{tuple(rec['config'].values())} "
                      f"{rec['measured_s'] * 1e3:.4f} ms ({card})",
                      flush=True)
                if winner != default_config(geom):
                    confirm_winner(label, geom, winner,
                                   tables[(geom.nd, geom.n, geom.sample)],
                                   device, card)
            before = launch_counts()
            again = plan.tune_kernels(c, cache=cache, device=device,
                                      measure_fn=_refuse_measure)
            require(again == tuned and launch_counts() == before,
                    f"E2 {label}: the rerun did not answer from the cache")
            served = GNNServer(plan, c, params=params, device=device)
            served.refresh()
            require(np.array_equal(served.embeddings, untuned.embeddings),
                    f"E2 {label}: the tuned refresh differs from the "
                    f"untuned one")
            print(f"[pathE] E2 {label}: {len(tuned)} geometries tuned in "
                  f"{t_tune:.1f} s on the plan's tables; rerun from the "
                  f"cache, no measurement; tuned refresh equal to the "
                  f"untuned one bit for bit", flush=True)
        print(f"[pathE] E2: cache of {len(cache)} entries; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    registry.clear()


def path_e3(plan_c, cfg, device, card) -> None:
    """E3: ``devices.calibrate`` on the card into a temporary file, loaded
    back strictly, and the derived cost model and the mapper on it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "host_calibration_torch.json")
        cal = devices.calibrate(path, device=device)
        require(cal.platform == "cuda:" + torch.cuda.get_device_name(0)
                and "H100" in cal.platform,
                f"E3: calibration platform {cal.platform!r}")
        require(devices.load_calibration(path, device=device) == cal,
                "E3: the calibration did not load back")
    m = plan_c.predicted_metrics(mode="derived", calibration=cal)
    mapping = plan_c.compile_mapping(cfg, calibration=cal)
    require(all(np.isfinite(v) and v > 0 for v in (
        m.t_compute, m.t_communicate, mapping.t_compute, mapping.energy_j)),
        "E3: derived prediction not finite")
    print(f"[pathE] E3 calibration {cal.platform}: t_cam "
          f"{cal.t_cam * 1e3:.4f} ms, t_agg {cal.t_agg * 1e3:.4f} ms, t_fx "
          f"{cal.t_fx * 1e3:.4f} ms ({card}); derived on it: T_compute "
          f"{m.t_compute:.3e} s (modeled device), mapper "
          f"{mapping.t_compute:.3e} s", flush=True)


def path_e4(device) -> None:
    """E4: the CLI with --tune --mapping --tech reram on centralized collab
    0.1; its cost-model and mapper lines equal what the same plan prints in
    this process."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--setting", "centralized", "--dataset", "collab",
                "--scale", "0.1", "--tune", "--tune-cache",
                os.path.join(tmp, "tuned.json"), "--mapping", "--tech",
                "reram"]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.gnn",
                              *argv], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=600)
        require(out.returncode == 0, f"E4: the CLI failed:\n{out.stderr}")
    lines = out.stdout.splitlines()
    g = dataset_like("collab", scale=0.1, seed=0).gcn_normalize()
    plan = plan_execution(g, "centralized", backend="fused", sample=SAMPLE)
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    args = argparse.Namespace(setting="centralized", tech="reram",
                              mapping=True, dataset="collab")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.print_cost_model(args, g, plan, cfg, "reram")
    want = buf.getvalue().splitlines()
    require(lines[-len(want):] == want,
            "E4: the CLI's cost-model lines differ from the in-process ones")
    tuned_line = [ln for ln in lines if ln.startswith("tuned ")]
    require(len(tuned_line) == 1, "E4: no tuning line")
    print(f"[pathE] E4 CLI --tune --mapping --tech reram: exit 0, "
          f"{tuned_line[0]}; {want[0]}; {want[1]}; guideline line equal; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------------ path F

# the load loops of benchmarks/load_serve.py --auto: 64 requests of 16
# lookups a loop, a churn tick of 1 % of the rows every 4 requests; the
# planner's mixed workload prices the same 64 lookups a tick
F_REQUESTS, F_BATCH, F_TICK_EVERY, F_CHURN = 64, 16, 4, 0.01
F_MIXED = dict(churn=F_CHURN, queries_per_tick=F_BATCH * F_TICK_EVERY)
# F3: the drift set-up of tests/test_planner.py at collab 0.1
F3_QUIET, F3_SPIKE, F3_MAX_SPIKES = 4, 0.9, 8
PATH_F = ("fused_ideal_layer", "cam_search")
# the kernel each backend the planner can pick launches (the default
# candidate space offers ``fused`` only; ``jnp`` launches none)
BACKEND_KERNEL = {"fused": "fused_ideal_layer", "pallas": "csr_aggregate"}


def path_f1(g) -> None:
    """F1: ``plan`` model-only on the paper's statistics under the three
    objectives and a static and a mixed workload, each recommendation the
    exhaustive argmin of ``score_candidate``; then the CLI's measured
    phase on the concrete collab 1.0 graph."""
    t0 = time.perf_counter()
    n_plans = 0
    for name, st in {"taxi": TAXI_STATS, **TABLE2_DATASETS}.items():
        for wl_name, wl in (("static", WorkloadProfile()),
                            ("mixed", WorkloadProfile(**F_MIXED))):
            recs = []
            for objective in OBJECTIVES:
                r = plan(st, objective, wl, shortlist=0)
                ctx = PlanContext(st, wl)
                best = min((score_candidate(c, ctx, objective)
                            for c in candidate_space(st, workload=wl)),
                           key=lambda s: s.sort_key)
                require(best.candidate == r.recommended.candidate
                        and best.score == r.recommended.score,
                        f"F1 {name} {wl_name} {objective}: the "
                        f"recommendation is not the exhaustive argmin")
                recs.append(f"{objective} {r.recommended.candidate.key}")
                n_plans += 1
                if (name, wl_name, objective) == ("taxi", "mixed",
                                                  "throughput"):
                    require(r.recommended.candidate.setting == "semi",
                            "F1: the taxi mixed workload does not "
                            "recommend semi")
            print(f"[pathF] F1 {name} {wl_name}: {len(r.scored)} "
                  f"candidates; " + "; ".join(recs), flush=True)
    print(f"[pathF] F1 {n_plans} model-only plans, each the exhaustive "
          f"argmin of score_candidate: {time.perf_counter() - t0:.2f} s "
          f"(host)", flush=True)
    wl = WorkloadProfile(**F_MIXED, sample=SAMPLE)
    t0 = time.perf_counter()
    model = plan(g, "throughput", wl, shortlist=0)
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    measured = plan(g, "throughput", wl, shortlist=2)
    t_measured = time.perf_counter() - t0
    rec = measured.recommended
    require([s.candidate.key for s in model.scored]
            == [s.candidate.key for s in measured.scored]
            and "bytes_full_refresh" in rec.metrics,
            "F1: the measured phase did not run or changed the ranking")
    m = rec.metrics
    print(f"[pathF] F1 collab 1.0 ({g.n_nodes} nodes), throughput, churn "
          f"{F_CHURN}, {wl.queries_per_tick:.0f} lookups a tick: "
          f"recommended {rec.candidate.key}, {len(measured.frontier)} of "
          f"{len(measured.scored)} on the frontier; model phase "
          f"{t_model:.2f} s, with the measured phase over a shortlist of 2 "
          f"{t_measured:.2f} s (host); measured bytes a full refresh "
          f"{m['bytes_full_refresh']:,.0f}, a tick "
          f"{m.get('bytes_per_tick', 0.0):,.0f}, padding ratio "
          f"{m['padding_ratio']:.3f}, peak device bytes (layout) "
          f"{m['peak_device_bytes']:,.0f}", flush=True)


def f_tick(srv, rng, frac: float = F_CHURN):
    nodes, rows = churn_rows(rng, srv.engine.graph, frac)
    return srv.ingest(nodes=nodes, rows=rows)


def closed_loop(srv, rng, monitor=None) -> dict:
    """One client, batches back to back: latency is service time."""
    lats, served = [], 0
    t0 = time.perf_counter()
    for i in range(F_REQUESTS):
        if i % F_TICK_EVERY == 0:
            f_tick(srv, rng)
        ids = rng.integers(0, srv.engine.graph.n_nodes, F_BATCH)
        t = time.perf_counter()
        served += len(srv.query(ids))
        lats.append(time.perf_counter() - t)
        if monitor is not None:
            monitor.note_queries(F_BATCH)
    wall = time.perf_counter() - t0
    return dict(lats=lats, served=served, wall=wall, qps=served / wall)


def open_loop(srv, rng, rate: float, monitor=None) -> dict:
    """Poisson arrivals at ``rate`` batches a second on a virtual clock:
    a request starts when it arrives or when the server is free, and its
    latency includes the wait (commits block the serving thread)."""
    arrivals = np.cumsum(rng.exponential(1.0 / rate, F_REQUESTS))
    free, lats, served = 0.0, [], 0
    for i, arr in enumerate(arrivals):
        if i % F_TICK_EVERY == 0:
            t = time.perf_counter()
            f_tick(srv, rng)
            free = max(free, arr) + (time.perf_counter() - t)
        ids = rng.integers(0, srv.engine.graph.n_nodes, F_BATCH)
        start = max(arr, free)
        t = time.perf_counter()
        served += len(srv.query(ids))
        free = start + (time.perf_counter() - t)
        lats.append(free - arr)
        if monitor is not None:
            monitor.note_queries(F_BATCH)
    return dict(lats=lats, served=served)


def percentiles(lats) -> tuple:
    return tuple(float(v) for v in np.percentile(
        np.asarray(lats, np.float64) * 1e3, [50, 95, 99]))


def fresh_jnp(srv, cfg, params, device) -> np.ndarray:
    """A centralized ``jnp`` forward of the server's live graph."""
    cent = plan_execution(srv.engine.graph, "centralized", backend="jnp",
                          sample=SAMPLE)
    return cent.scatter(cent.make_forward(cfg, device=device)(params))


def f2_config(label, plan_, policy, cfg, params, device, f_totals,
              result=None) -> None:
    """One configuration under the closed and then the open loop on the
    ``cam-pallas`` frontier; with ``result``, a ``ReplanMonitor`` of it
    attached."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box = {}

    def serve():
        srv = StreamingGNNServer(plan_, cfg, params=params, policy=policy,
                                 frontier_mode="cam-pallas", device=device)
        mon = (ReplanMonitor(result).attach(srv) if result is not None
               else None)
        box["cold"] = srv.refresh()
        rng = np.random.default_rng(29)
        box["closed"] = closed_loop(srv, rng, mon)
        box["rate"] = 0.8 * F_REQUESTS / box["closed"]["wall"]
        box["open"] = open_loop(srv, rng, box["rate"], mon)
        box["loop_commits"] = srv.commits - 1
        srv.flush()
        return srv, mon
    srv, mon = counted(f"F2 {label}", serve, {k: None for k in PATH_F},
                       f_totals)
    peak = torch.cuda.max_memory_allocated()
    closed, opened = box["closed"], box["open"]
    cp, op = percentiles(closed["lats"]), percentiles(opened["lats"])
    ref = fresh_jnp(srv, cfg, params, device)
    ok, err, tol = close(srv.embeddings, ref, 0.0)
    ls = srv.plan.layout_stats()
    served = closed["served"] + opened["served"]
    print(f"[pathF] F2 {label}: cold refresh {box['cold'] * 1e3:.1f} ms; "
          f"closed {closed['qps']:.0f} lookups/s, p50/p95/p99 "
          + "/".join(f"{v:.3f}" for v in cp) + " ms; open at "
          f"{box['rate']:.1f} requests/s p50/p95/p99 "
          + "/".join(f"{v:.3f}" for v in op) + f" ms; {served} lookups, "
          f"{srv.commits} commits ({box['loop_commits']} in the loops, "
          f"{srv.full_refreshes} full), "
          f"{len(mon.events) if mon is not None else 0} re-plans; padding "
          f"ratio {ls['padding_ratio']:.3f}, peak device bytes "
          f"{ls['peak_device_bytes']:,} (layout), "
          f"{peak / 1e6:.1f} MB allocated at most on the card; vs jnp of "
          f"the mutated graph max|err| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(served == 2 * F_REQUESTS * F_BATCH,
            f"F2 {label}: {served} lookups served")
    require(cp[0] <= cp[1] <= cp[2] and op[0] <= op[1] <= op[2],
            f"F2 {label}: percentiles not monotone")
    require(box["loop_commits"] >= 1, f"F2 {label}: no commit in the loops")
    require(ok, f"F2 {label}: embeddings differ from the fresh forward")


def path_f2(g01, plan_d, plan_s, cfg, params, device, f_totals) -> None:
    """F2: the load loops on ``fused`` for centralized, decentralized 8
    and semi 4 x 4 at collab 0.1, then the planner's recommendation with
    a ``ReplanMonitor`` attached."""
    for label, base in (
            ("centralized", plan_execution(g01, "centralized",
                                           sample=SAMPLE)),
            ("decentralized 8", plan_d), ("semi 4x4", plan_s)):
        f2_config(f"{label} fused eager",
                  own_feats(dataclasses.replace(base, backend="fused")),
                  "eager", cfg, params, device, f_totals)
    t0 = time.perf_counter()
    result = plan(g01, "throughput", WorkloadProfile(**F_MIXED,
                                                     sample=SAMPLE),
                  shortlist=2)
    rec = result.recommended.candidate
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_auto = own_feats(result.build_plan(g01))
    print(f"[pathF] F2 planner at collab 0.1: {rec.key} (plan {t_plan:.2f} "
          f"s, build {time.perf_counter() - t0:.2f} s, host)", flush=True)
    f2_config(f"planner {rec.key}", plan_auto, rec.policy, cfg, params,
              device, f_totals, result=result)


def param_tensors(srv) -> list:
    return [t for layer in srv.params for t in layer.values()]


def check_swap(tag, srv, mon, params, tensors, cfg, device, f_totals,
               backend_kernel: str) -> None:
    """After a swap: the server's and the new engine's parameters are the
    same tensors on the card; the first commit is a full refresh the
    ledger skips; the new backend's kernel launches; lookups equal a
    fresh ``jnp`` forward of the live graph."""
    require(srv.params is params and srv.engine.params is params
            and param_tensors(srv) == tensors
            and all(t.device.type == device.type for t in tensors),
            f"{tag}: the swap did not keep the parameter tensors")
    skipped = mon.ledger.full_skipped

    def after():
        rng = np.random.default_rng(37)
        for _ in range(2):
            f_tick(srv, rng)
        return srv.flush()
    first = counted(f"{tag} after the swap", after, {backend_kernel: None},
                    f_totals)
    require(first is not None and first.full
            and mon.ledger.full_skipped == skipped + 1,
            f"{tag}: the first commit after the swap is not a skipped full "
            f"refresh")
    ids = np.arange(srv.engine.graph.n_nodes)
    ok, err, tol = close(srv.query(ids), fresh_jnp(srv, cfg, params,
                                                   device), 0.0)
    print(f"[pathF] {tag}: serving {srv.plan.setting}/{srv.plan.backend} "
          f"on {srv.plan.n_clusters} clusters"
          + (f", bucketed ({srv.plan.bucketed.n_buckets} buckets)"
             if srv.plan.bucketed is not None else "")
          + f", policy {srv.policy}; parameters the same tensors on the "
          f"card; first commit after the swap full, {first.seconds * 1e3:.1f}"
          f" ms, skipped by the ledger; lookups vs jnp of the live graph "
          f"max|err| {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"{tag}: swapped embeddings differ from the fresh forward")


def timed_swaps(srv) -> list:
    """Record the host seconds of each ``srv.update_plan`` call."""
    secs, update = [], srv.update_plan

    def timed(plan_, cfg_=None):
        t0 = time.perf_counter()
        update(plan_, cfg_)
        secs.append(time.perf_counter() - t0)
    srv.update_plan = timed
    return secs


def path_f3(g01, cfg, params, device, f_totals) -> None:
    """F3: a pinned decentralized ``pallas`` plan under ``eager``, a
    ``ReplanMonitor(window=2, tol=2.0, cooldown=1, shortlist=0)``, quiet
    ticks then churn spikes until drift re-plans and swaps the plan on the
    card; then F3b, a drift fed through ``observe`` with samples of the
    mixed workload, which swaps a pinned centralized server to the
    planner's bucketed recommendation."""
    wl = WorkloadProfile(churn=F_CHURN, queries_per_tick=0, sample=SAMPLE)
    pinned = plan(g01.stats("collab 0.1"), "throughput", workload=wl,
                  space=[Candidate("decentralized", "pallas", 8)])
    srv = StreamingGNNServer(pinned.build_plan(g01), cfg, params=params,
                             policy="eager", device=device)
    tensors = param_tensors(srv)
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    swaps, observed = timed_swaps(srv), []

    def observer(server, update):
        t0 = time.perf_counter()
        mon(server, update)
        observed.append(time.perf_counter() - t0)
    srv.add_observer(observer)
    rng = np.random.default_rng(31)

    def drive():
        srv.refresh()
        for _ in range(F3_QUIET):
            f_tick(srv, rng)
        require(not mon.events, "F3: drift during the quiet ticks")
        spikes = 0
        while not mon.events and spikes < F3_MAX_SPIKES:
            f_tick(srv, rng, F3_SPIKE)
            spikes += 1
        return spikes
    spikes = counted("F3 pinned decentralized 8 pallas", drive,
                     {"csr_aggregate": None}, f_totals)
    require(mon.events, f"F3: no drift after {spikes} ticks of "
            f"{F3_SPIKE} churn")
    ev = mon.events[0]
    new = mon.result
    print(f"[pathF] F3 event at commit {ev.tick} after {spikes} spike "
          f"ticks: {ev.reason} measured {ev.measured:.6g} vs reference "
          f"{ev.reference:.6g} (tol {mon.tol}); measured churn "
          f"{ev.workload.churn:.4f}; {ev.old.key} -> {ev.new.key} "
          f"(score {new.recommended.score:.3e} s modeled, best "
          f"decentralized {new.best('decentralized').score:.3e} s), "
          f"swapped {ev.swapped}; host seconds: observer "
          f"{observed[-1]:.3f} (re-plan, the new plan's build, the swap), "
          f"swap (update_plan) {swaps[-1] if swaps else 0.0:.3f}",
          flush=True)
    require(ev.measured > ev.reference * mon.tol, "F3: event in band")
    require(ev.workload.churn > 4 * wl.churn,
            "F3: the measured churn is not above 4x the assumed")
    require((ev.new.setting, ev.new.n_clusters, ev.new.backend)
            != (ev.old.setting, ev.old.n_clusters, ev.old.backend),
            "F3: the re-plan kept the pinned configuration")
    require(ev.swapped and srv.plan.setting == ev.new.setting,
            "F3: the plan was not swapped")
    check_swap("F3", srv, mon, params, tensors, cfg, device, f_totals,
               BACKEND_KERNEL[ev.new.backend])
    del srv

    pinned = plan(g01.stats("collab 0.1"), "throughput",
                  workload=WorkloadProfile(**F_MIXED, sample=SAMPLE),
                  space=[Candidate("centralized", "fused", 1)])
    srv = StreamingGNNServer(own_feats(pinned.build_plan(g01)), cfg,
                             params=params, policy="eager", device=device)
    tensors = param_tensors(srv)
    swaps = timed_swaps(srv)
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    srv.refresh()
    t0 = time.perf_counter()
    for seconds in (0.01, 0.01, 0.05, 0.05):
        ev = mon.observe(CommitSample(seconds, 0.0, F_CHURN, queries=64,
                                      policy="eager"), server=srv)
    t_obs = time.perf_counter() - t0
    require(ev is not None and ev.swapped
            and ev.new.layout == "bucketed" and srv.plan.bucketed is not None,
            f"F3b: no swap to a bucketed plan ({ev})")
    print(f"[pathF] F3b injected drift: {ev.reason} {ev.measured:.3g} vs "
          f"{ev.reference:.3g}; {ev.old.key} -> {ev.new.key}; host seconds: "
          f"observe {t_obs:.3f} (re-plan, build, swap), swap "
          f"(update_plan) {swaps[-1]:.3f}", flush=True)
    srv.add_observer(mon)
    check_swap("F3b", srv, mon, params, tensors, cfg, device, f_totals,
               BACKEND_KERNEL[ev.new.backend])


def path_f4(g01) -> None:
    """F4: ``python -m repro_torch.launch.gnn --plan auto`` on collab 0.1,
    static and with ``--stream 8 --neighbor-mode cam-pallas`` (both at
    once); each one's ``planner[...]`` summary equals ``summary()`` of the
    same ``plan(...)`` call made here."""
    t0 = time.perf_counter()
    runs = {"static": ([], "latency", 0.0),
            "stream": (["--stream", "8", "--neighbor-mode", "cam-pallas"],
                       "throughput", 0.05)}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    try:
        for k, (extra, _, _) in runs.items():
            procs[k] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.gnn", "--plan",
                 "auto", "--dataset", "collab", "--scale", "0.1", *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
        want = {k: plan(g01, objective, WorkloadProfile(
                    churn=churn, queries_per_tick=16.0, sample=SAMPLE),
                    shortlist=2).summary().splitlines()
                for k, (_, objective, churn) in runs.items()}
        for k, p in procs.items():
            out, err = p.communicate(timeout=600)
            require(p.returncode == 0, f"F4 {k}: the CLI failed:\n{err}")
            lines = out.splitlines()
            require(lines[:len(want[k])] == want[k],
                    f"F4 {k}: the CLI's summary differs from the "
                    f"in-process one:\n{out}")
            served = [ln for ln in lines if ln.startswith(("served",
                                                           "plan:"))]
            print(f"[pathF] F4 CLI --plan auto {k}: exit 0; "
                  f"{want[k][1].strip()}; summary ({len(want[k])} lines) equal in-process; "
                  + "; ".join(served), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[pathF] F4 {time.perf_counter() - t0:.1f} s (both CLIs at once)",
          flush=True)


# ------------------------------------------------------------------ phase 4


def live_counts(nbr, wts) -> tuple:
    """(slots with a non-zero weight, distinct rows they read)."""
    live = wts != 0
    return int(live.sum()), int(torch.unique(nbr[live]).numel())


def bound(nbytes: int, t_ops: float) -> tuple:
    """(least ms, what bounds it): ``nbytes`` over the HBM rate against
    ``t_ops`` seconds of operations at their peak rate."""
    t_mem = nbytes / HBM_BPS
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def bounds(x, nbr, wts, h: int, in_bits: int) -> dict:
    """Least device ms on an H100 SXM for each kernel at these inputs:
    each input read once, each output written once, against the ops of
    the slots with a non-zero weight (the ideal layer's product as the
    three TF32 products of its 3xTF32 split). Returns {kernel: (ms,
    bound_by)}."""
    nd, s = nbr.shape
    f = x.shape[1]
    nnz, rows = live_counts(nbr, wts)
    read = rows * f * 4 + nd * s * 8          # gathered rows + tables
    gather_flops = 2 * nnz * f
    return {
        "csr_aggregate": bound(read + nd * f * 4, gather_flops / F32_FLOPS),
        "fused_zmax": bound(read + nd * 8,
                            (gather_flops + 2 * nd * f) / F32_FLOPS),
        "fused_ideal_layer": bound(     # 3xTF32: three TF32 products
            read + f * h * 4 + h * 4 + nd * h * 4,
            gather_flops / F32_FLOPS + 3 * 2 * nd * f * h / TF32_OPS),
        "fused_quant_layer": bound(
            read + f * h * 4 + h * 4 + 12 + nd * h * 4,
            gather_flops / F32_FLOPS
            + 2 * in_bits * 2 * nd * f * h / INT8_OPS),
    }


def zmax_composed(x, nbr, wts):
    """zmax composed of stock calls: the aggregation kernel, then the row
    max and min of Z."""
    z = csr_aggregate(x, nbr, wts)
    return torch.stack([torch.clamp_min(z.amax(dim=1), 0.0),
                        torch.clamp_min(-z.amin(dim=1), 0.0)], dim=1)


def ideal_composed(x, nbr, wts, w, b):
    """The ``pallas`` backend's ideal layer: the aggregation kernel, then
    one f32 matmul, the bias and the relu."""
    return torch.clamp_min(csr_aggregate(x, nbr, wts) @ w + b, 0.0)


def timings(x, nbr, wts, layer, tag: str, iters: int) -> dict:
    """Kernel, plain and library times at one layer's shapes; zmax and the
    ideal layer also by the device time of their launch alone (the
    profiler's kernel time) and beside their composed yardstick, which
    fusion has to beat (several calls, so no library call)."""
    cfg = CrossbarNumerics()
    w, b = layer["w"], layer["b"]
    codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nbr, wts), w,
                                      cfg)
    runs = {
        "csr_aggregate": (lambda: csr_aggregate(x, nbr, wts),
                          lambda: csr_aggregate_ref(x, nbr, wts)),
        "fused_zmax": (lambda: fl.fused_zmax(x, nbr, wts),
                       lambda: fl.fused_zmax_plain(x, nbr, wts)),
        "fused_ideal_layer": (
            lambda: fl.fused_ideal_layer(x, nbr, wts, w, b, relu=True),
            lambda: fl.fused_ideal_layer_plain(x, nbr, wts, w, b,
                                               relu=True)),
        "fused_quant_layer": (      # with the programming of the weights
            lambda: fl.fused_quant_layer(
                x, nbr, wts, fl.program_conductances(w, cfg), b, scales, cfg,
                relu=True),
            lambda: fl.fused_quant_layer_plain(x, nbr, wts, codes.wq, b,
                                               scales, cfg, relu=True)),
    }
    composed = {"fused_zmax": lambda: zmax_composed(x, nbr, wts),
                "fused_ideal_layer": lambda: ideal_composed(x, nbr, wts, w,
                                                            b)}
    kernel_names = {"fused_zmax": "fused_zmax_kernel",
                    "fused_ideal_layer": "fused_ideal_kernel"}
    torch.cuda.synchronize()
    require(torch.equal(zmax_composed(x, nbr, wts),
                        fl.fused_zmax_plain(x, nbr, wts)),
            "the composed zmax differs from the plain version")
    nd, s = nbr.shape
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(   # columns unsorted: no invariants
            torch.arange(0, nd * s + 1, s, device=x.device),
            nbr.reshape(-1).long(), wts.reshape(-1), size=(nd, x.shape[0]),
            check_invariants=False)
    lib = torch.sparse.mm(csr, x)
    lib_err = float((lib - csr_aggregate_ref(x, nbr, wts)).abs().max())
    bnd = bounds(x, nbr, wts, w.shape[1], cfg.in_bits)
    nnz, rows = live_counts(nbr, wts)
    print(f"[time] {tag}: Nd={nd} S={s} F={x.shape[1]} H={w.shape[1]}, "
          f"{nnz} slots with a non-zero weight reading {rows} distinct rows",
          flush=True)
    rec = {}
    for name, (kernel, plain) in runs.items():
        rec[name] = dict(
            ms=cuda_ms(kernel, iters), plain_ms=cuda_ms(plain, 3),
            bound_ms=bnd[name][0], bound_by=bnd[name][1],
            library_ms=(cuda_ms(lambda: torch.sparse.mm(csr, x), iters)
                        if name == "csr_aggregate" else None))
        r = rec[name]
        lib_txt = (f", torch.sparse.mm {r['library_ms']:.3f} ms "
                   f"(max|diff| {lib_err:.2e})"
                   if r["library_ms"] is not None else "")
        if name in composed:
            r["launch_ms"], how = profiled_ms(kernel, kernel_names[name],
                                              iters)
            r["composed_ms"] = cuda_ms(composed[name], iters)
            lib_txt += (f", launch alone {r['launch_ms']:.4f} ms ({how}), "
                        f"composed "
                        f"{r['composed_ms']:.3f} ms")
        what = ("kernel with the programming of the weights"
                if name == "fused_quant_layer" else "kernel")
        print(f"[time] {tag} {name:18s} {what} {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}){lib_txt}", flush=True)
    for nname, qcfg in (("default", cfg), ("QUANT", CrossbarNumerics(
            **QUANT))):
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", qcfg)).to(x.device) \
                if noisy else None
            codes, scales = fl.quant_operands(
                fl.fused_zmax_plain(x, nbr, wts), w, qcfg, nz)
            ms = cuda_ms(lambda: fl.fused_quant_layer(
                x, nbr, wts, codes, b, scales, qcfg, relu=True), iters)
            ms_prog = cuda_ms(lambda: fl.fused_quant_layer(
                x, nbr, wts, fl.program_conductances(w, qcfg, nz), b, scales,
                qcfg, relu=True), iters)
            d = codes.digits.shape[0]
            print(f"[time] {tag} fused_quant_layer {nname} numerics, "
                  f"{'noisy' if noisy else 'clean'} codes ({d} int8 digit"
                  f"{'s' if d > 1 else ''}): with the programming of the "
                  f"weights {ms_prog:.3f} ms, launch alone {ms:.3f} ms",
                  flush=True)
    return rec


def wide_deep_timings(x1, nbr, wts, layer, z1, device) -> None:
    """Times of the wide and deep cases (CUDA events, launch alone on
    programmed codes): at layer 1 of the centralized collab path the quant
    layer and the crossbar with 12- and 16-bit DAC codes and with 12- and
    16-bit conductance codes (clean and noisy) beside the default
    numerics' launch; and the quant layer at the DEEP cases on 3,000
    rows (K in chunks)."""
    w, b = layer["w"], layer["b"]
    zmax = fl.fused_zmax_plain(x1, nbr, wts)
    for name, numerics in (("default", {}), *WIDE.items()):
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            codes, scales = fl.quant_operands(zmax, w, cfg, nz)
            q_ms = cuda_ms(lambda: fl.fused_quant_layer(
                x1, nbr, wts, codes, b, scales, cfg, relu=True), 5)
            xq, _ = xb.quantize_inputs(torch.clamp_min(z1, 0.0), cfg)
            x_ms = cuda_ms(lambda: xb.crossbar_matmul_programmed(
                xq, codes, cfg), 5)
            d = codes.digits.shape[0]
            print(f"[time] wide codes layer1 {name} "
                  f"{'noisy' if noisy else 'clean'} ({d} int8 digit"
                  f"{'s' if d > 1 else ''}, {-(-cfg.in_bits // 8)} pass"
                  f"{'es' if cfg.in_bits > 8 else ''}): fused_quant_layer "
                  f"launch {q_ms:.3f} ms, crossbar_matmul_quantized "
                  f"launch {x_ms:.3f} ms", flush=True)
    nb = torch.remainder(nbr[:3000], 4000)
    wt = wts[:3000].contiguous()
    deep = deep_inputs(device, 17)
    for f, numerics in DEEP:
        x, w, _ = deep[f]
        cfg = CrossbarNumerics(**numerics)
        codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nb, wt), w,
                                          cfg)
        ms = cuda_ms(lambda: fl.fused_quant_layer(
            x, nb, wt, codes, b, scales, cfg, relu=True), 20)
        d = codes.digits.shape[0]
        print(f"[time] deep F 3000 rows {f}->64 {numerics_tag(numerics)} "
              f"(depth {fl.tile_depth(f, cfg.rows_per_xbar)}, {d} int8 "
              f"digit{'s' if d > 1 else ''}, {-(-cfg.in_bits // 8)} pass"
              f"{'es' if cfg.in_bits > 8 else ''}): fused_quant_layer launch "
              f"{ms:.3f} ms", flush=True)


def new_timings(z1, w1, z2, w2, device, builds: dict) -> dict:
    """Kernel, plain and bound times of ``cam_search`` at one k-NN launch
    and of ``crossbar_matmul_quantized`` at layer 1 of the centralized
    collab path (the kernels line's record); the crossbar also with
    12-bit-ADC/64-row numerics, on clean codes, at layer 2 (64 -> 16) and
    at the variation bounds' 32 x 216 x 64. Each is timed two ways: per
    wrapper call (``ms``: CUDA events around back-to-back calls, so the
    host's work counts where it is the slower) and the device time of its
    launch alone (``launch_ms``: the profiler's time of the kernel, or
    CUDA events' where the profiler shows none). The crossbar's wrapper reads its codes back (one host sync) and builds
    their digits; its launch alone takes programmed weights. Neither kernel
    has one PyTorch call that computes the same function."""
    rec = {}
    entries, queries = cam_inputs(device)
    e, q = entries.numel(), queries.numel()
    ms, by = bound(4 * e + 4 * q + q * e + 4 * q, q * e / F32_FLOPS)

    def call():
        return cam_search(entries, queries)
    prof, how = profiled_ms(call, "cam_search_kernel", 50)
    rec["cam_search"] = dict(
        ms=cuda_ms(call, 200), launch_ms=prof,
        plain_ms=cuda_ms(lambda: cam_search_ref(entries, queries), 20),
        bound_ms=ms, bound_by=by, library_ms=None)
    r = rec["cam_search"]
    print(f"[time] cam_search Q={q} E={e}: per wrapper call {r['ms']:.4f} "
          f"ms, launch alone {prof:.4f} ms ({how}), "
          f"plain {r['plain_ms']:.4f} ms, "
          f"bound {ms:.4f} ms ({by}; bitmap {q * e} B written)", flush=True)
    b = knn.DEFAULT_BANDS
    qc, n = q // b, e // b
    match, _ = call()
    out = torch.empty((qc, n), dtype=torch.int32, device=device)

    def fold():
        out[:qc] = match.view(qc, b, n, b).sum(dim=(1, 3), dtype=torch.int32)
    fold_ms = cuda_ms(fold, 200)
    launches = -(-SCENARIO_NODES // qc)
    for name, secs in builds.items():
        print(f"[time] k-NN build {name} cam-pallas {secs * 1e3:.1f} ms "
              f"(host clock, phase 3): {launches} cam_search calls "
              f"{launches * r['ms']:.1f} ms "
              f"({launches * r['ms'] / secs / 10:.1f} %), {launches} folds "
              f"{launches * fold_ms:.1f} ms "
              f"({launches * fold_ms / secs / 10:.1f} %); per fold "
              f"{fold_ms:.4f} ms", flush=True)
    x_small, w_small = mvm_inputs(device)
    default, quant = CrossbarNumerics(), CrossbarNumerics(**QUANT)
    for x, w, nname, cfg, noisy, iters in (
            (z1, w1, "default", default, True, 5),
            (z1, w1, "default", default, False, 5),
            (z1, w1, "QUANT", quant, True, 5),
            (z1, w1, "QUANT", quant, False, 5),
            (z2, w2, "default", default, True, 20),
            (x_small, w_small, "default", default, True, 200),
            (x_small, w_small, "default", default, False, 200)):
        xq, codes = crossbar_codes(x, w, cfg, noisy)
        m, k = xq.shape
        n = codes.wq.shape[1]
        ms, by = bound(4 * m * k + 4 * k * n + 4 * m * n,
                       2 * cfg.in_bits * m * k * n / INT8_OPS)

        def launch():
            return xb.crossbar_matmul_programmed(xq, codes, cfg)
        prof, how = profiled_ms(launch, "crossbar_mma_kernel",
                                min(iters, 20))
        r = dict(
            ms=cuda_ms(lambda: xb.crossbar_matmul_quantized(xq, codes.wq,
                                                            cfg), iters),
            launch_ms=prof,
            plain_ms=cuda_ms(
                lambda: xb.crossbar_matmul_quantized_plain(xq, codes.wq,
                                                           cfg),
                min(iters, 3)),
            bound_ms=ms, bound_by=by, library_ms=None)
        d = codes.digits.shape[0]
        print(f"[time] crossbar_matmul_quantized {m}x{k}x{n} {nname} "
              f"numerics, {'noisy' if noisy else 'clean'} codes ({d} int8 "
              f"digit{'s' if d > 1 else ''}): per wrapper call "
              f"{r['ms']:.4f} ms, launch alone {prof:.4f} ms ({how}), plain "
              f"{r['plain_ms']:.4f} ms, bound {ms:.4f} ms ({by})",
              flush=True)
        rec.setdefault("crossbar_matmul_quantized", r)
    return rec


# ------------------------------------------------------------------ main


def main() -> None:
    require(torch.cuda.is_available(),
            "no CUDA device: nothing to check, no result")

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls on")
    device = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc.stdout.strip().splitlines()[-1]}; "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")

    # ---- the centralized collab path: host tables, then the card
    t0 = time.perf_counter()
    g = dataset_like("collab", scale=1.0, seed=0).gcn_normalize()
    plan_c = plan_execution(g, "centralized", sample=SAMPLE)
    print(f"[host] collab scale 1.0: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"F={g.feature_len}; host set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    params = gnn.init_params(cfg, seed=0, device=device)
    x1 = torch.from_numpy(plan_c.feats[0]).to(device)
    nbr = torch.from_numpy(plan_c.neighbors[0]).to(device)
    wts = torch.from_numpy(plan_c.weights[0]).to(device)
    z1 = csr_aggregate_ref(x1, nbr, wts)    # layer 1's Z
    x2 = torch.clamp_min(z1 @ params[0]["w"], 0.0)   # layer 2's input
    wts_zero = wts.clone()
    wts_zero[::97] = 0.0                    # zero-degree rows
    errs = {k: 0.0 for k in KERNELS}
    kernel_checks(x1, x2, nbr, wts_zero, params, device, errs)
    new_kernel_checks(z1, params[0]["w"], device, errs)
    wide_deep_checks(x1, nbr, wts_zero, device, errs)
    small_shape_checks(device, errs)

    # ---- the paths, counted
    totals = {k: 0 for k in KERNELS}
    serve_cases(plan_c, cfg, ("alltoall",), device, True, totals)
    t0 = time.perf_counter()
    g01 = dataset_like("collab", scale=0.1, seed=0).gcn_normalize()
    plan_d = plan_execution(g01, "decentralized", sample=SAMPLE,
                            n_clusters=8)
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_s = plan_execution(g01, "semi", sample=SAMPLE, n_clusters=4,
                            spokes_per_head=4)
    print(f"[host] collab scale 0.1: {g01.n_nodes} nodes; decentralized "
          f"8-cluster plan {t_d:.1f} s, semi 4x4 plan "
          f"{time.perf_counter() - t0:.1f} s (host set-up)", flush=True)
    serve_cases(plan_d, cfg, ("allgather", "alltoall"), device, True, totals)
    serve_cases(plan_s, cfg, ("alltoall",), device, True, totals)
    builds = path_a(device, totals)
    path_b(device, g01, totals)
    path_c1(g01, device, totals)
    path_c2(device, totals)

    # ---- path D: streaming serving, then the traced refresh
    t0 = time.perf_counter()
    d_totals = {k: 0 for k in KERNELS}
    path_d1(plan_c, cfg, params, device, d_totals)
    plan_b = plan_execution(g01, "decentralized", sample=SAMPLE,
                            n_clusters=16, partition_method="edge",
                            buckets="auto")
    path_d2({("decentralized 8", "allgather"): plan_d,
             ("decentralized 8", "alltoall"): plan_d,
             ("semi 4x4", "alltoall"): plan_s,
             ("C1 bucketed 16", "alltoall"): plan_b},
            g01, cfg, params, device, d_totals)
    print(f"[pathD] launches over path D {json.dumps(d_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(d_totals[k] > 0 for k in PATH_D),
            "a kernel of path D never launched")
    for k, v in d_totals.items():
        totals[k] += v
    trace_refresh(plan_c, cfg, params, device)

    # ---- path E: launch choices, tuning, calibration, the CLI's report
    path_e1(x1, x2, nbr, wts, params, plan_b, device, card)
    reset_launch_counts()
    path_e2(plan_c, plan_b, cfg, params, device, card)
    path_e3(plan_c, cfg, device, card)
    e_totals = launch_counts()
    print(f"[pathE] launches over E2 and E3 {json.dumps(e_totals)}",
          flush=True)
    require(all(v > 0 for v in e_totals.values()),
            "a kernel of path E never launched")
    for k, v in e_totals.items():
        totals[k] += v
    path_e4(device)

    # ---- path F: the planner, the load loops with its monitor, re-plans
    t0 = time.perf_counter()
    f_totals = {k: 0 for k in KERNELS}
    path_f1(g)
    path_f2(g01, plan_d, plan_s, cfg, params, device, f_totals)
    path_f3(g01, cfg, params, device, f_totals)
    path_f4(g01)
    print(f"[pathF] launches over path F {json.dumps(f_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(f_totals[k] > 0 for k in PATH_F),
            "a kernel of path F never launched")
    for k, v in f_totals.items():
        totals[k] += v
    print(f"[paths] launches over all path runs {json.dumps(totals)}",
          flush=True)
    require(all(v > 0 for v in totals.values()),
            "a kernel of the paths never launched")

    # ---- times at layer 1 and layer 2 of the centralized path
    rec1 = timings(x1, nbr, wts, params[0], "layer1 496->64", iters=10)
    timings(x2, nbr, wts, params[1], "layer2 64->16", iters=20)
    wide_deep_timings(x1, nbr, wts, params[0], z1, device)
    rec1.update(new_timings(z1, params[0]["w"],
                            csr_aggregate_ref(x2, nbr, wts), params[1]["w"],
                            device, builds))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=totals[name],
                            max_abs_err=errs[name], **rec1[name]))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
