#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines, each failing the run on any error:

  1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
     nvcc versions; the kernels built from ``src/repro_torch/csrc`` (one
     nvcc per source, in parallel).
  2. each of the four kernels against its plain PyTorch version at the
     serving path's shapes (collab-like F=496 -> H=64 and 64 -> 16, S=8,
     372,475 destination rows with some zero-degree rows), on ideal,
     default bit-accurate and 12-bit-ADC/64-row numerics and both ``relu``
     values. Aggregation and zmax must be equal bit for bit; the layers
     agree within rtol 1e-5, atol 1e-5 * max|ref| (the matmul sums in
     another order).
  3. ``GNNServer`` end to end, GNNConfig(in_dim=496, hidden_dims=(64,),
     out_dim=16, sample=8): centralized on collab at scale 1.0,
     decentralized on 8 clusters in both exchange modes and semi on
     4 heads x 4 spokes at scale 0.1, each refreshed and answering 64
     batches of 16 lookups on the ``fused`` and ``pallas`` backends with
     ideal and bit-accurate numerics, against the ``jnp`` backend on the
     card at rtol and atol 1e-4 * max|ref|. The launch counters are set to
     0 before each run and read after it; every kernel the path runs must
     have launched.
  4. each kernel's time (CUDA events) at layer 1 and layer 2 of the
     centralized path, beside its plain version's, its bound on an H100
     SXM and, for aggregation, ``torch.sparse.mm`` of the CSR sample
     matrix as the library yardstick.

The last lines are the card line, one JSON object with a record per
kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import dataset_like, gnn  # noqa: E402
from repro_torch.core.partition import plan_execution  # noqa: E402
from repro_torch.kernels import (_build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics  # noqa: E402
from repro_torch.kernels.csr_aggregate.ops import csr_aggregate  # noqa: E402
from repro_torch.kernels.csr_aggregate.ref import (  # noqa: E402
    csr_aggregate_ref)
from repro_torch.kernels.fused_layer import ops as fl  # noqa: E402
from repro_torch.launch.gnn import GNNServer  # noqa: E402

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 flop/s on the CUDA
# cores, int8 op/s on the tensor cores.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12

HIDDEN, OUT, SAMPLE = 64, 16, 8
QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "fused_ideal_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:142"),
    "fused_zmax": ("src/repro_torch/csrc/fused_layer.cu",
                   "src/repro/kernels/fused_layer/fused_layer.py:176"),
    "fused_quant_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:202"),
    "csr_aggregate": ("src/repro_torch/csrc/csr_aggregate.cu",
                      "src/repro/kernels/csr_aggregate/csr_aggregate.py:39"),
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


def kernel_checks(x1, x2, nbr, wts, params, device) -> dict:
    """Each kernel against its plain version on the same inputs. Returns
    {kernel: max abs error over its cases}."""
    gen = torch.Generator(device=device).manual_seed(7)
    err = {k: 0.0 for k in KERNELS}

    def record(name, got, ref, exact, label):
        if device.type == "cuda":
            torch.cuda.synchronize()
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                f"{name} {label}: shape or non-finite values")
        diff = (got - ref).abs()
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

    for x, tag in ((x1, "F=496"), (x2, "F=64")):
        record("csr_aggregate", csr_aggregate(x, nbr, wts),
               csr_aggregate_ref(x, nbr, wts), True, tag)
        record("fused_zmax", fl.fused_zmax(x, nbr, wts),
               fl.fused_zmax_plain(x, nbr, wts), True, tag)
    numerics = {"default": CrossbarNumerics(), "QUANT": CrossbarNumerics(
        **QUANT)}
    for x, layer, tag in ((x1, params[0], "496->64"),
                          (x2, params[1], "64->16")):
        w = layer["w"]
        b = 0.1 * torch.randn(w.shape[1], generator=gen, device=device)
        for relu in (True, False):
            record("fused_ideal_layer",
                   fl.fused_ideal_layer(x, nbr, wts, w, b, relu=relu),
                   fl.fused_ideal_layer_plain(x, nbr, wts, w, b, relu=relu),
                   False, f"{tag} relu={relu}")
            for nname, cfg in numerics.items():
                wq, scales = fl.quant_operands(
                    fl.fused_zmax_plain(x, nbr, wts), w, cfg)
                record("fused_quant_layer",
                       fl.fused_quant_layer(x, nbr, wts, wq, b, scales, cfg,
                                            relu=relu),
                       fl.fused_quant_layer_plain(x, nbr, wts, wq, b, scales,
                                                  cfg, relu=relu),
                       False, f"{tag} {nname} relu={relu}")
    return err


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


# ------------------------------------------------------------------ phase 4


def live_counts(nbr, wts) -> tuple:
    """(slots with a non-zero weight, distinct rows they read)."""
    live = wts != 0
    return int(live.sum()), int(torch.unique(nbr[live]).numel())


def bounds(x, nbr, wts, h: int, in_bits: int) -> dict:
    """Least device ms on an H100 SXM for each kernel at these inputs:
    each input read once, each output written once, against the ops of
    the slots with a non-zero weight. Returns {kernel: (ms, bound_by)}."""
    nd, s = nbr.shape
    f = x.shape[1]
    nnz, rows = live_counts(nbr, wts)
    read = rows * f * 4 + nd * s * 8          # gathered rows + tables
    gather_flops = 2 * nnz * f

    def bound(nbytes, t_ops):
        t_mem = nbytes / HBM_BPS
        return (max(t_mem, t_ops) * 1e3,
                "bytes" if t_mem >= t_ops else "operations")
    return {
        "csr_aggregate": bound(read + nd * f * 4, gather_flops / F32_FLOPS),
        "fused_zmax": bound(read + nd * 8,
                            (gather_flops + 2 * nd * f) / F32_FLOPS),
        "fused_ideal_layer": bound(
            read + f * h * 4 + h * 4 + nd * h * 4,
            (gather_flops + 2 * nd * f * h) / F32_FLOPS),
        "fused_quant_layer": bound(
            read + f * h * 4 + h * 4 + 12 + nd * h * 4,
            gather_flops / F32_FLOPS
            + 2 * in_bits * 2 * nd * f * h / INT8_OPS),
    }


def timings(x, nbr, wts, layer, tag: str, iters: int) -> dict:
    """Kernel, plain and library times at one layer's shapes."""
    cfg = CrossbarNumerics()
    w, b = layer["w"], layer["b"]
    wq, scales = fl.quant_operands(fl.fused_zmax_plain(x, nbr, wts), w, cfg)
    runs = {
        "csr_aggregate": (lambda: csr_aggregate(x, nbr, wts),
                          lambda: csr_aggregate_ref(x, nbr, wts)),
        "fused_zmax": (lambda: fl.fused_zmax(x, nbr, wts),
                       lambda: fl.fused_zmax_plain(x, nbr, wts)),
        "fused_ideal_layer": (
            lambda: fl.fused_ideal_layer(x, nbr, wts, w, b, relu=True),
            lambda: fl.fused_ideal_layer_plain(x, nbr, wts, w, b,
                                               relu=True)),
        "fused_quant_layer": (
            lambda: fl.fused_quant_layer(x, nbr, wts, wq, b, scales, cfg,
                                         relu=True),
            lambda: fl.fused_quant_layer_plain(x, nbr, wts, wq, b, scales,
                                               cfg, relu=True)),
    }
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
        print(f"[time] {tag} {name:18s} kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}){lib_txt}", flush=True)
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
            if "registers" in line or "spill" in line:
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
    x2 = torch.clamp_min(csr_aggregate_ref(x1, nbr, wts) @ params[0]["w"],
                         0.0)        # layer 2's input
    wts_zero = wts.clone()
    wts_zero[::97] = 0.0                    # zero-degree rows
    errs = kernel_checks(x1, x2, nbr, wts_zero, params, device)

    # ---- the serving paths, counted
    totals = {k: 0 for k in KERNELS}
    reset_launch_counts()
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
    print(f"[serve] launches over all serving runs {json.dumps(totals)}",
          flush=True)
    require(all(v > 0 for v in totals.values()),
            "a kernel of the serving path never launched")

    # ---- times at layer 1 and layer 2 of the centralized path
    rec1 = timings(x1, nbr, wts, params[0], "layer1 496->64", iters=10)
    timings(x2, nbr, wts, params[1], "layer2 64->16", iters=20)

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
