"""Decentralized GNN serving on the SPMD runtime (the paper's Fig. 4b),
and the streaming, bucketed and technology demos.

The counterpart of the reference's ``examples/gnn_serve.py``. The static
demo partitions a Collab-like graph into K clusters,
one per rank, builds the halo-exchange plan (the paper's bidirectional
e_ij communication volume) and runs the SPMD forward in both exchange
modes:

  * allgather — the paper-faithful broadcast-within-cluster behavior,
  * alltoall  — each rank ships only the boundary rows its peers need
    (traffic = true e_ij).

Both are checked against the centralized (one device, full graph) oracle,
with the bytes on the wire each mode implies. Under ``torchrun`` each
rank runs one cluster (``--dist-backend gloo`` lets ranks share a card or
run on the host); without it the demo is a world of one rank. Only rank
0 prints.

  python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      -m repro_torch.examples.gnn_serve --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.examples.gnn_serve --device cpu

Streaming mode (``--stream N``) drives a taxi-style dynamic graph:
``core.taxi.synthetic_stream`` ticks flow into
``streaming.StreamingGNNServer.ingest()``, embeddings refresh
incrementally over the k-hop dirty frontier, and queries serve between
commits.

Bucketed mode (``--buckets auto|N``) runs the capacity-bucketed layout on
a power-law graph with an edge-balanced (deliberately node-skewed)
partition: per-bucket capacities, padding against the uniform dense
layout, the overlapped against the serialized halo exchange, and the
bucketed embeddings against the dense plan's.

Technology mode (``--tech``) plans the taxi mixed churn + query workload
over the device-technology bank and prints the per-tier recommendation
and the Monte-Carlo accuracy bound behind it. Its seconds and energies
price the paper's modeled devices, not the card.

``--metrics PATH`` / ``--trace PATH`` turn the port's telemetry on and
export its counters and span trees as JSONL after the demo.

  PYTHONPATH=src python -m repro_torch.examples.gnn_serve --stream 12
  PYTHONPATH=src python -m repro_torch.examples.gnn_serve --buckets auto
  PYTHONPATH=src python -m repro_torch.examples.gnn_serve --tech
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core import costmodel, gnn
from ..core.graph import dataset_like, random_graph
from ..core.partition import (build_local_subgraphs, gather_features,
                              partition, plan_execution)
from ..distributed.halo import build_halo_plan, make_decentralized_forward
from ..distributed.traffic import exchange_rows
from ..launch.mesh import make_mesh


@contextlib.contextmanager
def _mesh(args):
    """The demo's mesh: the running process group, the one ``torchrun``
    describes, or else a world of one rank; closed on exit unless the
    caller started the group."""
    owned = not dist.is_initialized()
    device = None if args.device == "cuda" else resolve_device(args.device)
    path = None
    if owned and "WORLD_SIZE" not in os.environ:
        fd, path = tempfile.mkstemp(prefix="gnn_serve_rdv_")
        os.close(fd)
        mesh = make_mesh((1,), ("data",), backend=args.dist_backend,
                         device=device, init_method=f"file://{path}",
                         rank=0)
    else:
        world = (dist.get_world_size() if not owned
                 else int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh((world,), ("data",), backend=args.dist_backend,
                         device=device)
    try:
        yield mesh
    finally:
        if owned:
            dist.destroy_process_group()
        if path is not None and os.path.exists(path):
            os.remove(path)


def stream_demo(n_ticks: int, sample: int, device="cuda"):
    """The streaming quickstart: ``synthetic_stream`` ticks -> ingest ->
    incremental refresh -> batched query. Returns the server after the
    final flush."""
    from ..core import taxi
    from ..streaming import StreamingGNNServer

    cfg_t = taxi.TaxiConfig(m=6, n=6)
    n_nodes = 300
    g = random_graph(n_nodes, n_nodes * 6, cfg_t.region, seed=0)
    g = g.gcn_normalize()
    plan = plan_execution(g, "decentralized", backend="jnp", sample=sample,
                          n_clusters=4)
    cfg = gnn.GNNConfig(in_dim=cfg_t.region, hidden_dims=(32,), out_dim=16,
                        sample=sample)
    srv = StreamingGNNServer(plan, cfg, policy="bounded-staleness",
                             max_staleness=4, max_dirty_frac=0.3,
                             device=device)
    print(f"streaming: {n_nodes} taxis, {cfg_t.region}-dim demand maps, "
          f"cold refresh {srv.refresh() * 1e3:.1f} ms")

    # the §4.2 demand/supply stream: each tick only part of the map moves
    stream = taxi.synthetic_stream(0, n_nodes, n_ticks, cfg_t,
                                   device="cpu").numpy()
    rng = np.random.default_rng(0)
    feats = np.asarray(g.features)
    for t in range(n_ticks):
        moved = rng.random(n_nodes) < 0.1          # 10% of taxis move
        x_t = feats.copy()
        x_t[moved] = stream[t][moved]
        feats = x_t
        upd = srv.ingest(x_t)
        emb = srv.query(rng.integers(0, n_nodes, 16))
        state = ("commit: recomputed "
                 f"{upd.recompute_fraction * 100:5.1f}% of rows, "
                 f"{upd.seconds * 1e3:6.1f} ms"
                 + (f", shipped {upd.traffic.total_bytes() / 1e3:.1f} kB"
                    if upd.traffic is not None else "")
                 if upd is not None else
                 f"buffered ({srv.pending_ticks} ticks pending)")
        print(f"  tick {t:2d}: {state}; served {len(emb)} lookups")
    srv.flush()
    fracs = [u.recompute_fraction for u in srv.updates if not u.full]
    print(f"{srv.commits} commits ({srv.full_refreshes} full); mean "
          f"incremental recompute fraction "
          f"{float(np.mean(fracs)) if fracs else 1.0:.3f}")
    return srv


def bucketed_demo(sample: int, buckets, clusters: int,
                  device="cuda") -> dict:
    """The capacity-bucketed layout quickstart: skewed partition -> pow2
    buckets -> overlapped halo exchange -> dense parity. Returns the
    bucketed embeddings of both schedules and the dense plan's (numpy,
    global node order)."""
    k = clusters or 16
    g = random_graph(6000, 24000, 16, seed=0).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=16, hidden_dims=(32,), out_dim=16,
                        sample=sample)
    dev = resolve_device(device)
    params = gnn.init_params(cfg, seed=0, device=dev)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=sample,
                          n_clusters=k, buckets=buckets,
                          partition_method="edge")
    bp = plan.bucketed
    ls = plan.layout_stats(cfg)
    caps = sorted({(int(bp.n_caps[b]), len(bp.clusters[b]))
                   for b in range(bp.n_buckets)})
    print(f"bucketed: {g.n_nodes} power-law nodes, {k} edge-balanced "
          f"clusters -> {bp.n_buckets} buckets (cap, clusters): {caps}")
    print(f"  padded rows {ls['padded_rows']} vs dense "
          f"{ls['dense_padded_rows']} ({ls['padding_ratio']:.2f}x vs "
          f"{ls['dense_padding_ratio']:.2f}x real)")
    outs = {}
    for overlap in ("overlap", "serial"):
        fwd = plan.make_forward(cfg, overlap=overlap, device=dev)
        out = fwd(params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        outs[overlap] = plan.scatter(out)
        print(f"  {overlap:8s} halo exchange: {dt * 1e3:7.2f} ms/forward")
    dense = plan_execution(g, "decentralized", backend="jnp",
                           sample=sample, n_clusters=k,
                           partition_method="edge")
    outs["dense"] = dense.scatter(dense.make_forward(cfg, device=dev)(params))
    gap = float(np.abs(outs["overlap"] - outs["dense"]).max())
    print(f"  overlap == serial: "
          f"{np.array_equal(outs['overlap'], outs['serial'])}; "
          f"bucketed == dense: "
          f"{np.array_equal(outs['overlap'], outs['dense'])} (max|diff| "
          f"{gap:.2e} of max|dense| {float(np.abs(outs['dense']).max()):.2e})")
    return outs


def tech_demo(sample: int, device="cuda") -> dict:
    """The device-technology quickstart: plan the taxi mixed churn + query
    workload over the technology bank (four pure technologies plus the
    ReRAM-spoke / SRAM-head pair) and print the per-tier pick, the
    Monte-Carlo accuracy bound grounding it (``mvm_error_bounds`` on
    ``device``), and the noise-tolerance flip. Returns the picks."""
    from ..core.graph import TAXI_STATS
    from ..devices import mvm_error_bounds, technology_table
    from ..planner import WorkloadProfile, plan

    print(f"{'technology':>10s} {'t_read':>8s} {'e_read':>8s} "
          f"{'bits':>4s} {'sigma':>6s}")
    for t in technology_table():
        print(f"{t['name']:>10s} {t['read_latency_s']:8.1e} "
              f"{t['read_energy_j']:8.1e} {t['cell_bits']:4d} "
              f"{t['noise_sigma']:6.3f}")

    techs = ("sot-mram", "reram", "sram", "fefet", ("reram", "sram"))
    wl = WorkloadProfile(churn=0.01, queries_per_tick=64, sample=sample)
    result = plan(TAXI_STATS, "throughput", workload=wl, technologies=techs)
    c = result.recommended.candidate
    print(f"\ntaxi mixed workload (1% churn/tick, 64 queries/tick): "
          f"{len(result.scored)} candidates, {len(result.frontier)} on the "
          f"Pareto frontier")
    print(f"  recommended plan: {c.key}")
    print(f"    spoke tier (partition storage): {c.spoke_technology}")
    print(f"    head tier  (compute passes):    {c.head_technology}")
    b = mvm_error_bounds(c.head_technology, trials=4, device=device)
    print(f"    head-tier MC accuracy bound: mean relative MVM error "
          f"{b.mean_err:.2e}, p99 {b.p99_err:.2e} ({b.trials} trials)")

    # a tight noise tolerance prices the variation bound as infeasible and
    # flips the pick toward the quiet technologies: under the energy
    # objective the lowest-read-energy (but noisy) technology wins until
    # the tolerance rejects it
    loose = plan(TAXI_STATS, "energy", workload=wl, technologies=techs)
    tight = plan(TAXI_STATS, "energy",
                 workload=dataclasses.replace(wl, noise_tolerance=1e-4),
                 technologies=techs)
    cl, ct = loose.recommended.candidate, tight.recommended.candidate
    print(f"  energy objective: head tier {cl.head_technology} -> "
          f"noise_tolerance 1e-4 flips it to {ct.head_technology}")
    return {"recommended": c.key, "spoke": c.spoke_technology,
            "head": c.head_technology, "bound": b,
            "energy_loose": cl.head_technology,
            "energy_tight": ct.head_technology}


def _dump_telemetry(args) -> None:
    """Print the demo's span summary and export metrics / trace when
    asked (the flags of the ``launch.gnn`` CLI)."""
    if not (args.metrics or args.trace):
        return
    from .. import telemetry
    spans = telemetry.get_tracer().summary()
    if spans:
        print("telemetry spans (count, total ms):")
        for name, sp in spans.items():
            print(f"  {name:24s} {sp['count']:5d} "
                  f"{sp['total_s'] * 1e3:9.2f}")
    if args.metrics:
        n = telemetry.export_metrics(args.metrics)
        print(f"wrote {n} metric lines -> {args.metrics}")
    if args.trace:
        n = telemetry.export_trace(args.trace)
        print(f"wrote {n} span trees -> {args.trace}")


def main(argv=None):
    """Run the demo the flags pick: the static demo returns ``{mode:
    max|err| vs the oracle}``; ``--stream``, ``--buckets`` and ``--tech``
    return what their demo function returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=0,
                    help="default: one per rank (it must equal the world)")
    ap.add_argument("--sample", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default="nccl", dest="dist_backend",
                    choices=("nccl", "gloo"))
    ap.add_argument("--stream", type=int, default=0, metavar="TICKS",
                    help="run the streaming demo for TICKS synthetic_stream "
                         "ticks instead of the static serving demo")
    ap.add_argument("--buckets", default=None, metavar="auto|N",
                    help="run the capacity-bucketed layout demo instead "
                         "of the static serving demo")
    ap.add_argument("--tech", action="store_true",
                    help="run the device-technology planning demo "
                         "(per-tier technology pick for the taxi mixed "
                         "workload)")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="enable telemetry; export counters/gauges/"
                         "histograms as JSONL to PATH after the demo")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="enable telemetry; export span trees as JSONL "
                         "to PATH after the demo")
    args = ap.parse_args(argv)
    if args.metrics or args.trace:
        from .. import telemetry
        telemetry.enable()
    try:
        if args.tech:
            return tech_demo(args.sample, device=args.device)
        if args.stream:
            return stream_demo(args.stream, args.sample, device=args.device)
        if args.buckets:
            return bucketed_demo(args.sample,
                                 args.buckets if args.buckets == "auto"
                                 else int(args.buckets), args.clusters,
                                 device=args.device)
        return _static(args)
    finally:
        _dump_telemetry(args)


def _static(args) -> dict:
    with _mesh(args) as mesh:
        if mesh.rank:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                return _demo(args, mesh)
        return _demo(args, mesh)


def _demo(args, mesh) -> dict:
    k = args.clusters or mesh.size
    if k != mesh.size:
        raise ValueError(f"{k} clusters on {mesh.size} ranks: the SPMD "
                         f"runtime runs one cluster a rank")
    dev, r = mesh.device, mesh.rank
    g = dataset_like("collab", scale=0.002, seed=0).gcn_normalize()
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"{g.feature_len}-dim features; {k} clusters on {mesh.size} "
          f"{mesh.backend} ranks ({dev} here)")

    # prune halo/send tables to the sample-reachable edges the kernels
    # read, so the printed wire bytes equal the tabulated e_ij
    part = partition(g, k, sample=args.sample)
    sub = build_local_subgraphs(g, part, args.sample)
    plan = build_halo_plan(part)
    feats = gather_features(g, part)                  # [K, n_max, F]

    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(64,), out_dim=16,
                        sample=args.sample)
    params = gnn.init_params(cfg, seed=0, device=dev)

    # centralized oracle: full-graph forward on one device
    nb, wt = g.neighbor_sample(args.sample)
    oracle = gnn.forward(params, torch.from_numpy(g.features).to(dev),
                         torch.from_numpy(nb).to(dev),
                         torch.from_numpy(wt).to(dev), cfg).cpu().numpy()

    errs = {}
    for mode in ("allgather", "alltoall"):
        fwd = make_decentralized_forward(mesh, cfg, plan, part.n_max,
                                         mode=mode)
        out = fwd(params, torch.from_numpy(feats[r]).to(dev),
                  torch.from_numpy(sub.neighbors[r]).to(dev),
                  torch.from_numpy(sub.weights[r]).to(dev)).cpu().numpy()
        # stitch per-cluster outputs back to global node order
        got = np.zeros((g.n_nodes, cfg.out_dim), np.float32)
        for c in range(k):
            m = part.local_mask[c]
            got[part.local_nodes[c][m]] = out[c][m]
        errs[mode] = float(np.abs(got - oracle).max())
        rows = exchange_rows(plan, mode, part.n_max)
        traffic = int(rows.sum()) * g.feature_len * 4
        print(f"  {mode:10s} max|err| vs centralized oracle "
              f"{errs[mode]:.2e}   wire bytes/layer {traffic / 1e6:8.2f} MB")

    # per-cluster Eqs. 4/7 prediction for the decentralized plan
    e_ij = part.comm_volume
    print(f"\nhalo volume e_ij (sample-pruned rows shipped/layer): total "
          f"{int(e_ij.sum())}, max per cluster {int(e_ij.sum(1).max())}")
    best, metrics = costmodel.pick_setting(g.stats("collab-like"),
                                           n_clusters=k)
    print(f"cost-model guideline for this graph: {best} "
          f"(T_net centralized {metrics['centralized'].t_net:.3e}s, "
          f"decentralized {metrics['decentralized'].t_net:.3e}s, "
          f"semi {metrics['semi'].t_net:.3e}s)")
    return errs


if __name__ == "__main__":
    main()
