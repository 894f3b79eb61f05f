"""GNN embedding-serving driver over an ExecutionPlan, on a CUDA card.

The counterpart of ``repro.launch.gnn``: requests are node-embedding
lookups against a graph whose embeddings are refreshed by running the
plan's forward (centralized, decentralized or semi-decentralized) on the
``jnp``, ``pallas`` or ``fused`` backend (see ``repro_torch.core.gnn``).

  PYTHONPATH=src python -m repro_torch.launch.gnn --setting decentralized \
      --clusters 8

Feature-similarity scenarios (``--dataset recsys|anomaly``) arrive as bare
feature vectors: the served graph is built by k-NN search over LSH band
signatures (``repro_torch.neighbors``) on the ``--neighbor-mode`` path —
``cam`` runs the band matching through the CAM search's plain version,
``cam-pallas`` through the hand-written CAM kernel, ``topk`` through a
direct signature compare; all three build the same graph:

  PYTHONPATH=src python -m repro_torch.launch.gnn --dataset recsys \
      --neighbor-mode cam-pallas --setting centralized --scale 0.1

``--buckets auto|N`` serves the capacity-bucketed ragged layout (clusters
grouped into power-of-two capacity buckets; ``N`` caps the bucket count)
and prints its padding against the dense layout's:

  PYTHONPATH=src python -m repro_torch.launch.gnn --setting decentralized \
      --clusters 16 --buckets auto

Streaming mode (``--stream N``) serves the same plan through
``repro_torch.streaming.StreamingGNNServer``: N synthetic feature ticks
(``--churn`` of the nodes each) are ingested under the chosen refresh
``--policy``, embeddings refresh incrementally over the k-hop dirty
frontier, and the driver prints the recomputed-node fraction and the
measured incremental traffic. In stream mode ``--neighbor-mode`` also
picks the frontier's membership test (``topk``: numpy on the host,
``cam``/``cam-pallas``: the CAM search's plain version / kernel):

  PYTHONPATH=src python -m repro_torch.launch.gnn --setting decentralized \
      --stream 16 --churn 0.05 --policy bounded-staleness

``--metrics PATH`` / ``--trace PATH`` turn the port's telemetry on and
write the metrics registry / the span trees as JSONL on exit.

``--tune`` tunes the plan's kernel launches on the card before serving
(``repro_torch.tuning``; winners cache to ``--tune-cache``). At the end of
a run the CLI prints the paper's cost model for the plan's setting
(``T_compute``, ``T_comm``, ``P``; ``--tech NAME[+NAME]`` prices it on a
device technology through the mapper), the mapper-derived ``T_compute``,
the compiled crossbar mapping under ``--mapping``, and the cost model's
guideline: these price the paper's modeled in-memory edge devices, not
the card.

  PYTHONPATH=src python -m repro_torch.launch.gnn --setting centralized \
      --tune --mapping --tech reram

``--plan auto`` lets ``repro_torch.planner`` choose the setting, backend,
cluster count and refresh policy for the workload the flags describe
(``--churn`` under ``--stream``, ``--batch`` lookups a tick, ``--sample``;
objective ``throughput`` under ``--stream``, ``latency`` otherwise;
within ``--tech`` when given) and prints its summary before serving; it
follows the recommendation's neighbor mode unless ``cam-pallas`` was
asked for:

  PYTHONPATH=src python -m repro_torch.launch.gnn --plan auto --stream 8

``--device cpu`` runs the plain PyTorch versions of the kernels on the
host (``--tune`` needs the card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import telemetry as tel
from .._device import resolve_device
from ..core import costmodel, dataset_like, gnn
from ..core.partition import ExecutionPlan, plan_execution
from ..neighbors import SCENARIOS, scenario_graph


class GNNServer:
    """Embedding server: refresh via the plan's forward, serve row lookups.

    Staleness is version-tracked: ``update_params`` / ``update_plan`` bump
    ``self.version``, and ``query`` refreshes whenever the served
    embeddings were computed at an older version. Mutating ``self.params``
    in place bypasses the tracking — use the setters.
    """

    def __init__(self, plan: ExecutionPlan, cfg: gnn.GNNConfig,
                 params=None, seed: int = 0, mode: str = "alltoall",
                 device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = plan.gnn_config(cfg)
        self.params = params if params is not None else gnn.init_params(
            self.cfg, seed=seed, device=self.device)
        self._forward = None    # built at the first refresh
        self.mode = mode
        self.embeddings: np.ndarray | None = None
        self.refreshes = 0
        self.version = 0            # params/graph generation counter
        self._served_version = -1   # version the embeddings were built at

    def update_params(self, params) -> None:
        """Swap model parameters; served embeddings become stale."""
        self.params = params
        self.version += 1

    def update_plan(self, plan: ExecutionPlan, cfg=None) -> None:
        """Swap the execution plan (graph changed / repartitioned); rebuilds
        the forward and marks served embeddings stale."""
        cfg = cfg if cfg is not None else self.cfg
        self.plan = plan
        self.cfg = plan.gnn_config(cfg)
        self._forward = None
        self.version += 1

    @property
    def stale(self) -> bool:
        return self.embeddings is None or self._served_version != self.version

    def refresh(self) -> float:
        """Recompute all node embeddings; returns wall-clock seconds (the
        copy of the embeddings to the host ends the device work)."""
        t0 = time.perf_counter()
        with tel.span("server.refresh", setting=self.plan.setting):
            if self._forward is None:
                self._forward = self.plan.make_forward(
                    self.cfg, mode=self.mode, device=self.device)
            self.embeddings = self.plan.scatter(self._forward(self.params))
        self.refreshes += 1
        self._served_version = self.version
        return time.perf_counter() - t0

    def query(self, node_ids) -> np.ndarray:
        """Serve one batch of embedding lookups (refresh if stale).

        Ids are validated against the served embedding table: out-of-range
        ids raise IndexError naming the bound; any batch shape gathers in
        one fancy index."""
        with tel.span("server.query"):
            if self.stale:
                self.refresh()
            ids = np.asarray(node_ids, np.int64)
            n = len(self.embeddings)
            if ids.size and (ids.min() < 0 or ids.max() >= n):
                raise IndexError(
                    f"node ids must be in [0, {n}); batch spans "
                    f"[{ids.min()}, {ids.max()}]")
            out = self.embeddings[ids]
            tel.counter("server.queries").inc(ids.size)
        return out


def stream_main(args, g, plan, cfg, device) -> None:
    """--stream driver: ingest a synthetic tick stream, serve batched
    lookups between commits, report incremental refresh statistics."""
    from ..streaming import StreamingGNNServer
    frontier = {"topk": "numpy", "cam": "cam",
                "cam-pallas": "cam-pallas"}[args.neighbor_mode]
    srv = StreamingGNNServer(plan, cfg, mode=args.mode, policy=args.policy,
                             frontier_mode=frontier, device=device)
    t_cold = srv.refresh()
    print(f"plan: {args.setting}/{args.backend}, {g.n_nodes} nodes, "
          f"{plan.n_clusters} clusters on {device}; policy {args.policy}; "
          f"frontier membership via {frontier}; "
          f"cold full refresh {t_cold * 1e3:.1f} ms")
    rng = np.random.default_rng(0)
    served = 0
    inc_bytes = 0
    loop_commits = 0
    t0 = time.perf_counter()
    for tick in range(args.stream):
        n_mut = max(int(g.n_nodes * args.churn), 1)
        nodes = rng.choice(g.n_nodes, n_mut, replace=False)
        rows = rng.normal(size=(n_mut, g.feature_len)).astype(np.float32)
        upd = srv.ingest(nodes=nodes, rows=rows)
        if upd is not None:
            loop_commits += 1
            if upd.traffic is not None:
                inc_bytes += upd.traffic.total_bytes()
        served += len(srv.query(rng.integers(0, g.n_nodes, args.batch)))
    dt = time.perf_counter() - t0
    # the cold-start commit is a full refresh by construction — keep it out
    # of the incremental statistics it would otherwise bias
    fracs = [u.recompute_fraction for u in srv.updates if not u.full]
    print(f"{args.stream} ticks, {srv.commits} commits "
          f"({srv.full_refreshes} full), mean incremental recompute "
          f"fraction {float(np.mean(fracs)) if fracs else 1.0:.3f}")
    if plan.setting != "centralized" and loop_commits:
        full = plan.measured_traffic(srv.cfg, mode=args.mode).total_bytes()
        print(f"measured incremental traffic {inc_bytes / 1e6:.3f} MB "
              f"(full-refresh equivalent "
              f"{full * loop_commits / 1e6:.3f} MB)")
    print(f"served {served} lookups alongside the stream in "
          f"{dt * 1e3:.1f} ms")


def _dump_telemetry(args) -> None:
    """--metrics / --trace exit dumps (telemetry enabled in main)."""
    if args.metrics:
        n = tel.export_metrics(args.metrics)
        print(f"telemetry: wrote {n} metric/event lines to {args.metrics}")
    if args.trace:
        n = tel.export_trace(args.trace)
        print(f"telemetry: wrote {n} span trees to {args.trace}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default="decentralized",
                    choices=("centralized", "decentralized", "semi"))
    ap.add_argument("--backend", default="fused", choices=gnn.BACKENDS)
    ap.add_argument("--dataset", default="collab",
                    help="a Table-2 name / 'taxi' (dataset_like), or a "
                         "feature-similarity scenario 'recsys'/'anomaly' "
                         "whose graph is built by k-NN search")
    ap.add_argument("--scale", type=float, default=0.001)
    ap.add_argument("--neighbor-mode", default="topk", dest="neighbor_mode",
                    choices=("topk", "cam", "cam-pallas"),
                    help="scenario k-NN construction and, in stream mode, "
                         "the dirty-frontier membership test: direct "
                         "compare / numpy, the CAM plain version, or the "
                         "CAM kernel (same results)")
    ap.add_argument("--clusters", type=int, default=0,
                    help="default: one per CUDA device (decentralized) / "
                         "4 heads (semi)")
    ap.add_argument("--spokes", type=int, default=4,
                    help="semi: member edge devices per cluster head")
    ap.add_argument("--mode", default="alltoall",
                    choices=("allgather", "alltoall"),
                    help="halo-exchange strategy (semi: tier-1)")
    ap.add_argument("--buckets", default="off", metavar="auto|off|N",
                    help="capacity-bucketed ragged layout: 'auto' buckets "
                         "clusters by pow2 capacity, an int caps the bucket "
                         "count, 'off' keeps dense padding")
    ap.add_argument("--sample", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mapping", action="store_true",
                    help="print the compiled crossbar mapping report")
    ap.add_argument("--tune", action="store_true",
                    help="tune the plan's kernel launches on the card before "
                         "serving (repro_torch.tuning); winners cache to "
                         "--tune-cache")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="tuned-config cache file (default: "
                         "results/tuned_configs_torch.json)")
    ap.add_argument("--tech", default=None, metavar="NAME[+NAME]",
                    help="device technology for the derived cost/mapping "
                         "reports (sot-mram, reram, sram, fefet); a "
                         "'spoke+head' pair prices the mapper with the "
                         "head technology")
    ap.add_argument("--stream", type=int, default=0, metavar="TICKS",
                    help="serve a TICKS-long synthetic feature stream "
                         "through StreamingGNNServer (incremental refresh)")
    ap.add_argument("--churn", type=float, default=0.05,
                    help="stream mode: fraction of nodes mutated per tick")
    ap.add_argument("--policy", default="eager",
                    choices=("eager", "interval", "bounded-staleness"),
                    help="stream mode: refresh policy")
    ap.add_argument("--plan", default="manual", dest="plan_mode",
                    choices=("manual", "auto"),
                    help="auto: let repro_torch.planner pick setting/"
                         "backend/clusters/policy for this workload")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable telemetry; dump the metrics registry "
                         "(counters/gauges/histograms + audit events) as "
                         "JSONL to PATH on exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry; export the recorded span trees "
                         "as JSONL to PATH on exit")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.metrics or args.trace:
        tel.enable()
    tech = None
    if args.tech:
        tech = (tuple(args.tech.split("+")) if "+" in args.tech
                else args.tech)
        from ..devices import resolve_technology
        for name in (tech if isinstance(tech, tuple) else (tech,)):
            resolve_technology(name)        # typos fail here, by name

    if args.dataset in SCENARIOS:
        g = scenario_graph(
            args.dataset, n_nodes=max(int(200_000 * args.scale), 32),
            feature_len=32, k=args.sample,
            neighbor_mode="topk" if args.neighbor_mode == "topk" else "cam",
            backend="pallas" if args.neighbor_mode == "cam-pallas"
            else "jnp", device=device).gcn_normalize()
        print(f"{args.dataset}: built k-NN graph on the "
              f"{args.neighbor_mode} path — {g.n_nodes} nodes, "
              f"{g.n_edges} similarity edges")
    else:
        g = dataset_like(args.dataset, scale=args.scale,
                         seed=0).gcn_normalize()
    if args.plan_mode == "auto":
        from ..planner import WorkloadProfile, plan as plan_search
        wl = WorkloadProfile(
            churn=args.churn if args.stream else 0.0,
            queries_per_tick=float(args.batch),
            sample=args.sample)
        objective = "throughput" if args.stream else "latency"
        result = plan_search(g, objective, workload=wl, shortlist=2,
                             **(dict(technologies=(tech,)) if tech else {}))
        print(result.summary())
        rec = result.recommended.candidate
        args.setting, args.backend = rec.setting, rec.backend
        args.clusters, args.policy = rec.n_clusters, rec.policy
        if args.neighbor_mode != "cam-pallas":
            # keep an explicit kernel request; otherwise follow the
            # planner's priced neighbor_mode axis
            args.neighbor_mode = rec.neighbor_mode
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    k = args.clusters or (n_dev if args.setting == "decentralized" else 4)
    buckets = args.buckets if args.buckets in ("auto", "off") \
        else int(args.buckets)
    plan = plan_execution(g, args.setting, backend=args.backend,
                          sample=args.sample,
                          n_clusters=None if args.setting == "centralized"
                          else k,
                          spokes_per_head=args.spokes,
                          buckets=buckets)
    if plan.bucketed is not None:
        ls = plan.layout_stats()
        print(f"bucketed layout: {plan.bucketed.n_buckets} buckets, "
              f"caps {plan.bucketed.n_caps}; padding ratio "
              f"{ls['padding_ratio']:.2f}x vs dense "
              f"{ls['dense_padding_ratio']:.2f}x, peak device bytes "
              f"{ls['peak_device_bytes']:,} vs dense "
              f"{ls['dense_peak_device_bytes']:,}")
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(args.hidden,),
                        out_dim=16, sample=args.sample)
    if args.tune:
        from ..tuning import DEFAULT_CACHE_PATH, TuneCache
        cache = TuneCache.load(args.tune_cache or DEFAULT_CACHE_PATH)
        tuned = plan.tune_kernels(cfg, cache=cache, device=device)
        print(f"tuned {len(tuned)} kernel geometries "
              f"(cache: {cache.path}, {len(cache)} entries)")
    if args.stream:
        stream_main(args, g, plan, cfg, device)
        return _dump_telemetry(args)
    srv = GNNServer(plan, cfg, mode=args.mode, device=device)

    dt = srv.refresh()
    print(f"plan: {args.setting}/{args.backend}, {g.n_nodes} nodes, "
          f"{plan.n_clusters} clusters on {device}; "
          f"embedding refresh {dt * 1e3:.1f} ms")
    if args.setting != "centralized":
        print("measured traffic —",
              plan.measured_traffic(cfg, mode=args.mode).summary())
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    served = 0
    for _ in range(args.requests):
        ids = rng.integers(0, g.n_nodes, args.batch)
        srv.query(ids)
        served += len(ids)
    dt = time.perf_counter() - t0
    print(f"served {served} lookups in {dt * 1e3:.1f} ms "
          f"({served / dt:.0f} lookups/s)")
    print_cost_model(args, g, plan, cfg, tech)
    _dump_telemetry(args)


def print_cost_model(args, g, plan, cfg, tech) -> None:
    """The paper's cost model and mapper for this plan, on the modeled
    in-memory devices (not the card): calibrated or, with ``tech``,
    mapper-derived; the mapping report under ``--mapping``; the
    guideline."""
    # a per-tier pair prices the mapper with the head (compute) tier
    head_tech = tech[-1] if isinstance(tech, tuple) else tech
    m = plan.predicted_metrics(**(dict(mode="derived", technology=head_tech)
                                  if tech else {}))
    label = f"{args.setting}, {args.tech}" if tech else args.setting
    print(f"cost model ({label}): T_compute {m.t_compute:.3e} s, "
          f"T_comm {m.t_communicate:.3e} s, P {m.p_net * 1e3:.1f} mW")
    mapping = plan.compile_mapping(cfg, technology=head_tech)
    print(f"mapper-derived T_compute {mapping.t_compute:.3e} s "
          f"({mapping.t_compute / max(m.t_compute, 1e-30):.2f}x calibrated); "
          f"run with --mapping for the full report")
    if args.mapping:
        print(plan.mapping_report())    # reuses the cached mapping
    best, _ = costmodel.pick_setting(g.stats(args.dataset),
                                     n_clusters=plan.n_clusters)
    print(f"cost-model guideline for this graph: {best}")


if __name__ == "__main__":
    main()
