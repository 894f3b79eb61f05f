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

``--device cpu`` runs the plain PyTorch versions of the kernels on the
host. Not ported yet: ``--plan auto``, ``--stream`` (and with it the CAM
dirty-frontier modes of ``--neighbor-mode``), ``--tech``,
``--metrics``/``--trace``, ``--tune``, ``--mapping`` and the cost-model
report lines.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import dataset_like, gnn
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
        if self.stale:
            self.refresh()
        ids = np.asarray(node_ids, np.int64)
        n = len(self.embeddings)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise IndexError(
                f"node ids must be in [0, {n}); batch spans "
                f"[{ids.min()}, {ids.max()}]")
        return self.embeddings[ids]


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
                    help="scenario k-NN construction: direct compare, CAM "
                         "plain version, or the CAM kernel (same graph)")
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
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

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
    srv = GNNServer(plan, cfg, mode=args.mode, device=device)

    dt = srv.refresh()
    print(f"plan: {args.setting}/{args.backend}, {g.n_nodes} nodes, "
          f"{plan.n_clusters} clusters on {device}; "
          f"embedding refresh {dt * 1e3:.1f} ms")
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


if __name__ == "__main__":
    main()
