"""Decentralized GNN serving on the SPMD runtime (the paper's Fig. 4b).

The counterpart of the static demo of the reference's
``examples/gnn_serve.py``. Partitions a Collab-like graph into K clusters,
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

The reference's streaming (``--stream``), bucketed (``--buckets``) and
technology (``--tech``) demos are not ported here.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core import costmodel, gnn
from ..core.graph import dataset_like
from ..core.partition import build_local_subgraphs, gather_features, partition
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


def main(argv=None) -> dict:
    """Run the demo; returns ``{mode: max|err| vs the oracle}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=0,
                    help="default: one per rank (it must equal the world)")
    ap.add_argument("--sample", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default="nccl", dest="dist_backend",
                    choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
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
