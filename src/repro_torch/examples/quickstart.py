"""Quickstart: IMA-GNN in five minutes.

The counterpart of the reference's ``examples/quickstart.py``:

1. Build a synthetic graph with Cora-like statistics.
2. Run GNN inference through the in-memory-accelerator numerics
   (bit-accurate crossbar DAC/ADC model) and compare to ideal floats.
3. Ask the cost model which execution setting the paper's Eqs. 1-7
   recommend for this workload (the "design guideline").

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..core import costmodel, gnn
from ..core.graph import dataset_like
from ..kernels.crossbar_mvm import CrossbarNumerics


def main(argv=None) -> dict:
    """Run the quickstart; returns its numbers (argmax agreement, max
    relative error, the guideline's pick)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a Cora-scale synthetic graph ----------------------------------
    g = dataset_like("cora", scale=0.25, seed=0).gcn_normalize()
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"{g.feature_len}-dim features")
    neighbors, weights = g.neighbor_sample(sample=8)

    # 2. inference: ideal vs in-memory crossbar numerics ----------------
    cfg_ideal = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(64,),
                              out_dim=7, sample=8)
    cfg_xbar = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(64,),
                             out_dim=7, sample=8,
                             numerics=CrossbarNumerics(ideal=False))
    params = gnn.init_params(cfg_ideal, seed=0, device=dev)
    x = torch.from_numpy(g.features).to(dev)
    nb = torch.from_numpy(neighbors).to(dev)
    wt = torch.from_numpy(weights).to(dev)

    out_ideal = gnn.forward(params, x, nb, wt, cfg_ideal)
    out_xbar = gnn.forward(params, x, nb, wt, cfg_xbar)
    agree = float((out_ideal.argmax(-1) == out_xbar.argmax(-1))
                  .float().mean())
    err = float((out_ideal - out_xbar).abs().max()
                / (out_ideal.abs().max() + 1e-9))
    nm = cfg_xbar.numerics
    print(f"crossbar-vs-ideal: {agree:.1%} argmax agreement (untrained "
          f"random weights => near-tie logits), {err:.2%} max relative "
          f"output error ({nm.in_bits}-bit DAC / {nm.adc_bits}-bit ADC, "
          f"{nm.rows_per_xbar}-row crossbars)")

    # 3. the executable design guideline --------------------------------
    stats = g.stats("cora-like")
    best, metrics = costmodel.pick_setting(stats)
    print("\npaper Eqs. 1-7 on this workload:")
    for s, m in metrics.items():
        print(f"  {s:14s} T_compute {m.t_compute:10.3e}s  "
              f"T_comm {m.t_communicate:10.3e}s  T_net {m.t_net:10.3e}s")
    print(f"guideline picks: {best}")
    return dict(agree=agree, err=err, best=best)


if __name__ == "__main__":
    main()
