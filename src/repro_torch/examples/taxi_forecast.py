"""Taxi demand/supply forecasting (paper §4.2, ref [26]), end to end.

The counterpart of the reference's ``examples/taxi_forecast.py``. Trains
the hetGNN-LSTM with AdamW on a synthetic spatiotemporal stream over a
taxi graph with three edge types, then reports the latency and power the
IMA-GNN cost model assigns to running this workload centralized vs
decentralized (the Table-1 comparison, live). Also prints the device's
name and the median milliseconds of a training step after the first
(host clock; each step ends by reading its loss).

  PYTHONPATH=src python -m repro_torch.examples.taxi_forecast \\
      [--nodes 256] [--steps 150] [--lr 3e-3] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import costmodel, taxi
from ..core.graph import TAXI_STATS, random_graph
from ..optim import AdamWConfig, adamw_init, adamw_update


def table1_lines() -> list:
    """The cost model's Table-1 lines for the 10k-node taxi graph."""
    lines = ["IMA-GNN cost model on the 10k-node taxi graph (Table 1):"]
    for setting in ("centralized", "decentralized", "semi"):
        m = costmodel.predict(setting, TAXI_STATS, n_clusters=100)
        lines.append(f"  {setting:14s} compute {m.t_compute*1e6:9.2f} us   "
                     f"comm {m.t_communicate*1e3:9.2f} ms   "
                     f"P_compute {m.p_compute*1e3:7.2f} mW")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = taxi.TaxiConfig()
    # three edge types: road / proximity / destination-similarity graphs
    nbrs, wtss = [], []
    for r in range(cfg.n_edge_types):
        g = random_graph(args.nodes, args.nodes * 6, 1, seed=r).gcn_normalize()
        nb, wt = g.neighbor_sample(cfg.sample)
        nbrs.append(nb)
        wtss.append(wt)
    neighbors = torch.from_numpy(np.stack(nbrs)).to(dev)
    weights = torch.from_numpy(np.stack(wtss)).to(dev)

    stream = taxi.synthetic_stream(0, args.nodes,
                                   args.steps + cfg.p_hist + cfg.q_future,
                                   cfg, device=dev)
    params = taxi.init_params(cfg, seed=1, device=dev)

    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.0, warmup=10)
    opt = adamw_init(params)
    t0 = time.time()
    first = last = None
    step_ms = []
    for step in range(args.steps):
        ts = time.perf_counter()
        x_hist = stream[step:step + cfg.p_hist]
        target = stream[step + cfg.p_hist:
                        step + cfg.p_hist + cfg.q_future]
        target = target.permute(1, 0, 2).reshape(
            args.nodes, cfg.q_future, cfg.m, cfg.n)
        loss, grads = taxi.grad_fn(params, x_hist, neighbors, weights,
                                   target, cfg)
        params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
        first = float(loss) if first is None else first
        last = float(loss)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if step % 25 == 0:
            print(f"step {step:4d} mse {last:.4f}")
    dt = time.time() - t0
    print(f"\ntrained {args.steps} steps in {dt:.1f}s; "
          f"mse {first:.4f} -> {last:.4f} "
          f"({'LEARNED' if last < 0.5 * first else 'no improvement'})")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device {name}: {float(np.median(step_ms[1:] or step_ms)):.3f} "
          f"ms per step (median after the first)")

    # the Table-1 comparison for this workload, from the calibrated model
    print()
    for line in table1_lines():
        print(line)


if __name__ == "__main__":
    main()
