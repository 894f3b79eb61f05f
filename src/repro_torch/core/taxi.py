"""hetGNN-LSTM taxi demand/supply forecaster (IMA-GNN §4.2, ref [26]).

The counterpart of ``repro.core.taxi``, the paper's case-study model: a
heterogeneous GNN message-passes over three edge types (road connectivity,
location proximity, destination similarity), then an LSTM consumes the
P-step history of fused node states and predicts the Q-step future
demand/supply maps X_{t+1:t+Q} in an m x n region around each taxi:
per-edge-type relational aggregation -> fuse -> LSTM -> linear head.

The aggregation runs on the plain backend (``jnp``), as the reference's
does, so the model is differentiable end to end; the LSTM's ``lax.scan``
over the history is a Python loop. Parameters are a dict of float32
tensors with the reference's names and shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _tree
from .._device import resolve_device
from ..kernels.csr_aggregate import aggregate


@dataclasses.dataclass(frozen=True)
class TaxiConfig:
    m: int = 8                 # region rows
    n: int = 8                 # region cols
    p_hist: int = 6            # history length P
    q_future: int = 3          # prediction horizon Q
    hidden: int = 64           # hetGNN fused embedding
    lstm_hidden: int = 64
    n_edge_types: int = 3      # road / proximity / destination
    sample: int = 8            # neighbor sample per edge type

    @property
    def region(self) -> int:
        return self.m * self.n


def init_params(cfg: TaxiConfig, seed: int = 0, device="cuda") -> dict:
    """Glorot-initialized parameters drawn from a CPU ``torch.Generator``
    seeded with ``seed`` (the same numbers on every device), one
    independent relational transform per edge type."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    f_in = cfg.region                      # flattened demand+supply map / step

    def glorot(a, b):
        w = torch.randn((a, b), generator=gen)
        return w * float(np.sqrt(2.0 / (a + b)))

    params = {
        # one relational transform per edge type + a self transform
        "w_rel": torch.stack([glorot(f_in, cfg.hidden)
                              for _ in range(cfg.n_edge_types)]),
        "w_self": glorot(f_in, cfg.hidden),
        "b_fuse": torch.zeros(cfg.hidden),
        # LSTM cell
        "w_i": glorot(cfg.hidden, 4 * cfg.lstm_hidden),
        "w_h": glorot(cfg.lstm_hidden, 4 * cfg.lstm_hidden),
        "b_lstm": torch.zeros(4 * cfg.lstm_hidden),
        # head: Q future region maps
        "w_out": glorot(cfg.lstm_hidden, cfg.q_future * cfg.region),
        "b_out": torch.zeros(cfg.q_future * cfg.region),
    }
    return {k: v.to(dev) for k, v in params.items()}


def params_from_numpy(params: dict, device="cuda") -> dict:
    """The port's parameters from the reference's dict of 8 arrays (numpy
    arrays, or anything ``np.asarray`` takes)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in params.items()}


def het_message_pass(params: dict, x_t: torch.Tensor,
                     neighbors: torch.Tensor, weights: torch.Tensor,
                     cfg: TaxiConfig) -> torch.Tensor:
    """One hetGNN step at one time slice.

    x_t: [N, region]; neighbors (int32) / weights (float32): [R, N, S] per
    edge type. Returns the fused node state [N, hidden]."""
    h = x_t @ params["w_self"]
    for r in range(cfg.n_edge_types):
        z_r = aggregate(x_t, neighbors[r], weights[r])      # [N, region]
        h = h + z_r @ params["w_rel"][r]
    return torch.relu(h + params["b_fuse"])


def _lstm_cell(params: dict, h, c, x):
    gates = x @ params["w_i"] + h @ params["w_h"] + params["b_lstm"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def forward(params: dict, x_hist: torch.Tensor, neighbors: torch.Tensor,
            weights: torch.Tensor, cfg: TaxiConfig) -> torch.Tensor:
    """x_hist: [P, N, m*n] history; returns [N, Q, m, n] predictions."""
    n_nodes = x_hist.shape[1]
    h = torch.zeros((n_nodes, cfg.lstm_hidden), device=x_hist.device)
    c = torch.zeros_like(h)
    for x_t in x_hist:
        m_t = het_message_pass(params, x_t, neighbors, weights, cfg)
        h, c = _lstm_cell(params, h, c, m_t)
    out = h @ params["w_out"] + params["b_out"]
    return out.reshape(n_nodes, cfg.q_future, cfg.m, cfg.n)


def loss_fn(params: dict, x_hist, neighbors, weights, target,
            cfg: TaxiConfig) -> torch.Tensor:
    """MSE over the Q-step future maps. target: [N, Q, m, n]."""
    pred = forward(params, x_hist, neighbors, weights, cfg)
    return torch.mean((pred - target) ** 2)


def grad_fn(params: dict, x_hist, neighbors, weights, target,
            cfg: TaxiConfig):
    """(loss, gradients in the structure of ``params``), both detached."""
    return _tree.value_and_grad(loss_fn, params, x_hist, neighbors, weights,
                                target, cfg)


def synthetic_stream(seed: int, n_nodes: int, steps: int, cfg: TaxiConfig,
                     device="cuda") -> torch.Tensor:
    """Deterministic synthetic spatiotemporal demand stream: a smooth
    sinusoidal field + node-specific phase, so the model has learnable
    structure. Drawn from a CPU ``torch.Generator``; returns
    [steps, N, m*n] float32 on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(steps, dtype=torch.float32)[:, None, None]
    node_phase = torch.rand((1, n_nodes, 1), generator=gen) * 6.28
    cell = torch.arange(cfg.region, dtype=torch.float32)[None, None, :]
    base = torch.sin(0.3 * t + node_phase + 0.1 * cell)
    noise = 0.05 * torch.randn((steps, n_nodes, cfg.region), generator=gen)
    return (base + noise).to(dev)
