"""GNN inference and training in PyTorch on the IMA-GNN dataflow.

The counterpart of ``repro.core.gnn``. Per layer,
  aggregation         Z = A_hat @ X       (traversal + aggregation cores)
  feature extraction  H = act(Z @ W + b)  (MVM crossbar core)
with ideal float numerics or, under ``CrossbarNumerics(ideal=False)``, the
bit-accurate crossbar numerics.

Backends (``GNNConfig.backend``; the names are the reference's):
  * ``jnp``    — plain PyTorch ops on any device.
  * ``pallas`` — composed: the hand-written aggregation kernel
    (``csr_aggregate``), then ``torch.matmul`` or the plain crossbar
    numerics.
  * ``fused``  — both stages in the hand-written fused kernels, Z kept out
    of device memory.
On a CPU tensor the kernels run their plain versions. Parameters are a
list of ``{"w": [F, H], "b": [H]}`` float32 tensors.

``forward`` serves and keeps no gradient. ``loss_fn`` (the mean NLL of the
labels) runs the same layers with autograd on, on every backend;
``grad_fn`` returns the loss and its gradients on ``jnp`` only, as the
reference trains only there: the hand-written kernels are forward-only
(a Pallas call has no VJP), so ``pallas`` and ``fused`` raise
``NotImplementedError`` on every device. The ReLU's gradient at 0 is 0,
as ``jax.nn.relu``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _tree
from .._device import resolve_device
from ..kernels.crossbar_mvm import CrossbarNumerics, crossbar_matmul_signed_ref
from ..kernels.csr_aggregate import aggregate
from ..kernels.fused_layer import fused_gnn_layer

BACKENDS = ("jnp", "pallas", "fused")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    in_dim: int
    hidden_dims: tuple = (128,)
    out_dim: int = 16
    sample: int = 16                       # padded neighbor sample size S
    numerics: CrossbarNumerics = CrossbarNumerics(ideal=True)
    backend: str = "jnp"                   # one of BACKENDS
    final_activation: bool = False
    tuned: object | None = None            # TunedKernels bundle (tuning)

    @property
    def dims(self) -> tuple:
        return (self.in_dim, *self.hidden_dims, self.out_dim)


def init_params(cfg: GNNConfig, seed: int = 0, device="cuda") -> list:
    """Glorot-initialized (W, b) per layer, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same numbers on every
    device), then moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = []
    dims = cfg.dims
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=gen)
        w = w * float(np.sqrt(2.0 / (fan_in + fan_out)))
        params.append({"w": w.to(dev), "b": torch.zeros(fan_out, device=dev)})
    return params


def params_from_numpy(params, device="cuda") -> list:
    """The port's parameters from the reference's ``[{"w": [F, H],
    "b": [H]}, ...]`` (numpy arrays, or anything ``np.asarray`` takes)."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k], np.float32), device=dev)
             for k in ("w", "b")} for layer in params]


def _transform(z: torch.Tensor, w: torch.Tensor,
               cfg: GNNConfig) -> torch.Tensor:
    if cfg.numerics.ideal:
        return z @ w
    return crossbar_matmul_signed_ref(z, w, cfg.numerics)


def layer_step(h: torch.Tensor, neighbors: torch.Tensor,
               weights: torch.Tensor, layer: dict, cfg: GNNConfig,
               act: bool) -> torch.Tensor:
    """One GNN layer on one feature table, dispatched on ``cfg.backend``;
    honors ``cfg.numerics`` on every backend."""
    if cfg.backend == "fused":
        return fused_gnn_layer(h, neighbors, weights, layer["w"],
                               layer["b"], cfg.numerics, relu=act,
                               tuned=cfg.tuned)
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; "
                         f"choose from {BACKENDS}")
    z = aggregate(h, neighbors, weights, backend=cfg.backend,
                  tuned=cfg.tuned)
    h = _transform(z, layer["w"], cfg) + layer["b"]
    return torch.relu(h) if act else h


def _forward(params: list, x, neighbors, weights, cfg: GNNConfig):
    h = x
    n_layers = len(params)
    for i, layer in enumerate(params):
        act = i < n_layers - 1 or cfg.final_activation
        h = layer_step(h, neighbors, weights, layer, cfg, act)
    return h


@torch.no_grad()
def forward(params: list, x: torch.Tensor, neighbors: torch.Tensor,
            weights: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Full-graph GNN forward on the device of ``x``.

    x: [N, F_in] float32; neighbors (int32) / weights (float32): [N, S]
    padded sample with self loops. Returns [N, out_dim] float32."""
    return _forward(params, x, neighbors, weights, cfg)


def loss_fn(params: list, x, neighbors, weights, labels,
            cfg: GNNConfig) -> torch.Tensor:
    """Cross-entropy node-classification loss (mean over the labeled
    nodes); ``labels``: [N] integer classes."""
    logits = _forward(params, x, neighbors, weights, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None]).squeeze(-1)
    return torch.mean(nll)


def grad_fn(params: list, x, neighbors, weights, labels, cfg: GNNConfig):
    """(loss, gradients in the structure of ``params``), both detached.
    Only the ``jnp`` backend is differentiable."""
    if cfg.backend != "jnp":
        raise NotImplementedError(
            f"backend {cfg.backend!r} runs forward-only kernels; train on "
            f"backend 'jnp'")
    return _tree.value_and_grad(loss_fn, params, x, neighbors, weights,
                                labels, cfg)
