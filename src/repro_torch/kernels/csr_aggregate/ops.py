"""Public wrapper of the aggregation-core kernel (``csrc/csr_aggregate.cu``).

``csr_aggregate`` launches the hand-written CUDA kernel on a CUDA tensor
and runs the plain version (``ref.csr_aggregate_ref``) on a CPU tensor;
there is no other fallback. ``aggregate`` is the backend switch of the
composed path:

  * ``jnp``    — the plain PyTorch version on any device (the name is the
    reference's: its backend of plain array ops).
  * ``pallas`` — the hand-written kernel (the name is the reference's: its
    backend of hand-written kernels).

The kernel's launch choice is its warps per block (``AggregateConfig``, 8
by default): an explicit ``warps`` wins, else the ``TunedKernels`` bundle
passed via ``tuned=`` (threaded from ``GNNConfig.tuned``), else the
process-wide tuning registry, else the default (``tuning.registry.resolve``).
Every choice gives the same bits. The reference's feature block ``bf`` has
no counterpart (the kernel pads nothing): it is validated and ignored.
``csr_aggregate.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...tuning import registry as _registry
from ...tuning.space import AggregateConfig, AggregateGeometry
from .. import _build
from ..launch_plans import check_warps
from .ref import csr_aggregate_ref

def _validate_bf(bf) -> None:
    """An explicit ``bf=0`` is a caller bug, not a default request."""
    if bf is not None and int(bf) < 1:
        raise ValueError(f"bf must be a positive feature block size, got "
                         f"{bf!r} (pass None for the default)")


def check_gather_inputs(x: torch.Tensor, neighbors: torch.Tensor,
                        weights: torch.Tensor) -> None:
    """Raise unless (x, neighbors, weights) are what the gather kernels
    take: contiguous float32 [N, F], int32 [Nd, S] and float32 [Nd, S] on
    one device."""
    if x.dim() != 2 or neighbors.dim() != 2 \
            or weights.shape != neighbors.shape:
        raise ValueError(f"want x [N, F] and neighbors/weights [Nd, S]; got "
                         f"{tuple(x.shape)}, {tuple(neighbors.shape)}, "
                         f"{tuple(weights.shape)}")
    if (x.dtype, neighbors.dtype, weights.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise TypeError(f"want float32/int32/float32; got {x.dtype}, "
                        f"{neighbors.dtype}, {weights.dtype}")
    if not (neighbors.device == weights.device == x.device):
        raise ValueError("x, neighbors and weights must share a device")
    if not (x.is_contiguous() and neighbors.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("x, neighbors and weights must be contiguous")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device, for a
    kernel launch: the binding PyTorch's own compiled kernels launch with,
    without building a ``torch.cuda.Stream`` object per call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def csr_aggregate(x: torch.Tensor, neighbors: torch.Tensor,
                  weights: torch.Tensor,
                  config: AggregateConfig | None = None) -> torch.Tensor:
    """Weighted neighbor-feature aggregation ``z[i] = sum_s w[i,s] *
    x[nbr[i,s]]`` (slot order). x: [N, F] float32; neighbors: [Nd, S]
    int32 in [0, N); weights: [Nd, S] float32. Returns [Nd, F] float32.
    ``config``: the launch choice (warps per block; None: 8); a choice the
    kernel does not have raises ``ValueError`` on every device."""
    check_gather_inputs(x, neighbors, weights)
    warps = (config or AggregateConfig()).warps
    check_warps(warps)
    if x.device.type == "cpu":
        return csr_aggregate_ref(x, neighbors, weights)
    nd, s = neighbors.shape
    out = torch.empty((nd, x.shape[1]), dtype=torch.float32, device=x.device)
    if nd and x.shape[1]:
        fn = _build.c_function("csr_aggregate", "csr_aggregate_f32", (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p))
        _build.check(fn(x.data_ptr(), neighbors.data_ptr(),
                        weights.data_ptr(), out.data_ptr(), nd, s,
                        x.shape[1], warps, stream_ptr(x)), "csr_aggregate")
        csr_aggregate.launches += 1
    return out


csr_aggregate.launches = 0


def aggregate(x: torch.Tensor, neighbors: torch.Tensor,
              weights: torch.Tensor, backend: str = "jnp",
              bf: int | None = None, warps: int | None = None,
              tuned=None) -> torch.Tensor:
    """Weighted neighbor aggregation ``Z = sum_s w[:, s] * X[nbr[:, s]]``.

    ``bf`` is kept for the reference's contract (a non-positive value
    raises); the kernel pads nothing and results do not depend on it. On
    ``pallas`` the kernel's warps per block resolve from ``warps``, then
    ``tuned``, the tuning registry and the default."""
    _validate_bf(bf)
    if backend == "jnp":
        return csr_aggregate_ref(x, neighbors, weights)
    if backend != "pallas":
        raise ValueError(f"unknown aggregation backend {backend!r}")
    geom = AggregateGeometry(nd=int(neighbors.shape[0]), n=int(x.shape[0]),
                             f=int(x.shape[1]),
                             sample=int(neighbors.shape[1]))
    config = _registry.resolve(
        geom, None if warps is None else AggregateConfig(int(warps)), tuned)
    return csr_aggregate(x, neighbors, weights, config=config)
