"""Public wrapper of the traversal core's search CAM (``csrc/cam_match.cu``).

``cam_search`` launches the hand-written CUDA kernel on a CUDA tensor and
runs the plain version (``ref.cam_search_ref``) on a CPU tensor; there is
no other fallback. ``search`` is the backend switch:

  * ``jnp``    — the plain PyTorch version on any device.
  * ``pallas`` — the hand-written kernel.

The kernel masks ragged E and Q and zeroes negative queries itself, so no
sentinel padding is needed. ``bq``/``be`` are kept for the reference's
contract (a non-positive value raises); the kernel's tiles are fixed and
results do not depend on them. ``cam_search.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..csr_aggregate.ops import stream_ptr
from .ref import cam_scan_ref, cam_search_ref


def _validate_blocks(bq, be) -> None:
    """An explicit non-positive block is a caller bug, not a default
    request."""
    for name, val in (("bq", bq), ("be", be)):
        if val is not None and int(val) < 1:
            raise ValueError(f"{name} must be a positive block size, got "
                             f"{val!r} (pass None for the default)")


def cam_search(ci: torch.Tensor, queries: torch.Tensor):
    """Match queries against the CAM entries.

    ci: [E] int32; queries: [Q] int32, contiguous, on one device. Returns
    (match [Q, E] int8, counts [Q] int32)."""
    if ci.dim() != 1 or queries.dim() != 1:
        raise ValueError(f"want ci [E] and queries [Q]; got "
                         f"{tuple(ci.shape)}, {tuple(queries.shape)}")
    if ci.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f"want int32 entries and queries; got {ci.dtype}, "
                        f"{queries.dtype}")
    if ci.device != queries.device:
        raise ValueError("ci and queries must share a device")
    if not (ci.is_contiguous() and queries.is_contiguous()):
        raise ValueError("ci and queries must be contiguous")
    if ci.device.type == "cpu":
        return cam_search_ref(ci, queries)
    e, q = ci.shape[0], queries.shape[0]
    match = torch.empty((q, e), dtype=torch.int8, device=ci.device)
    counts = torch.zeros(q, dtype=torch.int32, device=ci.device)
    if e and q:
        fn = _build.c_function("cam_match", "cam_search_i32", (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p))
        _build.check(fn(ci.data_ptr(), queries.data_ptr(), match.data_ptr(),
                        counts.data_ptr(), e, q, stream_ptr(ci)),
                     "cam_search")
        cam_search.launches += 1
    return match, counts


cam_search.launches = 0


def search(ci: torch.Tensor, queries: torch.Tensor, backend: str = "jnp",
           bq: int | None = None, be: int | None = None, tuned=None):
    """Match queries against the CSR column-index array.

    Returns (match [Q, E] int8, counts [Q] int32); negative query ids
    match nothing on both backends."""
    _validate_blocks(bq, be)
    if tuned is not None:
        raise NotImplementedError(
            "kernel tuning is not ported to repro_torch yet (ROADMAP.md, "
            "port queue: tuning); pass tuned=None")
    if backend == "jnp":
        return cam_search_ref(ci, queries)
    if backend != "pallas":
        raise ValueError(f"unknown CAM backend {backend!r}")
    return cam_search(ci, queries)


scan = cam_scan_ref  # the RP scan is a searchsorted on every backend
