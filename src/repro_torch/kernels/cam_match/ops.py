"""Public wrapper of the traversal core's search CAM (``csrc/cam_match.cu``).

``cam_search`` launches the hand-written CUDA kernel on a CUDA tensor and
runs the plain version (``ref.cam_search_ref``) on a CPU tensor; there is
no other fallback. ``search`` is the backend switch:

  * ``jnp``    — the plain PyTorch version on any device.
  * ``pallas`` — the hand-written kernel.

The kernel masks ragged E and Q, zeroes negative queries and writes the
counts itself, so no sentinel padding and no fill are needed.
``bq``/``be`` are kept for the reference's contract (a non-positive value
raises); the kernel's tiles are fixed and results do not depend on them. ``cam_search.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

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


@functools.cache
def _entry() -> ctypes._CFuncPtr:
    """The kernel's C entry point, looked up once."""
    p = ctypes.c_void_p
    return _build.c_function("cam_match", "cam_search_i32", (
        p, p, p, p, ctypes.c_longlong, ctypes.c_int, p))


def cam_search(ci: torch.Tensor, queries: torch.Tensor):
    """Match queries against the CAM entries.

    ci: [E] int32; queries: [Q] int32, contiguous, on one device. Returns
    (match [Q, E] int8, counts [Q] int32). On the card one launch writes
    both, the counts included: the wrapper allocates and checks only what
    the kernel needs, since the k-NN build calls it once per query chunk."""
    if ci.dim() != 1 or queries.dim() != 1:
        raise ValueError(f"want ci [E] and queries [Q]; got "
                         f"{tuple(ci.shape)}, {tuple(queries.shape)}")
    if ci.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f"want int32 entries and queries; got {ci.dtype}, "
                        f"{queries.dtype}")
    if ci.get_device() != queries.get_device():
        raise ValueError("ci and queries must share a device")
    if not (ci.is_contiguous() and queries.is_contiguous()):
        raise ValueError("ci and queries must be contiguous")
    if ci.is_cpu:
        return cam_search_ref(ci, queries)
    e, q = ci.shape[0], queries.shape[0]
    match = ci.new_empty((q, e), dtype=torch.int8)
    counts = queries.new_empty(q)
    if q:
        _build.check(_entry()(ci.data_ptr(), queries.data_ptr(),
                              match.data_ptr(), counts.data_ptr(), e, q,
                              stream_ptr(ci)), "cam_search")
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
