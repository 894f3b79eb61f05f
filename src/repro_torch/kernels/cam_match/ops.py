"""Public wrapper of the traversal core's search CAM (``csrc/cam_match.cu``).

``cam_search`` launches the hand-written CUDA kernel on a CUDA tensor and
runs the plain version (``ref.cam_search_ref``) on a CPU tensor; there is
no other fallback. ``search`` is the backend switch:

  * ``jnp``    — the plain PyTorch version on any device.
  * ``pallas`` — the hand-written kernel.

The kernel masks ragged E and Q, zeroes negative queries and writes the
counts itself, so no sentinel padding and no fill are needed. Its launch
choices (``CamConfig``) are ``bq``, the queries of a cluster's group (4, 8
or 16), and ``be``, the entries a warp matches per chunk (128, 256 or 512;
8 and 256 by default). ``search`` resolves them from the explicit
``bq``/``be``, then ``tuned``, the tuning registry and the default
(``tuning.registry.resolve``); every choice gives the same bits.
``cam_search.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...tuning import registry as _registry
from ...tuning.space import CamConfig, CamGeometry
from .. import _build
from ..csr_aggregate.ops import stream_ptr
from ..launch_plans import cam_per
from .ref import cam_scan_ref, cam_search_ref


def _explicit(bq, be) -> CamConfig | None:
    """The caller's launch choice, or None. An explicit non-positive
    block is a caller bug, not a default request; a missing one keeps the
    default."""
    for name, val in (("bq", bq), ("be", be)):
        if val is not None and int(val) < 1:
            raise ValueError(f"{name} must be a positive block size, got "
                             f"{val!r} (pass None for the default)")
    if bq is None and be is None:
        return None
    d = CamConfig()
    return CamConfig(d.bq if bq is None else int(bq),
                     d.be if be is None else int(be))


@functools.cache
def _entry() -> ctypes._CFuncPtr:
    """The kernel's C entry point, looked up once."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    return _build.c_function("cam_match", "cam_search_i32", (
        p, p, p, p, ctypes.c_longlong, i, i, i, p))


def cam_search(ci: torch.Tensor, queries: torch.Tensor,
               config: CamConfig | None = None):
    """Match queries against the CAM entries.

    ci: [E] int32; queries: [Q] int32, contiguous, on one device. Returns
    (match [Q, E] int8, counts [Q] int32). On the card one launch writes
    both, the counts included: the wrapper allocates and checks only what
    the kernel needs, since the k-NN build calls it once per query chunk.
    ``config``: the launch choice (None: the default); a choice the kernel
    does not have raises ``ValueError`` on every device."""
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
    config = config or CamConfig()
    per = cam_per(config.bq, config.be)
    if ci.is_cpu:
        return cam_search_ref(ci, queries)
    e, q = ci.shape[0], queries.shape[0]
    match = ci.new_empty((q, e), dtype=torch.int8)
    counts = queries.new_empty(q)
    if q:
        _build.check(_entry()(ci.data_ptr(), queries.data_ptr(),
                              match.data_ptr(), counts.data_ptr(), e, q,
                              config.bq, per, stream_ptr(ci)), "cam_search")
        cam_search.launches += 1
    return match, counts


cam_search.launches = 0


def search(ci: torch.Tensor, queries: torch.Tensor, backend: str = "jnp",
           bq: int | None = None, be: int | None = None, tuned=None):
    """Match queries against the CSR column-index array.

    Returns (match [Q, E] int8, counts [Q] int32); negative query ids
    match nothing on both backends. On ``pallas`` the launch choice
    resolves from ``bq``/``be``, then ``tuned``, the tuning registry and
    the default."""
    explicit = _explicit(bq, be)
    if explicit is not None:
        cam_per(explicit.bq, explicit.be)
    if backend == "jnp":
        return cam_search_ref(ci, queries)
    if backend != "pallas":
        raise ValueError(f"unknown CAM backend {backend!r}")
    config = _registry.resolve(
        CamGeometry(e=int(ci.shape[0]), q=int(queries.shape[0])), explicit,
        tuned)
    return cam_search(ci, queries, config=config)


scan = cam_scan_ref  # the RP scan is a searchsorted on every backend
