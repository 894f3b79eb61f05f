"""The mesh of the SPMD runtime: one process per mesh position.

The counterpart of ``repro.launch.mesh.make_mesh`` for the GNN runtimes.
A JAX mesh is one program over N devices; here it is N processes, one per
cluster (per region head for semi), joined by a ``torch.distributed``
process group. ``Mesh`` holds that group, its one axis name, its ``size``
(an int, as JAX's ``mesh.size``), this process's rank and the device this
rank computes on.

The collective backend is the caller's choice and nothing here changes
it: ``nccl`` needs a card of its own for every rank and raises otherwise;
``gloo`` takes CPU tensors and CUDA tensors, so several ranks may share
one card (it moves CUDA tensors through host memory). The device is
``cuda:(rank % device_count)`` unless the caller names one (``"cpu"`` for
the host).

``spawn`` starts the ranks of a mesh on one host (the counterpart of
``--xla_force_host_platform_device_count``): each runs a function, and a
rank that raises, dies or overruns the deadline fails the call instead of
hanging it.

The LM stack's meshes are ``torch.distributed`` ``DeviceMesh``es with
named dimensions (``data``, ``model``, and ``pod`` across pods), over
which the sharding rules place DTensors:

  * ``make_lm_mesh`` over the running group (started by ``torchrun`` or
    ``spawn``), which must hold exactly ``prod(shape)`` ranks;
  * ``make_production_mesh``, 16 x 16 or 2 x 16 x 16, over a fake
    process group of 256 or 512 ranks in this one process: the
    counterpart of ``--xla_force_host_platform_device_count=512``. The
    fake group becomes this process's default group, so only a process
    of its own starts it (the dry run's CLI, or one a test spawns);
  * ``set_mesh``, the context that installs the ambient mesh
    ``models.common.shard`` reads;
  * ``preferred_tp`` / ``preferred_mesh``, copies of the reference's.

A gloo group on CUDA tensors runs DTensor's all-gathers through
``route_gloo_cuda_all_gather`` (see there): gloo's coalesced all-gather,
the entry point of the functional collective, reads its tensors as host
memory and ends the ranks with a segmentation fault.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

from .._device import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: this process's view of the process group."""
    group: object               # the torch.distributed process group
    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str


class PartitionSpec(tuple):
    """Per dimension of an array, the mesh axis it is split over, or None
    (the port's copy of ``jax.sharding.PartitionSpec``'s meaning):
    ``PartitionSpec()`` replicates, ``PartitionSpec("data")`` splits
    dimension 0 over the ``data`` axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def make_mesh(shape, axes, *, backend: str = "nccl", device=None,
              init_method: str | None = None, rank: int | None = None,
              timeout: float = 60.0) -> Mesh:
    """A one-axis ``Mesh`` of ``shape[0]`` ranks named ``axes[0]``.

    Joins the default process group, or starts it when none is running:
    from ``init_method`` (``"file://..."``, ``"tcp://host:port"``) as
    ``rank`` (default: ``$RANK``), or else from the environment
    ``torchrun`` sets (``env://``), with world size ``shape[0]`` and
    ``timeout`` seconds for every collective. Raises when
    the running group's world size or backend differs from the one asked
    for, and for ``nccl`` with more ranks than cards."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != 1 or len(axes) != 1:
        raise ValueError(f"the GNN runtimes take a one-axis mesh, got "
                         f"shape {shape} and axes {axes}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    size = int(shape[0])
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if size > cards:
            raise ValueError(
                f"nccl needs one card per rank: {size} ranks, {cards} "
                f"cards; pass backend='gloo' to share cards or run on the "
                f"host")
    # the device is checked before any group starts: CUDA asked for
    # (by default) on a host without it raises here
    dev = resolve_device("cuda" if device is None else device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl moves CUDA tensors only, not {dev}")
    _start_group(backend, size, init_method, rank, timeout)
    rank = dist.get_rank()
    if device is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, axes[0], size, rank, dev, backend)


def _start_group(backend: str, size: int, init_method, rank,
                 timeout: float) -> None:
    """Start the default group of ``size`` ranks, or check the running
    one's size and backend."""
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw["rank"] = int(os.environ["RANK"]) if rank is None else rank
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=size,
            timeout=datetime.timedelta(seconds=timeout), **kw)
    if dist.get_world_size() != size:
        raise ValueError(f"mesh of {size} ranks asked for in a process "
                         f"group of {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")


def make_lm_mesh(shape, axes=("data", "model"), *, backend: str = "nccl",
                 device=None, init_method: str | None = None,
                 rank: int | None = None, timeout: float = 60.0):
    """A ``DeviceMesh`` of ``shape`` with dimensions named ``axes`` over
    the default process group, which is started as ``make_mesh`` starts
    it when none runs and must hold exactly ``prod(shape)`` ranks. The
    mesh's device type is ``device``'s (default ``cuda``, the card
    ``rank % device_count``); ``nccl`` needs a card per rank."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(x) for x in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    size = math.prod(shape)
    dev = resolve_device("cuda" if device is None else device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if size > cards:
            raise ValueError(
                f"nccl needs one card per rank: {size} ranks, {cards} "
                f"cards; pass backend='gloo' to share cards or run on the "
                f"host")
    _start_group(backend, size, init_method, rank, timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
        if backend == "gloo":
            route_gloo_cuda_all_gather()
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


_ROUTE = []        # the library holding the registration, once made


def route_gloo_cuda_all_gather() -> None:
    """Run the functional all-gather of a gloo group on CUDA tensors
    through gloo's plain all-gather.

    DTensor's Shard -> Replicate calls ``_c10d_functional::
    all_gather_into_tensor``, which reaches the group through its
    coalesced entry point (``allgather_into_tensor_coalesced``); gloo
    serves that one with its CPU algorithm only, which reads CUDA memory
    as host memory and ends every rank with a segmentation fault.
    ``dist.all_gather_into_tensor`` (``_allgather_base``) stages CUDA
    tensors through the host and runs. This registers, once a process, a
    CUDA kernel of the functional op that takes that path for a gloo
    group and hands any other group (NCCL) to the op's own kernel. The
    gather is then blocking: ``wait_tensor`` on its result finds no
    pending work."""
    if _ROUTE:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _gloo_all_gather, "CUDA")
    _ROUTE.append(lib)


def _gloo_all_gather(inp: torch.Tensor, group_size: int, group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    if dist.get_backend(pg) != "gloo":
        return torch.ops._c10d_functional.all_gather_into_tensor.default \
            .redispatch(torch._C.DispatchKeySet(
                torch._C.DispatchKey.CompositeExplicitAutograd), inp,
                group_size, group_name)
    out = inp.new_empty((group_size * inp.shape[0], *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=pg)
    _gloo_all_gather.calls += 1
    return out


_gloo_all_gather.calls = 0


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh, 16 x 16 (``data``, ``model``) or 2 x 16 x 16
    (``pod``, ``data``, ``model``), over a fake process group of 256 or
    512 ranks in this process (this process is rank 0; collectives move
    nothing). Starts the fake group as the default group, or reuses a
    fake default group of the same size; raises over any other group."""
    from torch.distributed.device_mesh import init_device_mesh
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    elif dist.get_backend() != "fake" or dist.get_world_size() != size:
        raise ValueError(
            f"the production mesh needs a fake group of {size} ranks as "
            f"its process's default group; this process runs "
            f"{dist.get_backend()!r} over {dist.get_world_size()} ranks")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def set_mesh(mesh):
    """A context that installs ``mesh`` as the ambient mesh: inside it
    ``models.common.shard`` places activations on it (the counterpart of
    ``jax.set_mesh``)."""
    from ..models.common import ambient_mesh
    return ambient_mesh(mesh)


def preferred_tp(cfg, n_chips: int, max_tp: int = 16) -> int:
    """Divisibility-aware TP degree for an architecture: the largest TP
    that divides the chip count, the head count, the FFN width and, for
    MoE, the expert count (EP first)."""
    tp = max_tp
    while tp > 1:
        ok = (n_chips % tp == 0 and cfg.n_heads % tp == 0
              and cfg.d_ff % tp == 0)
        if cfg.moe is not None:
            ok = ok and cfg.moe.n_experts % tp == 0
        if ok:
            return tp
        tp //= 2
    return 1


def preferred_mesh(cfg, n_chips: int = 256, **kw):
    """(data, model) mesh with the arch-preferred TP degree over the
    running group of ``n_chips`` ranks (``kw`` as ``make_lm_mesh``)."""
    tp = preferred_tp(cfg, n_chips)
    return make_lm_mesh((n_chips // tp, tp), ("data", "model"), **kw)


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The mesh's device, after checking that ``device`` names it
    (``"cuda"`` without an index names the current card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"device {dev} disagrees with the mesh's "
                         f"{mesh.device} on rank {mesh.rank}")
    return mesh.device


def _rank_main(fn, rank: int, world: int, args: tuple, results) -> None:
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, args: tuple = (), *,
          deadline: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method; ``fn`` must be importable) and return their
    results in rank order. Waits at most ``deadline`` seconds for them
    all; the first rank that raises or dies, or the deadline, kills every
    rank still running and raises ``RuntimeError`` with what is known.

    Arguments and results travel by pickle: return host objects, not CUDA
    tensors, and keep ``args`` small (pass large data by file). Starting
    a rank writes its pickled arguments into a pipe that the new process
    reads only after it has imported the caller's main module, so
    arguments larger than the pipe's buffer start the ranks one after
    another."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    done, failed = {}, {}
    end = time.monotonic() + deadline
    try:
        while len(done) < world and not failed:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:        # let a last message arrive, then fail
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        failed.update({r: f"exited with code "
                                       f"{procs[r].exitcode}"
                                       for r in dead})
                        break
                elif time.monotonic() > end:
                    failed.update({r: f"still running after {deadline} s"
                                   for r in range(world) if r not in done})
                    break
                else:
                    continue
            (done if ok else failed)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0 if not failed else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    if failed:
        raise RuntimeError("; ".join(f"rank {r}: {m}" for r, m in
                                     sorted(failed.items())))
    return [done[r] for r in range(world)]
