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

The LM stack's ``make_production_mesh``, ``preferred_tp`` and
``preferred_mesh`` are not ported here.
"""
from __future__ import annotations

import dataclasses
import datetime
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
    rank = dist.get_rank()
    if device is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, axes[0], size, rank, dev, backend)


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
