"""Fault-tolerant checkpointing: step-atomic, checksummed, async.

The counterpart of ``repro.checkpoint.ckpt``, with its on-disk layout:
``<dir>/step_<n>/{arrays.npz, tree.json, checksum.txt}``, written to a tmp
dir and atomically renamed, so a crash mid-write never corrupts the latest
checkpoint. Leaves are stored by position in JAX's flattening order
(``repro_torch._tree``), so a checkpoint written by the reference restores
here and one written here restores there. Leaves move to the host for
saving; bf16 and float8 leaves are stored as float32 (lossless), as the
reference stores them. Restore verifies the checksum, falls back to the
previous step on corruption, and places each leaf on the device and dtype
of the matching leaf of ``like``; ``CheckpointManager.restore`` can also
place shards on a mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from .. import _tree

# dtypes npz cannot hold: stored upcast to float32
_WIDEN = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if _is_dtensor(x):
            x = x.full_tensor()       # a collective: every rank calls it
        if x.dtype in _WIDEN:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _like(a: np.ndarray, i: int, leaf):
    """``a`` as a leaf of ``leaf``'s kind: a tensor on its device and of
    its dtype, else a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(a).to(device=leaf.device, dtype=leaf.dtype)
    return a.astype(np.asarray(leaf).dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Atomically persist a tree at a step. Returns the final directory,
    or the writing thread when ``blocking`` is False.

    A tree of DTensors is saved whole (the device-agnostic layout, so a
    checkpoint restores onto any mesh and in either package): every rank
    of the mesh gathers each leaf, rank 0 alone writes, blocking whatever
    ``blocking`` says, and every rank waits at a barrier until the step is
    on disk (the others return None)."""
    leaves, treedef = _tree.flatten(tree)
    arrays = {f"a{i}": _to_np(x) for i, x in enumerate(leaves)}
    sharded = any(_is_dtensor(x) for x in leaves)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"

    def write():
        os.makedirs(tmp, exist_ok=True)
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **arrays)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"treedef": str(treedef), "n": len(leaves),
                       "step": step}, f)
        with open(os.path.join(tmp, "checksum.txt"), "w") as f:
            f.write(_checksum(npz))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if sharded:
        rank = torch.distributed.get_rank()
        if rank == 0:
            write()
        torch.distributed.barrier()
        return final if rank == 0 else None
    if blocking:
        write()
        return final
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _steps(ckpt_dir: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like, step: int | None = None):
    """Restore into the structure of ``like``. Verifies integrity; on a
    corrupt checkpoint falls back to the previous step. Returns
    (tree, step) or (None, None)."""
    return _restore(ckpt_dir, like, step, _like)


def _restore(ckpt_dir: str, like, step, make):
    """``restore_checkpoint`` with ``make(array, i, like_leaf)`` building
    leaf ``i``."""
    leaves, treedef = _tree.flatten(like)
    step = step if step is not None else latest_step(ckpt_dir)
    while step is not None:
        d = os.path.join(ckpt_dir, f"step_{step:010d}")
        npz = os.path.join(d, "arrays.npz")
        try:
            with open(os.path.join(d, "checksum.txt")) as f:
                expect = f.read().strip()
            if _checksum(npz) != expect:
                raise IOError("checksum mismatch")
            with np.load(npz) as data:
                if len(data.files) != len(leaves):
                    raise ValueError(f"leaf count mismatch: {len(data.files)}"
                                     f" stored, {len(leaves)} in like")
                new_leaves = [make(data[f"a{i}"], i, leaf)
                              for i, leaf in enumerate(leaves)]
            return treedef.unflatten(new_leaves), step
        except (OSError, ValueError, KeyError):
            # corruption: drop this step, try the previous one
            older = [s for s in _steps(ckpt_dir) if s < step]
            step = max(older) if older else None
    return None, None


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints and saves every ``every``
    steps, optionally in a background thread."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self._pending = None

    def maybe_save(self, step: int, tree, blocking: bool = False):
        if step % self.every:
            return False
        self.finalize()
        self._pending = save_checkpoint(self.dir, step, tree,
                                        blocking=blocking)
        if self._pending is not None:       # the rank that writes
            self._gc()
        return True

    def finalize(self):
        if isinstance(self._pending, threading.Thread):
            self._pending.join()

    def _gc(self):
        if not os.path.isdir(self.dir):
            return
        for s in sorted(_steps(self.dir))[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore(self, like, mesh=None, shardings=None):
        """Restore the latest checkpoint onto ``like``'s devices; with both
        ``mesh`` (a ``launch.mesh.Mesh``) and ``shardings`` (a tree like
        ``like`` of ``launch.mesh.PartitionSpec``), place each leaf on
        ``mesh.device`` and keep this rank's block of every dimension its
        spec splits over the mesh's axis: what ``jax.device_put`` onto a
        ``NamedSharding`` leaves addressable on the rank (the reference's
        elastic restore). ``mesh`` may also be a ``DeviceMesh`` (the LM
        stack's): each leaf becomes a DTensor of its spec holding this
        rank's block, on the mesh's device, in ``like``'s dtype (``like``
        may be meta tensors); the ranks wait for each other's saves, and
        every rank restores the step rank 0 picks. Either alone restores
        plainly, as there."""
        if mesh is not None and shardings is not None and \
                hasattr(mesh, "mesh_dim_names"):
            return self._restore_on(like, mesh, shardings)
        tree, step = restore_checkpoint(self.dir, like)
        if tree is None or mesh is None or shardings is None:
            return tree, step
        leaves, treedef = _tree.flatten(tree)
        specs = treedef.flatten_up_to(shardings)
        return treedef.unflatten(_place(x, s, mesh)
                                 for x, s in zip(leaves, specs)), step

    def _restore_on(self, like, mesh, shardings):
        from ..distributed.sharding import place, spec_leaves

        dist = torch.distributed
        specs = spec_leaves(shardings)
        dev = torch.device("cpu") if mesh.device_type == "cpu" else \
            torch.device(mesh.device_type, torch.cuda.current_device())

        def make(a, i, leaf):
            x = torch.as_tensor(a).to(device=dev, dtype=leaf.dtype)
            return place(x, specs[i], mesh)

        self.finalize()
        dist.barrier()                  # every rank's saves are on disk
        pick = [latest_step(self.dir) if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(pick, src=0)
        if pick[0] is None:
            return None, None
        tree, step = _restore(self.dir, like, pick[0], make)
        steps = [None] * dist.get_world_size()
        dist.all_gather_object(steps, step)
        if len(set(steps)) > 1:         # a step corrupt on some ranks only
            raise RuntimeError(f"the ranks restored different steps: "
                               f"{steps}")
        return tree, step


def _place(x, spec, mesh):
    """Leaf ``x`` on ``mesh.device``, cut to this rank's block along each
    dimension ``spec`` names the mesh's axis on."""
    x = torch.as_tensor(x).to(mesh.device)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{x.dim()} dimensions")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis != mesh.axis:
            raise ValueError(f"spec {spec} names {axis!r}; the mesh's one "
                             f"axis is {mesh.axis!r}")
        if x.shape[dim] % mesh.size:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split over {mesh.size} ranks")
        x = x.chunk(mesh.size, dim)[mesh.rank].contiguous()
    return x
