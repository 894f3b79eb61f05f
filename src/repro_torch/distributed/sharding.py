"""Sharding rules: TP / FSDP / EP / ZeRO-1 partition specs for every arch.

The counterpart of ``repro.distributed.sharding``, a copy of its rules
over the port's trees (dicts and lists of tensors; meta tensors, or
anything else with ``.shape``, stand in for ``jax.ShapeDtypeStruct``).
Each rule returns a tree of ``launch.mesh.PartitionSpec`` with the
reference's entries, ``("pod", "data")`` tuples included.

Strategy (DESIGN.md §6):
  * TP over 'model': attention projections column/row-parallel on the packed
    head dim, FFN wi col / wo row, vocab-sharded embeddings+logits when the
    vocab divides.
  * EP over 'model' for MoE when n_experts divides the axis (deepseek-v3);
    otherwise inner-dim TP of the expert FFN (grok-1's 8 experts).
  * FSDP over 'data' for >= 9 B archs: params (and their optimizer state)
    additionally sharded on the first divisible non-TP dim of 1,024 or more.
  * ZeRO-1 everywhere: optimizer moments get the FSDP treatment even when
    params are replicated over 'data'.
  * Multi-pod: the 'pod' axis joins data parallelism (batch + FSDP/ZeRO).

Divisibility is always checked; a dimension that does not divide is
replicated. The stacked cycles' leading axis is never sharded, so the
trunk can ``unbind`` it.

The rules read only ``mesh.shape[axis]`` and ``mesh.axis_names``, so they
take any mesh-like object: a ``DeviceMesh`` through ``mesh_shape`` below,
or a stand-in. ``placements`` turns a spec into DTensor placements.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .. import _tree
from ..launch.mesh import PartitionSpec as P
from ..models.config import ModelConfig

FSDP_ARCHS = {"yi-34b", "grok-1-314b", "deepseek-v3-671b",
              "recurrentgemma-9b"}


class MeshShape:
    """``.shape`` (axis name -> size) and ``.axis_names`` of a
    ``DeviceMesh``, what the rules read."""

    def __init__(self, device_mesh):
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))


def mesh_shape(mesh):
    """``mesh`` as the rules read it: a ``DeviceMesh`` is wrapped, any
    other object (with ``shape`` and ``axis_names``) passes."""
    return MeshShape(mesh) if hasattr(mesh, "mesh_dim_names") else mesh


def dp_axes(mesh) -> tuple:
    mesh = mesh_shape(mesh)
    return (("pod", "data") if "pod" in mesh.axis_names else ("data",))


def _axis_size(mesh, axes) -> int:
    axes = [axes] if isinstance(axes, str) else list(axes)
    return int(math.prod(mesh.shape[a] for a in axes))


def _div(size: int, mesh, axis) -> bool:
    return size % _axis_size(mesh, axis) == 0


def _maybe(size: int, mesh, axis):
    """axis if it divides size, else None (replicated)."""
    return axis if size % _axis_size(mesh, axis) == 0 else None


def _tree_map_with_names(fn, tree):
    """``fn(names, leaf)`` on every leaf; ``names`` are the dict keys on
    the way to the leaf (list positions are not names, as the
    reference's ``DictKey`` filter drops ``SequenceKey``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_with_names(
            lambda n, x, k=k: fn((k,) + n, x), v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_tree_map_with_names(fn, t) for t in tree)
    return fn((), tree)


def _leaf_spec(names, leaf, cfg: ModelConfig, mesh) -> P:
    """TP spec for one parameter leaf, from its key names + shape."""
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    scanned = "main" in names
    nd = len(shape) - (1 if scanned else 0)   # dims after the cycle axis

    def out(*spec):
        spec = tuple(spec) + (None,) * (nd - len(spec))
        return P(*(((None,) + spec) if scanned else spec))

    m = "model"
    if name == "tok":
        return out(_maybe(shape[-2], mesh, m), None)
    if name == "head":
        return out(None, _maybe(shape[-1], mesh, m))
    # attention / mixers (column-parallel in, row-parallel out)
    if name in ("wi", "wo") and nd == 3:             # MoE experts [E, ., .]
        if _div(shape[-3], mesh, m):
            return out(m, None, None)                # EP
        if name == "wi":
            return out(None, None, _maybe(shape[-1], mesh, m))
        return out(None, _maybe(shape[-2], mesh, m), None)
    if name in ("wq", "wk", "wv", "wuq", "wukv", "wx", "w_a", "w_i",
                "wr", "wg", "w1"):
        return out(None, _maybe(shape[-1], mesh, m))
    if name in ("wo",):
        return out(_maybe(shape[-2], mesh, m), None)
    if name in ("wdq", "wdkv", "w2", "proj"):
        return out(None, None)                       # small latents: replicate
    if name == "conv":
        return out(None, _maybe(shape[-1], mesh, m))
    if name == "lam":
        return out(_maybe(shape[-1], mesh, m))
    if name in ("shared_wi",):
        return out(None, _maybe(shape[-1], mesh, m))
    if name in ("shared_wo",):
        return out(_maybe(shape[-2], mesh, m), None)
    if name == "router":
        return out(None, None)
    if name in ("wi",):                              # dense FFN [D, F]
        return out(None, _maybe(shape[-1], mesh, m))
    return out(*([None] * nd))


def _fsdp_augment(spec: P, leaf, mesh, dp) -> P:
    """Add 'data'(+pod) sharding on the first free divisible dim."""
    used = set()
    for p in spec:
        for a in (p if isinstance(p, tuple) else (p,)):
            used.add(a)
    if used & set(dp):                 # already FSDP-sharded; idempotent
        return spec
    parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, leaf.shape)):
        if p is None and s % _axis_size(mesh, dp) == 0 and s >= 1024:
            parts[i] = dp if len(dp) > 1 else dp[0]
            break
    return P(*parts)


def param_shardings(params: Any, cfg: ModelConfig, mesh,
                    fsdp: bool | None = None):
    """PartitionSpec tree for a params tree (tensors, meta tensors or any
    leaves with ``.shape``)."""
    mesh = mesh_shape(mesh)
    fsdp = (cfg.name in FSDP_ARCHS) if fsdp is None else fsdp
    dp = dp_axes(mesh)

    def one(names, leaf):
        spec = _leaf_spec(names, leaf, cfg, mesh)
        if fsdp:
            spec = _fsdp_augment(spec, leaf, mesh, dp)
        return spec

    return _tree_map_with_names(one, params)


def _map2(fn, specs, tree):
    """``fn(spec, leaf)`` over ``tree``'s leaves and the matching specs."""
    leaves, tdef = _tree.flatten(tree)
    specs = spec_leaves(specs)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tdef.unflatten(fn(s, x) for s, x in zip(specs, leaves))


def spec_leaves(specs) -> list:
    """The ``PartitionSpec`` leaves of a spec tree, in the order
    ``_tree.flatten`` gives the matching tree's leaves (a spec is a
    tuple, so it is taken whole, not walked)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if type(specs) in (list, tuple):
        return [s for t in specs for s in spec_leaves(t)]
    if specs is None:
        return []
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def optimizer_shardings(param_specs: Any, params: Any, mesh):
    """ZeRO-1: moments get FSDP sharding even when params don't."""
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    return _map2(lambda spec, leaf: _fsdp_augment(spec, leaf, mesh, dp),
                 param_specs, params)


def activation_rules(cfg: ModelConfig, mesh,
                     seq_parallel: bool = False) -> dict:
    """Logical-name -> PartitionSpec map for models.common.shard().

    ``seq_parallel``: Megatron-style sequence parallelism -- the residual
    stream between blocks is sharded on seq over 'model'."""
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    b = dp if len(dp) > 1 else dp[0]
    m = "model"
    res = P(b, m, None) if seq_parallel else P(b, None, None)
    rules = {
        "embed": res,
        "residual": res,
        "ffn_hidden": P(b, None, _maybe(2 * cfg.d_ff, mesh, m)),
        "logits": P(b, None, _maybe(cfg.vocab, mesh, m)),
        # attention-free recurrences: width-sharded, seq-local scan
        "rec_width": P(b, None, _maybe(cfg.rglru_width or cfg.d_model,
                                       mesh, m)),
    }
    if cfg.n_heads % _axis_size(mesh, m) == 0:
        rules["heads"] = P(b, None, m, None)
    if cfg.moe is not None:
        # grouped dispatch buffers [G, E, C, D]: G over data always; E over
        # model when divisible (EP), else expert-FFN hidden TP.
        if cfg.moe.n_experts % _axis_size(mesh, m) == 0:
            rules["expert_buf"] = P(b, m, None, None)
            rules["expert_hidden"] = P(b, m, None, None)
        else:
            rules["expert_buf"] = P(b, None, None, None)
            rules["expert_hidden"] = P(b, None, None, m)
        # combine reads y_buf replicated over 'model' (explicit all-gather)
        rules["expert_out"] = P(b, None, None, None)
    return rules


def _is_struct(x) -> bool:
    """A ``(shape, dtype)`` pair of ``launch.steps.batch_struct``."""
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and not isinstance(x[1], (tuple, list, dict)))


def _map_batch(fn, tree):
    if _is_struct(tree) or hasattr(tree, "shape"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_batch(fn, v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_map_batch(fn, t) for t in tree)
    return fn(tree)


def batch_shardings(mesh, kind: str, batch_shape_tree: Any):
    """Input shardings: batch dim over data(+pod); everything else replicated
    unless batch == 1 (long-context: replicate)."""
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    b = dp if len(dp) > 1 else dp[0]

    def one(leaf):
        shape = leaf[0] if _is_struct(leaf) else tuple(
            getattr(leaf, "shape", ()))
        if not shape:
            return P()
        if shape[0] % _axis_size(mesh, dp) == 0:
            return P(b, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _map_batch(one, batch_shape_tree)


def cache_shardings(caches: Any, cfg: ModelConfig, mesh):
    """KV/state caches: batch over data(+pod) when divisible, KV-heads/latent
    over model when divisible."""
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    dpn = dp if len(dp) > 1 else dp[0]
    msize = _axis_size(mesh, "model")

    def one(names, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) < 1:
            return P()
        scanned = "main" in names
        shape = tuple(leaf.shape[1:] if scanned else leaf.shape)
        if not shape:
            return P()
        parts = [None] * len(shape)
        if shape[0] % _axis_size(mesh, dp) == 0:
            parts[0] = dpn
        # shard kv-head / latent / width dims over model where they divide
        name = names[-1] if names else ""
        if name in ("k", "v") and len(shape) == 4:
            if shape[2] % msize == 0:
                parts[2] = "model"          # KV heads
            elif shape[1] % msize == 0:
                parts[1] = "model"          # KV seq (flash-decoding style)
            elif shape[3] % msize == 0:
                parts[3] = "model"          # head_dim (partial-sum attention)
        if name in ("ckv", "kpe") and len(shape) == 3:
            # MLA latent/rope caches: shard the SEQ dim (flash-decoding)
            if shape[1] % msize == 0:
                parts[1] = "model"
            elif shape[2] % msize == 0:
                parts[2] = "model"
        if name in ("s",) and len(shape) == 4 and shape[1] % msize == 0:
            parts[1] = "model"
        if name in ("h", "conv", "x_prev", "chan_prev") and \
                shape[-1] % msize == 0:
            parts[-1] = "model"
        if scanned:
            parts = [None] + parts
        return P(*parts)

    return _tree_map_with_names(one, caches)


def placements(spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: per mesh
    dimension, ``Shard(d)`` where tensor dimension ``d`` is split over
    that axis, else ``Replicate()``. A tuple entry splits one tensor
    dimension over several axes; DTensor splits left to right over the
    mesh's dimensions, which is JAX's major-to-minor order when the tuple
    lists the axes in the mesh's order (``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------- DTensors
def local_block(x, pl, device_mesh, coordinate=None):
    """This rank's block of the full tensor ``x`` under placements
    ``pl``: cut along each ``Shard`` dimension, mesh dimension by mesh
    dimension, as DTensor cuts (``torch.chunk``)."""
    from torch.distributed.tensor import Shard

    coord = device_mesh.get_coordinate() if coordinate is None \
        else coordinate
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = device_mesh.size(i)
            if x.shape[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of size "
                                 f"{x.shape[p.dim]} does not split over "
                                 f"{n} ranks")
            x = x.chunk(n, p.dim)[coord[i]]
    return x


def place(x, spec, device_mesh):
    """The full tensor ``x`` (the same on every rank) as a DTensor of
    ``spec``: this rank keeps its block, cut locally, with no
    collective. A block cut from ``x`` is copied into storage of its own,
    so that the full tensor can be freed (a dim-0 block is a view of it)."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, device_mesh)
    block = local_block(x, pl, device_mesh)
    block = block.clone(memory_format=torch.contiguous_format) \
        if block.numel() < x.numel() else block.contiguous()
    return DTensor.from_local(block, device_mesh, pl, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def distribute(tree, specs, device_mesh):
    """Every leaf of ``tree`` placed by its spec (``place``)."""
    return _map2(lambda spec, x: place(x, spec, device_mesh), specs, tree)


def redistribute(tree, specs, device_mesh):
    """Every DTensor leaf of ``tree`` moved to the placements of its spec
    (a collective where the placement changes)."""
    return _map2(lambda spec, x: x.redistribute(
        device_mesh, placements(spec, device_mesh)), specs, tree)


def full(x):
    """The whole tensor of a DTensor (an all-gather of its blocks on
    every rank); a plain tensor as it is."""
    return x.full_tensor() if type(x).__name__ == "DTensor" else x
