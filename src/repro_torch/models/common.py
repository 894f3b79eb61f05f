"""Shared building blocks: norms, RoPE/M-RoPE, FFNs, init, sharding hooks.

The counterpart of ``repro.models.common`` on PyTorch tensors. Where the
reference lets ``jnp`` promote mixed dtypes (a bf16 weight times an f32
activation), the port casts explicitly: ``torch.matmul`` refuses mixed
dtypes. ``jax.nn.gelu`` is the tanh approximation, so ``gelu`` here passes
``approximate="tanh"``.

Initialisation draws from an ``InitKey``: a ``torch.Generator`` on the
parameters' device and the leading shape of a stacked parameter (the
repeated cycles' leading axis). Its bits differ from ``jax.random``'s;
weights carry across the packages through ``params_from_numpy``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import _tree
from .. import telemetry as tel
from .._device import resolve_device
from .config import ModelConfig

# ---------------------------------------------------------------- sharding
# Logical activation-sharding hooks. A launcher installs a {name:
# PartitionSpec} map and a mesh; inside the model activations are tagged by
# logical name. With no map installed (the tests, one card) this is a
# no-op, as in the reference.
_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(rules: dict):
    old = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = old


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``) as the mesh ``shard`` places
    activations on (``launch.mesh.set_mesh``). Inside, a plain tensor
    that meets a DTensor is taken as replicated: the plain tensors of the
    model (masks, positions, RoPE tables, constants) are computed alike
    on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    old = getattr(_CTX, "mesh", None)
    _CTX.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _CTX.mesh = old


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """Place activation ``x`` as the installed rules place ``name``: a
    DTensor is redistributed to the rule's placements on the ambient mesh
    (the counterpart of ``with_sharding_constraint``). No rule for
    ``name``: ``x`` as it is."""
    rules = getattr(_CTX, "rules", None)
    if not rules or name not in rules:
        return x
    if not _is_dtensor(x):
        raise TypeError(f"activation {name!r} is a plain tensor under "
                        f"sharding rules; the parameters must be DTensors")
    from ..distributed.sharding import placements
    mesh = getattr(_CTX, "mesh", None) or x.device_mesh
    # a block cut from a replicated tensor along an inner dimension is a
    # strided view; later views of it (einsum's) need it dense
    return _Place.apply(x, mesh, _even(placements(rules[name], mesh),
                                       x.shape, mesh)).contiguous()


def _even(pl, shape, mesh) -> tuple:
    """``pl`` with every split that does not divide its dimension evenly
    replaced by a replica (a batch of 1 over 16 data ranks stays whole,
    as ``batch_shardings`` keeps it; DTensor cannot reshape an uneven
    split)."""
    from torch.distributed.tensor import Replicate

    out = list(pl)
    for d in range(len(shape)):
        on = [i for i, p in enumerate(pl) if p.is_shard(d)]
        if on and shape[d] % math.prod(mesh.size(i) for i in on):
            for i in on:
                out[i] = Replicate()
    return tuple(out)


class _Place(torch.autograd.Function):
    """``x.redistribute(mesh, pl)`` whose gradient comes back in ``x``'s
    placements with its partial sums reduced (Megatron's pair of
    conjugate operators: an all-reduce forward is an identity backward,
    and a partial gradient is all-reduced here, once). DTensor's own
    backward passes a partial gradient on, and the products upstream then
    gather their weights to take it."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh = mesh
        ctx.pl = tuple(x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        return g.redistribute(ctx.mesh, [
            Replicate() if p.is_partial() else p for p in ctx.pl]), None, None


def settle(x):
    """A DTensor's pending partial sums reduced over their mesh
    dimensions (an all-reduce), its other placements kept; anything else
    as it is: a value DTensor leaves partial (a reduction over a split
    dimension, a gather from split logits) made whole where the next op
    would redistribute it through a path DTensor does not run."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _gather_dim(x, dim: int, parts: int):
    """``x``, gathered over the mesh dimensions that shard tensor
    dimension ``dim`` unless their shards split ``parts`` evenly (an
    all-gather; GSPMD's reshard where a head split does not divide the
    model axis). Plain tensors as they are."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if not on or parts % math.prod(mesh.size(i) for i in on) == 0:
        return x
    return x.redistribute(mesh, [Replicate() if i in on else p
                                 for i, p in enumerate(x.placements)])


def split_heads(x, n: int, d: int):
    """[..., n*d] -> [..., n, d]; a DTensor whose last dimension is split
    over more shards than divide ``n`` is gathered on it first."""
    x = _gather_dim(x, -1, n)
    return x.reshape(tuple(x.shape[:-1]) + (n, d))


def merge_heads(x):
    """[..., n, d] -> [..., n*d]. For a DTensor the gradient that comes
    back is put in the forward's placements first (``_Place``): a row-
    parallel product's gradient splits the merged dimension over shards
    that need not divide the heads, and the reshape's backward cannot
    unflatten that."""
    y = x.reshape(tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],))
    if not _is_dtensor(y):
        return y
    return _Place.apply(y, y.device_mesh, y.placements)


def _batch_placements(mesh, batch: int) -> tuple:
    """Dimension 0 over the data axes (``pod``, ``data``) where the batch
    divides them, replicated otherwise and over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    if batch % math.prod(mesh.size(i) for i in dp):
        dp = []
    return tuple(Shard(0) if i in dp else Replicate()
                 for i in range(len(names)))


def batch_local(fn, *args, batch: int, sums: int = 0):
    """``fn`` on this rank's block of the batch: each DTensor argument is
    redistributed to dimension 0 over the data axes (``batch`` rows;
    replicated where it does not divide) and handed over as its local
    tensor; each tensor ``fn`` returns comes back as a DTensor of that
    placement, except the last ``sums``, which are per-rank partial sums
    over the data axes. For the model's ops that DTensor has no strategy
    for or that mix index tensors with data (the MoE dispatch and combine,
    ``searchsorted`` and ``index_select``): every batch row is computed on
    the ranks holding it. No DTensor argument: ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if _is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor

    pl = _batch_placements(mesh, batch)
    local = [a.redistribute(mesh, pl).to_local() if _is_dtensor(a) else a
             for a in args]
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = [outs] if single else list(outs)
    dp = [i for i, p in enumerate(pl) if p.is_shard(0)]
    wrapped = [_sum_over(o, mesh, dp) if i >= len(outs) - sums
               else DTensor.from_local(o, mesh, pl, run_check=False)
               for i, o in enumerate(outs)]
    return wrapped[0] if single else tuple(wrapped)


def whole(p, batch: int):
    """A DTensor parameter gathered whole on every rank as a plain tensor,
    for use inside ``batch_local`` (its gradient on a rank sums that
    rank's batch rows: partial over the data axes that split ``batch``);
    a plain tensor as it is."""
    if not _is_dtensor(p):
        return p
    from torch.distributed.tensor import Partial, Replicate
    mesh = p.device_mesh
    return p.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if q.is_shard(0) else Replicate()
                         for q in _batch_placements(mesh, batch)])


def _rows_of(t, mesh, pl):
    """This rank's block of ``t`` under ``pl`` (a DTensor redistributed,
    or a plain tensor every rank holds whole)."""
    if _is_dtensor(t):
        return t.redistribute(mesh, pl).to_local()
    from ..distributed.sharding import local_block
    return local_block(t, pl, mesh)


def _sum_over(local, mesh, over, pl=None):
    """The sum of the ranks' ``local`` values over the mesh dimensions
    ``over``, as a DTensor placed elsewhere as ``pl`` places ``local``
    (default: replicated): the blocks are stacked on a new leading
    dimension those mesh dimensions split, and summed over it (a DTensor
    partial sum, whose gradient is every rank's own; ``from_local`` with a
    partial placement passes its gradient on differently across torch
    releases)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    stk = [Shard(0) if i in over else Shard(pl[i].dim + 1)
           if pl is not None and pl[i].is_shard() else Replicate()
           for i in range(mesh.ndim)]
    return DTensor.from_local(local[None], mesh, stk, run_check=False).sum(0)


def _block(mesh, dims) -> int:
    """This rank's block index along a tensor dimension the mesh
    dimensions ``dims`` split in turn (major to minor, as DTensor)."""
    coord = mesh.get_coordinate()
    block = 0
    for i in dims:
        block = block * mesh.size(i) + coord[i]
    return block


# ---------------------------------------------------------------- tracing
def trace_backward(name: str, out, inp: torch.Tensor, **attrs) -> None:
    """Under autograd, the backward of the work from ``inp`` to ``out`` (a
    tensor or a tuple of them) as a ``name`` interval
    (``telemetry.record``) on the thread that runs it: from the gradient of
    the last of ``out`` arriving to the gradient of ``inp``, which only
    that work reads, being complete. Gradient hooks; nothing where a
    tensor takes no gradient."""
    outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    if not (inp.requires_grad and all(o.requires_grad for o in outs)):
        return
    n, arrived, opened = len(outs), [], []

    def arrive(g):
        arrived.append(None)
        if len(arrived) == n:
            opened.append(time.perf_counter())

    for o in outs:
        o.register_hook(arrive)
    inp.register_hook(lambda g: tel.record(
        name, opened.pop(), time.perf_counter(), **attrs) if opened else None)


# ---------------------------------------------------------------- numerics
def dtype_of(name: str) -> torch.dtype:
    """``torch.dtype`` for a config's dtype name (``"bfloat16"``, ...)."""
    return getattr(torch, name)


def cast(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x`` in the config's dtype (the reference's ``cast``)."""
    return x.to(dtype_of(cfg.dtype))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to their common dtype,
    as ``jnp.einsum`` promotes them."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: exact products
    of the (bf16) operands, summed in float32."""
    return torch.einsum(eq, *(o.float() for o in ops))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """x / rms(x) * (1 + scale), in float32; returned in ``dtype`` (by
    default x's)."""
    dt = dtype or x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension (the population variance), with
    a weight and a bias, in float32; returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x - x.mean(-1, keepdim=True)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------- init
@dataclasses.dataclass(frozen=True)
class InitKey:
    """Where parameters are drawn: ``gen`` on the parameters' device, and
    ``lead``, the leading shape every parameter drawn with it gets (the
    stacked cycles'). ``gen`` None draws on the meta device: shapes and
    dtypes, nothing allocated (the reference's ``jax.eval_shape``)."""
    gen: torch.Generator | None
    lead: tuple = ()

    @classmethod
    def from_seed(cls, seed: int, device="cuda") -> "InitKey":
        dev = resolve_device(device)
        return cls(torch.Generator(device=dev).manual_seed(int(seed)))

    @classmethod
    def abstract(cls) -> "InitKey":
        """A key whose parameters are meta tensors."""
        return cls(None)

    @property
    def device(self) -> torch.device:
        return torch.device("meta") if self.gen is None else self.gen.device

    def stacked(self, n: int) -> "InitKey":
        return dataclasses.replace(self, lead=self.lead + (n,))


def init_dense(key: InitKey, shape, scale: float | None = None,
               dtype="bfloat16") -> torch.Tensor:
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(key.lead + shape, generator=key.gen, device=key.device,
                    dtype=torch.float32) * s
    return w.to(dtype_of(dtype))


def init_full(key: InitKey, shape, value: float, dtype="float32"
              ) -> torch.Tensor:
    """A constant parameter (norm scales, decay bases) of ``key``'s lead."""
    return torch.full(key.lead + tuple(shape), value,
                      dtype=dtype_of(dtype), device=key.device)


# ---------------------------------------------------------------- RoPE
def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               sections: tuple = ()) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, Dh]; pos: [B, S] or [3, B, S]
    (M-RoPE). Rotates halves (``jnp.split``), not interleaved pairs.

    With ``sections`` (qwen2-vl M-RoPE), the Dh/2 frequency pairs are split
    into len(sections) groups, group g rotating by pos[g] (temporal/height/
    width axes). Text-only inputs pass identical pos per group.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)       # [Dh/2]
    if sections:
        if sum(sections) != dh // 2 or pos.dim() != 3:
            raise ValueError(f"M-RoPE needs sections summing to {dh // 2} "
                             f"and pos [3, B, S]: {sections}, "
                             f"{tuple(pos.shape)}")
        parts = []
        start = 0
        for g, sec in enumerate(sections):
            f = freqs[start:start + sec]
            parts.append(pos[g].float()[..., None] * f)
            start += sec
        angles = torch.cat(parts, dim=-1)                # [B, S, Dh/2]
    else:
        if pos.dim() == 3:
            pos = pos[0]
        angles = pos.float()[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]                # [B, S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- FFN
def init_ffn(key: InitKey, cfg: ModelConfig, d_ff: int | None = None
             ) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": init_dense(key, (d, 2 * f), dtype=cfg.dtype),
                "wo": init_dense(key, (f, d), dtype=cfg.dtype)}
    return {"wi": init_dense(key, (d, f), dtype=cfg.dtype),
            "wo": init_dense(key, (f, d), dtype=cfg.dtype)}


def swiglu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # a DTensor split over [gate | up] is gathered first: a rank's block
    # holds gate or up columns, not both halves of its own columns
    gate, up = torch.chunk(_gather_dim(h, -1, 1), 2, dim=-1)
    return F.silu(gate.float()).to(dtype) * up


def ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = einsum("...d,df->...f", x, params["wi"])
    if cfg.act == "swiglu":
        h = swiglu(h, x.dtype)
    else:
        h = gelu(h.float()).to(x.dtype)
    h = shard(h, "ffn_hidden")
    return shard(einsum("...f,fd->...d", h, params["wo"]), "residual")


# ---------------------------------------------------------------- embedding
def init_embed(key: InitKey, cfg: ModelConfig) -> dict:
    p = {"tok": init_dense(key, (cfg.vocab, cfg.d_model), scale=1.0,
                           dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(key, (cfg.d_model, cfg.vocab),
                               dtype=cfg.dtype)
    return p


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    # F.embedding's gradient sorts the token ids and sums each id's rows
    # in one pass, the same order on every run (index_select's index_add_
    # and tok[tokens]'s index_put_ add repeated ids by atomics on CUDA)
    tok = params["tok"]
    if _is_dtensor(tok):
        return shard(_embed_sharded(tok, tokens), "embed")
    return shard(F.embedding(tokens.long(), tok), "embed")


def _embed_sharded(tok, tokens):
    """The vocab-parallel lookup of a DTensor table (Megatron's): each
    rank looks its batch rows' tokens up in its block of the vocabulary,
    zero where the token lies in another block, and the blocks' rows are
    summed over the mesh dimensions that split the vocabulary (the
    "embed" rule then reduces them). The table's other dimensions are
    gathered first (FSDP's gather), explicitly."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = tok.device_mesh
    bpl = _batch_placements(mesh, tokens.shape[0])
    vocab = [i for i, p in enumerate(tok.placements)
             if p.is_shard(0) and not bpl[i].is_shard(0)]
    tpl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    tokens = _rows_of(tokens, mesh, bpl)
    # a rank's table gradient sums its own batch rows: partial over the
    # data axes that split the batch
    table = tok.redistribute(mesh, tpl).to_local(grad_placements=[
        Partial() if bpl[i].is_shard(0) else p for i, p in enumerate(tpl)])
    n = table.shape[0]
    rel = tokens.long() - _block(mesh, vocab) * n
    hit = ((rel >= 0) & (rel < n))[..., None]
    rows = torch.where(hit, F.embedding(rel.clamp(0, n - 1), table),
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return _sum_over(rows, mesh, vocab, bpl)


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["head"]
    logits = einsum("...d,dv->...v", x, w)
    return shard(logits, "logits")


# ---------------------------------------------------------------- weights
def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: its bits
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's tree from the reference's (parameters, caches or decode
    states as numpy arrays, or anything ``np.asarray`` takes): the same
    keys, lists and stacked leaves, each leaf's dtype kept."""
    dev = resolve_device(device)
    return _tree.tree_map(lambda a: _leaf_from_numpy(a, dev), tree)
