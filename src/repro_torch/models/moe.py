"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The counterpart of ``repro.models.moe``. The dispatch is built on the
IMA-GNN aggregation dataflow: token->expert routing is a sparse
gather-reduce like neighbor aggregation -- the router's top-k plays the
traversal core's edge list, the expert buffers are the "clusters", and the
weighted combine is the aggregation core's reduction.

Dispatch algorithm (fixed shapes), per token group (a batch row):
  1. router logits -> top-k expert ids + gates per token (``torch.topk``,
     sorted, the reference's ``jax.lax.top_k``),
  2. stable-sort token-slots by expert id,
  3. rank-within-expert via sorted-position - expert-start (capacity drop),
  4. gather tokens into [E, C, D]; batched expert matmul; weighted combine.
Gathers are ``index_select`` and counts ``index_add_`` of ones:
on CUDA an accumulating ``index_put_`` adds repeated indices one after
another.
"""
from __future__ import annotations

import torch

from .common import (InitKey, batch_local, einsum, init_dense, shard,
                     swiglu, whole)
from .config import ModelConfig


def init_moe(key: InitKey, cfg: ModelConfig) -> dict:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
    p = {"router": init_dense(key, (d, e), dtype="float32"),
         "wi": init_dense(key, (e, d, 2 * f), dtype=cfg.dtype),
         "wo": init_dense(key, (e, f, d), dtype=cfg.dtype)}
    if mo.n_shared:
        fs = f * mo.n_shared
        p["shared_wi"] = init_dense(key, (d, 2 * fs), dtype=cfg.dtype)
        p["shared_wo"] = init_dense(key, (fs, d), dtype=cfg.dtype)
    return p


def _route(params, x2d, cfg: ModelConfig):
    """Router: returns (expert_ids [T, k], gates [T, k])."""
    mo = cfg.moe
    logits = x2d.float() @ params["router"].float()
    if mo.router == "sigmoid":           # deepseek-v3 style
        scores = torch.sigmoid(logits)
        gates, ids = torch.topk(scores, mo.top_k, dim=-1, sorted=True)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    else:                                # grok/softmax style
        gates, ids = torch.topk(torch.softmax(logits, dim=-1), mo.top_k,
                                dim=-1, sorted=True)
    return ids, gates


def _dispatch(x, ids, e: int, cap: int):
    """``_group_dispatch`` over a leading group axis. x: [G, S, D];
    ids: [G, S, k]. Returns (buf [G, E, cap, D], (flat_ids, rank, keep),
    each [G, S*k])."""
    g, s, d = x.shape
    k = ids.shape[-1]
    dev = x.device
    flat_ids = ids.reshape(g, s * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    experts = torch.arange(e, device=dev, dtype=flat_ids.dtype).expand(
        g, e).contiguous()
    starts = torch.searchsorted(sorted_ids, experts, right=False)
    ends = torch.searchsorted(sorted_ids, experts, right=True)
    # buf[g, e, c] = x[g, token of sorted slot starts[e] + c]
    pos = starts[:, :, None] + torch.arange(cap, device=dev)   # [G, E, C]
    valid = pos < ends[:, :, None]
    slot = torch.gather(order, 1, pos.clamp(0, s * k - 1).reshape(g, -1))
    token = slot // k + torch.arange(g, device=dev)[:, None] * s
    buf = torch.index_select(x.reshape(g * s, d), 0, token.reshape(-1))
    buf = torch.where(valid.reshape(g * e * cap, 1), buf,
                      torch.zeros((), dtype=x.dtype, device=dev))
    # combine maps: rank of every slot within its expert (inverse perm)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=dev).expand(g, s * k))
    rank = inv - torch.gather(starts, 1, flat_ids)
    keep = rank < cap
    return buf.reshape(g, e, cap, d), (flat_ids, rank, keep)


def _dispatch_flat(x, ids, e: int, cap: int):
    """``_dispatch`` as (buf, flat_ids, rank, keep)."""
    buf, maps = _dispatch(x, ids, e, cap)
    return (buf,) + maps


def _group_dispatch(x_g, ids_g, e: int, cap: int):
    """Sort-based dispatch WITHIN one token group. x_g: [S, D];
    ids_g: [S, k]. Returns (buf [E, cap, D], (flat_ids, rank, keep)).

    The buffer is a GATHER over the sort order (buf[e, c] = x[token of the
    c-th slot routed to e]); the combine needs no scatter either -- a
    token's k slots are contiguous in flat order, so it is a gather +
    reshape + sum."""
    buf, maps = _dispatch(x_g[None], ids_g[None], e, cap)
    return buf[0], tuple(m[0] for m in maps)


def _combine(y_buf, slot_e, rank, keep, gates, k: int):
    """Weighted combine back to tokens (gather + reshape-sum over k).
    y_buf: [G, E, C, D]; slot_e / rank / keep: [G, S*k]; gates [G*S, k].
    Returns [G*S, D] f32."""
    g, e, cap, d = y_buf.shape
    t = slot_e.shape[1] // k * g
    flat = (torch.arange(g, device=y_buf.device)[:, None] * e + slot_e) \
        * cap + rank.clamp(0, cap - 1)                   # [G, S*k]
    got = torch.index_select(y_buf.reshape(g * e * cap, d), 0,
                             flat.reshape(-1))           # [T*k, D]
    w = torch.where(keep.reshape(-1), gates.reshape(-1),
                    torch.zeros((), device=y_buf.device))
    got = got * w[:, None].to(got.dtype)                 # bf16 slot space
    return got.reshape(t, k, d).float().sum(dim=1)       # f32 k-reduce


def _balance(ids, gates, e: int):
    """Per-expert slot counts and summed top-1 gates (the load-balance
    terms' numerators) of ids / gates [T, k]."""
    flat = ids.reshape(-1)
    # bincount's length depends on the ids; a count of ones into [E] does
    # not (an abstract step runs it), and sums whole numbers exactly
    counts = torch.zeros((e,), dtype=torch.float32, device=ids.device
                         ).index_add(0, flat, torch.ones(
                             flat.shape, dtype=torch.float32,
                             device=ids.device))
    top1 = torch.zeros((e,), dtype=torch.float32, device=ids.device
                       ).index_add(0, ids[:, 0], gates[:, 0].float())
    return counts, top1


def moe_ffn(params, x, cfg: ModelConfig):
    """x: [B, S, D] -> [B, S, D]. Returns (out, aux) with load-balance
    stats. GShard-style grouped dispatch: each batch row is a dispatch
    group, the buffer [G, E, C, D]. On a mesh the dispatch, the combine
    and the counts run on each rank's block of the batch rows
    (``batch_local``); the expert compute between them is placed by the
    rules (EP or expert-inner TP)."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = mo.top_k
    e = mo.n_experts
    x2d = x.reshape(t, d)
    # the router on each rank's batch rows, its table whole there (an
    # FSDP-split router would leave the logits partial over 'data')
    ids, gates = batch_local(
        lambda xx, r: _route({"router": r}, xx.reshape(-1, d), cfg), x,
        whole(params["router"], b), batch=b)             # [T, k]

    cap = int(mo.capacity_factor * s * k / e) + 1        # per-group capacity
    buf, slot_e, rank, keep = batch_local(
        lambda xx, ii: _dispatch_flat(xx, ii, e, cap), x,
        ids.reshape(b, s, k), batch=b)
    buf = shard(buf, "expert_buf")                       # [G, E, C, D]

    # ---- expert compute (batched swiglu)
    h = einsum("gecd,edf->gecf", buf, params["wi"])
    h = swiglu(h, x.dtype)
    h = shard(h, "expert_hidden")
    y_buf = einsum("gecf,efd->gecd", h, params["wo"])
    y_buf = shard(y_buf, "expert_out")

    out = batch_local(lambda *a: _combine(*a, k), y_buf, slot_e, rank, keep,
                      gates, batch=b)
    out = out.to(x.dtype)
    keep_frac = keep.reshape(-1).float().mean()

    if mo.n_shared:
        hs = einsum("td,df->tf", x2d, params["shared_wi"])
        hs = swiglu(hs, x.dtype)
        out = out + einsum("tf,fd->td", hs, params["shared_wo"])

    # aux: load-balance loss terms (mean gate fraction x token fraction)
    counts, top1 = batch_local(lambda i, g: _balance(i, g, e), ids, gates,
                               batch=b, sums=2)
    me = counts / (t * k)
    pe = top1 / t
    aux = {"load_balance": e * torch.sum(me * pe),
           "dropped_frac": 1.0 - keep_frac}
    return shard(out.reshape(b, s, d), "residual"), aux
