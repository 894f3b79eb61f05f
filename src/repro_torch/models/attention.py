"""Attention mixers: GQA (full / sliding-window / M-RoPE) and MLA
(DeepSeek/MiniCPM3 multi-head latent attention), with memory-bounded chunked
prefill (online softmax over KV chunks) and single-token decode against
KV caches (ring-buffered for sliding windows, latent-compressed for MLA).

The counterpart of ``repro.models.attention``: f32 scores, the same online
softmax, ``NEG_INF`` masks and padding to whole chunks. The KV step is
recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``). Decode writes its slot of the cache in
place (``index_copy_`` at ``idx % capacity``, the reference's
``dynamic_update_slice``) and returns the caches it was given.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels.attention import HEAD_DIM, flash_attention
from .common import (InitKey, _block, _gather_dim, _is_dtensor, _rows_of,
                     _sum_over, apply_rope, dtype_of, einsum, einsum_f32,
                     init_dense, init_full, merge_heads, rms_norm, shard,
                     split_heads)
from .config import ModelConfig

NEG_INF = -1e30
_PATHS = {"kernel": 0, "composed": 0}


# ------------------------------------------------------------ chunked core
def _kv_step(m, l, acc, q_i, k_j, v_j, mask, scale):
    """One online-softmax step of a query chunk against a KV chunk."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q_i.float(), k_j.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bqkgc,bckd->bqkgd", p, v_j.float())
    return m_new, l_new, acc_new


def _pad(x: torch.Tensor, dim: int, n: int, value=0) -> torch.Tensor:
    if not n:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def kernel_takes(q, k, v, *, causal: bool, window: int, k_valid,
                 canonical: bool) -> bool:
    """Whether the flash-attention kernels compute this
    ``chunked_attention`` call: bf16 q [B, Sq, H, 128], k, v [B, Sk, KV,
    128] with H a multiple of KV, causal, positions arange
    (``canonical``), no key validity mask, and a window of 0 (none) or
    more. The device is the caller's to check."""
    ts = (q, k, v)
    return (causal and canonical and k_valid is None and window >= 0
            and all(t.dtype == torch.bfloat16 and t.dim() == 4 for t in ts)
            and q.shape[-1] == k.shape[-1] == v.shape[-1] == HEAD_DIM
            and k.shape == v.shape and q.shape[0] == k.shape[0]
            and q.shape[2] % k.shape[2] == 0)


def attention_paths() -> dict:
    """``{"kernel": n, "composed": n}``: calls of ``chunked_attention`` on
    CUDA tensors since the last reset, by the path they took."""
    return dict(_PATHS)


def reset_attention_paths() -> None:
    for key in _PATHS:
        _PATHS[key] = 0


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                      chunk: int, k_valid=None, canonical: bool = False):
    """Online-softmax attention, O(S * chunk) memory.

    q: [B, Sq, H, Dk]; k: [B, Sk, KV, Dk]; v: [B, Sk, KV, Dv]
    q_pos/k_pos: [B, Sq] / [B, Sk] absolute positions for masking.
    KV grouping (GQA) handled by reshaping H = KV * G.
    Returns [B, Sq, H, Dv] (f32 accumulated, cast back to q.dtype).

    ``canonical``: positions are known to be arange(Sq)/arange(Sk) (train /
    prefill). Masks are then derived from the chunk indices, and a chunk
    pair the mask hides entirely (past the diagonal, or wholly outside the
    window) is skipped: after a row's first live chunk such a step changes
    nothing (its probabilities are 0 and its correction 1), and before it
    the next live chunk's correction, 0, erases it.

    On CUDA tensors, a call that ``kernel_takes`` (bf16, head width 128,
    causal, canonical, no ``k_valid``) runs the hand-written
    flash-attention kernels (``kernels.attention``) instead: the same
    float32 scores and products, one launch forward and two backward,
    ``chunk`` unused. ``attention_paths()`` counts the calls on CUDA
    tensors by the path taken.
    """
    if _is_dtensor(q):
        return _local_heads(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, chunk=chunk, k_valid=k_valid,
                            canonical=canonical)
    if q.is_cuda:
        if kernel_takes(q, k, v, causal=causal, window=window,
                        k_valid=k_valid, canonical=canonical):
            _PATHS["kernel"] += 1
            return flash_attention(q, k, v, window=window)
        _PATHS["composed"] += 1
    b, sq, h, dk = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    scale = dk ** -0.5
    dev = q.device

    cq = min(chunk, sq)
    ck = min(chunk, sk)
    pad_q = (-sq) % cq
    pad_k = (-sk) % ck
    q = _pad(q, 1, pad_q)
    q_pos = _pad(q_pos, 1, pad_q)
    k = _pad(k, 1, pad_k)
    v = _pad(v, 1, pad_k)
    k_pos = _pad(k_pos, 1, pad_k, -1)
    if k_valid is not None:
        k_valid = _pad(k_valid, 1, pad_k, False)
    else:
        k_valid = k_pos >= 0
    nq, nk = (sq + pad_q) // cq, (sk + pad_k) // ck

    qc = q.reshape(b, nq, cq, kv, g, dk)
    kc = k.reshape(b, nk, ck, kv, dk)
    vc = v.reshape(b, nk, ck, kv, dv)
    iq = torch.arange(cq, device=dev)
    ik = torch.arange(ck, device=dev)
    qp = q_pos.reshape(b, nq, cq)
    kp = k_pos.reshape(b, nk, ck)
    kval = k_valid.reshape(b, nk, ck)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    outs = []
    for i in range(nq):
        q_i = qc[:, i]
        m = torch.full((b, cq, kv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, cq, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, cq, kv, g, dv), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            if canonical:
                if causal and (j * ck > i * cq + cq - 1 or (
                        window and i * cq - (j * ck + ck - 1) >= window)):
                    continue
                qpos = i * cq + iq                           # [cq]
                kpos = j * ck + ik                           # [ck]
                mask = (kpos < sk)[None, :]                  # [1, ck]
                if causal:
                    rel = qpos[:, None] - kpos[None, :]      # [cq, ck]
                    mask = mask & (rel >= 0)
                    if window:
                        mask = mask & (rel < window)
                mask = mask[None, :, None, None, :]          # [1,cq,1,1,ck]
            else:
                mask = kval[:, j][:, None, None, None, :]
                if causal:
                    rel = qp[:, i][:, :, None, None, None] \
                        - kp[:, j][:, None, None, None, :]
                    mask = mask & (rel >= 0)
                    if window:
                        mask = mask & (rel < window)
            args = (m, l, acc, q_i, kc[:, j], vc[:, j], mask, scale)
            if remat:
                # recompute scores/probs per chunk pair in the backward
                # pass instead of saving the O(Sq*Sk) probability tensor
                m, l, acc = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                m, l, acc = _kv_step(*args)
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=1).reshape(b, nq * cq, h, dv)
    return out[:, :sq].to(q.dtype)


def _local_heads(q, k, v, q_pos, k_pos, **kw):
    """``chunked_attention`` of DTensor q, k, v on each rank's block: every
    (batch row, head) attends on its own, so q, k and v are placed alike,
    split over the batch and the heads as q is and whole elsewhere, and
    each rank runs the attention on its local blocks (one op a step, not
    a DTensor dispatch a step: DTensor cannot flatten the batch and head
    splits einsum merges)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    pl = tuple(p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
               for p in q.placements)
    bpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    q, k, v = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
    q_pos, k_pos = (_rows_of(t, mesh, bpl) for t in (q_pos, k_pos))
    if kw.get("k_valid") is not None:
        kw["k_valid"] = _rows_of(kw["k_valid"], mesh, bpl)
    out = chunked_attention(q, k, v, q_pos, k_pos, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _cache_attention(local_fn, qs, caches, valid, q_heads=None,
                     cache_heads=None):
    """Decode attention against DTensor caches, on each rank's blocks:
    flash-decoding over the slots a rank holds, then one combine across
    the ranks that split the slots. ``qs`` are the query-side tensors
    (batch on dim 0, heads on ``q_heads``), ``caches`` the cache tensors
    (batch on dim 0, slots on dim 1, heads on ``cache_heads``), ``valid``
    [B, C]. ``local_fn(qs, caches, valid)`` returns (max, sum of
    exponentials, weighted values) over the local slots. Returns the
    attention output as a DTensor placed as the queries."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    c0 = caches[0]
    mesh = c0.device_mesh
    cpl = tuple(c0.placements)
    batch = [p.is_shard(0) for p in cpl]
    slots = [p.is_shard(1) for p in cpl]
    heads = [cache_heads is not None and p.is_shard(cache_heads)
             for p in cpl]
    qpl = tuple(Shard(0) if b else Shard(q_heads) if h else Replicate()
                for b, h in zip(batch, heads))
    kpl = tuple(Shard(0) if b else Shard(1) if s else Shard(cache_heads)
                if h else Replicate() for b, s, h in zip(batch, slots, heads))
    vpl = tuple(Shard(0) if b else Shard(1) if s else Replicate()
                for b, s in zip(batch, slots))
    m, l, acc = local_fn(
        [t.redistribute(mesh, qpl).to_local() for t in qs],
        [t.redistribute(mesh, kpl).to_local() for t in caches],
        _rows_of(valid, mesh, vpl))
    if not any(slots):
        out = acc / l[..., None]
        return DTensor.from_local(out, mesh, qpl, run_check=False)
    # combine: the slot ranks' partial softmaxes rescaled to the global
    # max, then summed (stacked on a leading dimension the slot ranks
    # split)
    over = [i for i, s in enumerate(slots) if s]
    stk = tuple(Shard(0) if s else Shard(p.dim + 1) if p.is_shard()
                else Replicate() for s, p in zip(slots, qpl))
    gmax = DTensor.from_local(m[None], mesh, stk, run_check=False).amax(0)
    gmax = gmax.redistribute(mesh, qpl).to_local()
    w = torch.exp(m - gmax)
    tot = _sum_over(l * w, mesh, over, qpl).redistribute(mesh, qpl)
    val = _sum_over(acc * w[..., None], mesh, over, qpl).redistribute(
        mesh, qpl)
    return val / tot[..., None]


def _kv_for_heads(q, k, v):
    """Under tensor parallelism wider than the KV heads (a DTensor ``q``
    whose heads are split over more shards than divide ``k``'s), every
    rank needs the KV heads of its query heads: ``k`` and ``v`` repeated
    to ``q``'s head count (Megatron's KV replication) and placed on the
    heads as ``q`` is. Otherwise as they are."""
    if not _is_dtensor(q):
        return k, v
    h, kv = q.shape[2], k.shape[2]
    on = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    if kv % math.prod(q.device_mesh.size(i) for i in on) == 0:
        return k, v
    from torch.distributed.tensor import Shard

    def rep(t):
        t = _gather_dim(t, 2, 1)                 # all KV heads on a rank
        t = t[:, :, :, None, :].expand(t.shape[0], t.shape[1], kv, h // kv,
                                       t.shape[-1])
        t = t.reshape(t.shape[0], t.shape[1], h, t.shape[-1])
        return t.redistribute(t.device_mesh, [
            Shard(2) if i in on else p for i, p in enumerate(t.placements)])

    return rep(k), rep(v)


# ------------------------------------------------------------ GQA
def init_gqa(key: InitKey, cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"wq": init_dense(key, (d, h * dh), dtype=cfg.dtype),
            "wk": init_dense(key, (d, kv * dh), dtype=cfg.dtype),
            "wv": init_dense(key, (d, kv * dh), dtype=cfg.dtype),
            "wo": init_dense(key, (h * dh, d), dtype=cfg.dtype)}


def init_gqa_cache(cfg: ModelConfig, batch: int, capacity: int,
                   window: int, device="cuda") -> dict:
    device = resolve_device(device)
    cap = min(capacity, window) if window else capacity
    kv, dh = cfg.n_kv_heads, cfg.dh
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros((batch, cap, kv, dh), dtype=dt, device=device),
            "v": torch.zeros((batch, cap, kv, dh), dtype=dt, device=device),
            "pos": torch.full((batch, cap), -1, dtype=torch.int32,
                              device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def _write_slots(cache: dict, names, news, pos) -> torch.Tensor:
    """Write ``news`` (each [B, s, ...]) and ``pos`` into the ring slots
    from ``idx % capacity`` on (clamped so s slots fit, as
    ``dynamic_update_slice`` clamps), in place; advance ``idx``. Returns
    the written ``pos`` cache."""
    buf = cache[names[0]]
    cap, s = buf.shape[1], news[0].shape[1]
    slot = torch.clamp_max(cache["idx"].long() % cap, cap - s)
    slots = slot + torch.arange(s, device=buf.device)
    for name, new in zip(names, news):
        _copy_slots(cache[name], slots, new.to(cache[name].dtype))
    _copy_slots(cache["pos"], slots, pos.to(torch.int32))
    cache["idx"].add_(s)
    return cache["pos"]


def _copy_slots(buf, slots, new) -> None:
    """``buf.index_copy_(1, slots, new)``. A DTensor cache is written on
    each rank's block (DTensor has no ``index_copy_`` strategy in every
    release): ``new`` is placed as the cache is, whole over the slots;
    where the cache is split over its slots (the flash-decoding layout of
    ``cache_shardings``), the rank that holds the slot writes it and the
    others write back what they hold (one slot a step: decode)."""
    if not _is_dtensor(buf):
        buf.index_copy_(1, slots, new)
        return
    from torch.distributed.tensor import DTensor, Replicate

    mesh = buf.device_mesh
    if not _is_dtensor(new):      # every rank holds it whole (positions)
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in buf.placements]).to_local()
    local = buf.to_local()
    slots = slots.full_tensor() if _is_dtensor(slots) else slots
    if not any(p.is_shard(1) for p in buf.placements):
        local.index_copy_(1, slots, new)
        return
    if slots.shape[0] != 1:
        raise ValueError(f"a cache split over its slots takes one slot a "
                         f"step, not {slots.shape[0]}")
    n = local.shape[1]
    rel = slots - _block(mesh, [i for i, p in enumerate(buf.placements)
                                if p.is_shard(1)]) * n
    owned = ((rel >= 0) & (rel < n)).reshape((1, -1) + (1,) * (
        local.dim() - 2))
    rel = rel.clamp(0, n - 1)
    local.index_copy_(1, rel, torch.where(owned, new,
                                          local.index_select(1, rel)))


def _gqa_flash(qg, k, v, valid, scale):
    """(max, sum of exponentials, weighted values) of GQA decode scores
    over the slots held: qg [B, 1, KV, G, Dh] f32, k/v [B, C, KV, Dh]."""
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float()) * scale
    ok = valid[:, None, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    return m, e.sum(-1), torch.einsum("bqkgc,bckd->bqkgd", e, v.float())


def gqa_attention(params, x, pos, cfg: ModelConfig, *, window: int,
                  cache: dict | None = None, mrope_pos=None):
    """x: [B, S, D]. Prefill/train when cache is None (returns out only);
    decode when cache is given (S == 1; returns out, the cache updated in
    place)."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = split_heads(einsum("bsd,de->bse", x, params["wq"]), h, dh)
    k = split_heads(einsum("bsd,de->bse", x, params["wk"]), kv, dh)
    v = split_heads(einsum("bsd,de->bse", x, params["wv"]), kv, dh)
    rp = mrope_pos if mrope_pos is not None else pos
    q = apply_rope(q, rp, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, rp, cfg.rope_theta, cfg.mrope_sections)
    q = shard(q, "heads")

    if cache is None:
        k, v = _kv_for_heads(q, k, v)
        out = chunked_attention(q, k, v, pos, pos, causal=True,
                                window=window, chunk=cfg.attn_chunk,
                                canonical=True)
    else:
        cpos = _write_slots(cache, ("k", "v"), (k, v), pos)
        valid = cpos >= 0
        if window:
            valid = valid & (pos[:, :1] - cpos < window)
        g = h // kv
        qg = _gather_dim(q, 2, kv).reshape(b, s, kv, g, dh).float()
        if _is_dtensor(cache["k"]):
            out = _cache_attention(
                lambda qs, cs, va: _gqa_flash(qs[0], cs[0], cs[1], va,
                                              dh ** -0.5),
                [qg], [cache["k"], cache["v"]], valid, q_heads=2,
                cache_heads=2)
        else:
            s_ = torch.einsum("bqkgd,bckd->bqkgc", qg,
                              cache["k"].float()) * (dh ** -0.5)
            s_ = torch.where(valid[:, None, None, None, :], s_, NEG_INF)
            p = torch.softmax(s_, dim=-1)
            out = torch.einsum("bqkgc,bckd->bqkgd", p, cache["v"].float())
        out = out.reshape(b, s, h, dh).to(x.dtype)

    y = einsum("bse,ed->bsd", merge_heads(out), params["wo"])
    y = shard(y, "residual")
    return (y, cache) if cache is not None else y


# ------------------------------------------------------------ MLA
def init_mla(key: InitKey, cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    p = {"wdkv": init_dense(key, (d, m.kv_lora + m.rope_dim),
                            dtype=cfg.dtype),
         "kv_norm": init_full(key, (m.kv_lora,), 0.0),
         "wukv": init_dense(key, (m.kv_lora, h * (m.nope_dim + m.v_dim)),
                            dtype=cfg.dtype),
         "wo": init_dense(key, (h * m.v_dim, d), dtype=cfg.dtype)}
    if m.q_lora:
        p["wdq"] = init_dense(key, (d, m.q_lora), dtype=cfg.dtype)
        p["q_norm"] = init_full(key, (m.q_lora,), 0.0)
        p["wuq"] = init_dense(key, (m.q_lora,
                                    h * (m.nope_dim + m.rope_dim)),
                              dtype=cfg.dtype)
    else:
        p["wuq"] = init_dense(key, (d, h * (m.nope_dim + m.rope_dim)),
                              dtype=cfg.dtype)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int,
                   device="cuda") -> dict:
    device = resolve_device(device)
    m = cfg.mla
    dt = dtype_of(cfg.dtype)
    return {"ckv": torch.zeros((batch, capacity, m.kv_lora), dtype=dt,
                               device=device),
            "kpe": torch.zeros((batch, capacity, m.rope_dim), dtype=dt,
                               device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def _mla_q(params, x, pos, cfg):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if m.q_lora:
        cq = rms_norm(einsum("bsd,dr->bsr", x, params["wdq"]),
                      params["q_norm"], cfg.norm_eps)
    else:
        cq = x
    q = split_heads(einsum("bsr,re->bse", cq, params["wuq"]), h,
                    m.nope_dim + m.rope_dim)
    q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(params, x, pos, cfg: ModelConfig,
                  cache: dict | None = None):
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.n_heads
    q_nope, q_pe = _mla_q(params, x, pos, cfg)
    dkv = einsum("bsd,dr->bsr", x, params["wdkv"])
    ckv_new, kpe_new = dkv[..., :m.kv_lora], dkv[..., m.kv_lora:]
    kpe_new = apply_rope(kpe_new[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    if cache is None:
        # prefill: reconstruct per-head keys/values from the latent
        kvu = split_heads(einsum(
            "bsr,re->bse", rms_norm(ckv_new, params["kv_norm"],
                                    cfg.norm_eps), params["wukv"]),
            h, m.nope_dim + m.v_dim)
        k_nope, v = kvu[..., :m.nope_dim], kvu[..., m.nope_dim:]
        k = torch.cat([k_nope, kpe_new[:, :, None, :].expand(
            b, s, h, m.rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        out = chunked_attention(q, k, v, pos, pos, causal=True, window=0,
                                chunk=cfg.attn_chunk, canonical=True)
        y = einsum("bse,ed->bsd", merge_heads(out),
                   params["wo"])
        return shard(y, "residual")

    # decode: absorbed attention in latent space (cache = latent + rope
    # key). The cache stores the POST-kv_norm latent (rms_norm is
    # per-position, so normalizing once at insertion is exact). Score and
    # value dots take bf16 operands with f32 sums, as the reference's
    # preferred_element_type=float32.
    dt = x.dtype
    ckv_new_n = rms_norm(ckv_new, params["kv_norm"], cfg.norm_eps)
    cpos = _write_slots(cache, ("ckv", "kpe"), (ckv_new_n, kpe_new), pos)
    ckv, kpe = cache["ckv"], cache["kpe"]
    wukv = split_heads(params["wukv"], h, m.nope_dim + m.v_dim)
    w_uk, w_uv = wukv[..., :m.nope_dim], wukv[..., m.nope_dim:]
    # absorb: q_lat[b,s,h,r] = q_nope . w_uk^T
    q_lat = einsum_f32("bshn,rhn->bshr", q_nope, w_uk)
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    if _is_dtensor(ckv):
        out_lat = _cache_attention(
            lambda qs, cs, va: _mla_flash(*qs, *cs, va, scale, dt),
            [q_lat.to(dt), q_pe.to(dt)], [ckv, kpe], cpos >= 0)
    else:
        scores = einsum_f32("bshr,bcr->bshc", q_lat.to(dt), ckv) \
            + einsum_f32("bshp,bcp->bshc", q_pe.to(dt), kpe)
        scores = scores * scale
        scores = torch.where((cpos >= 0)[:, None, None, :], scores,
                             NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out_lat = einsum_f32("bshc,bcr->bshr", p.to(dt), ckv)
    out = einsum_f32("bshr,rhv->bshv", out_lat.to(dt), w_uv)
    y = einsum("bse,ed->bsd", merge_heads(out).to(dt),
               params["wo"])
    return shard(y, "residual"), cache


def _mla_flash(q_lat, q_pe, ckv, kpe, valid, scale, dt):
    """(max, sum of exponentials, weighted latents) of MLA's absorbed
    decode scores over the slots held: q_lat [B, 1, H, R], q_pe
    [B, 1, H, P], ckv [B, C, R], kpe [B, C, P]."""
    s = (einsum_f32("bshr,bcr->bshc", q_lat, ckv)
         + einsum_f32("bshp,bcp->bshc", q_pe, kpe)) * scale
    ok = valid[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    mx = s.amax(dim=-1)
    e = torch.where(ok, torch.exp(s - mx[..., None]), 0.0)
    return mx, e.sum(-1), einsum_f32("bshc,bcr->bshr", e.to(dt), ckv)


# ------------------------------------------------------------ cross-attn
def init_cross(key: InitKey, cfg: ModelConfig) -> dict:
    return init_gqa(key, cfg)


def cross_attention(params, x, enc_kv, cfg: ModelConfig):
    """x: [B, S, D] decoder; enc_kv: (k, v) each [B, T, KV, Dh]
    precomputed."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = split_heads(einsum("bsd,de->bse", x, params["wq"]), h, dh)
    k, v = _kv_for_heads(q, *enc_kv)
    t = k.shape[1]
    pos_q = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    out = chunked_attention(q, k, v, pos_q, pos_k, causal=False, window=0,
                            chunk=cfg.attn_chunk, canonical=True)
    return shard(einsum("bse,ed->bsd", merge_heads(out),
                        params["wo"]), "residual")


def encode_cross_kv(params, enc_out, cfg: ModelConfig):
    b, t, d = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.dh
    k = split_heads(einsum("btd,de->bte", enc_out, params["wk"]), kv, dh)
    v = split_heads(einsum("btd,de->bte", enc_out, params["wv"]), kv, dh)
    return k, v
