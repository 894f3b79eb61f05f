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

import torch
from torch.utils.checkpoint import checkpoint

from .common import (InitKey, apply_rope, dtype_of, einsum, einsum_f32,
                     init_dense, init_full, rms_norm, shard)
from .config import ModelConfig

NEG_INF = -1e30


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
    """
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


# ------------------------------------------------------------ GQA
def init_gqa(key: InitKey, cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"wq": init_dense(key, (d, h * dh), dtype=cfg.dtype),
            "wk": init_dense(key, (d, kv * dh), dtype=cfg.dtype),
            "wv": init_dense(key, (d, kv * dh), dtype=cfg.dtype),
            "wo": init_dense(key, (h * dh, d), dtype=cfg.dtype)}


def init_gqa_cache(cfg: ModelConfig, batch: int, capacity: int,
                   window: int, device="cpu") -> dict:
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
        cache[name].index_copy_(1, slots, new.to(cache[name].dtype))
    cache["pos"].index_copy_(1, slots, pos.to(torch.int32))
    cache["idx"].add_(s)
    return cache["pos"]


def gqa_attention(params, x, pos, cfg: ModelConfig, *, window: int,
                  cache: dict | None = None, mrope_pos=None):
    """x: [B, S, D]. Prefill/train when cache is None (returns out only);
    decode when cache is given (S == 1; returns out, the cache updated in
    place)."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = einsum("bsd,de->bse", x, params["wq"]).reshape(b, s, h, dh)
    k = einsum("bsd,de->bse", x, params["wk"]).reshape(b, s, kv, dh)
    v = einsum("bsd,de->bse", x, params["wv"]).reshape(b, s, kv, dh)
    rp = mrope_pos if mrope_pos is not None else pos
    q = apply_rope(q, rp, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, rp, cfg.rope_theta, cfg.mrope_sections)
    q = shard(q, "heads")

    if cache is None:
        out = chunked_attention(q, k, v, pos, pos, causal=True,
                                window=window, chunk=cfg.attn_chunk,
                                canonical=True)
    else:
        cpos = _write_slots(cache, ("k", "v"), (k, v), pos)
        valid = cpos >= 0
        if window:
            valid = valid & (pos[:, :1] - cpos < window)
        g = h // kv
        qg = q.reshape(b, s, kv, g, dh).float()
        s_ = torch.einsum("bqkgd,bckd->bqkgc", qg,
                          cache["k"].float()) * (dh ** -0.5)
        s_ = torch.where(valid[:, None, None, None, :], s_, NEG_INF)
        p = torch.softmax(s_, dim=-1)
        out = torch.einsum("bqkgc,bckd->bqkgd", p, cache["v"].float())
        out = out.reshape(b, s, h, dh).to(x.dtype)

    y = einsum("bse,ed->bsd", out.reshape(b, s, h * dh), params["wo"])
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
                   device="cpu") -> dict:
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
    q = einsum("bsr,re->bse", cq, params["wuq"]).reshape(
        b, s, h, m.nope_dim + m.rope_dim)
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
        kvu = einsum("bsr,re->bse",
                     rms_norm(ckv_new, params["kv_norm"], cfg.norm_eps),
                     params["wukv"]).reshape(b, s, h, m.nope_dim + m.v_dim)
        k_nope, v = kvu[..., :m.nope_dim], kvu[..., m.nope_dim:]
        k = torch.cat([k_nope, kpe_new[:, :, None, :].expand(
            b, s, h, m.rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        out = chunked_attention(q, k, v, pos, pos, causal=True, window=0,
                                chunk=cfg.attn_chunk, canonical=True)
        y = einsum("bse,ed->bsd", out.reshape(b, s, h * m.v_dim),
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
    wukv = params["wukv"].reshape(m.kv_lora, h, m.nope_dim + m.v_dim)
    w_uk, w_uv = wukv[..., :m.nope_dim], wukv[..., m.nope_dim:]
    # absorb: q_lat[b,s,h,r] = q_nope . w_uk^T
    q_lat = einsum_f32("bshn,rhn->bshr", q_nope, w_uk)
    scores = einsum_f32("bshr,bcr->bshc", q_lat.to(dt), ckv) \
        + einsum_f32("bshp,bcp->bshc", q_pe.to(dt), kpe)
    scores = scores * ((m.nope_dim + m.rope_dim) ** -0.5)
    scores = torch.where((cpos >= 0)[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out_lat = einsum_f32("bshc,bcr->bshr", p.to(dt), ckv)
    out = einsum_f32("bshr,rhv->bshv", out_lat.to(dt), w_uv)
    y = einsum("bse,ed->bsd", out.reshape(b, s, h * m.v_dim).to(dt),
               params["wo"])
    return shard(y, "residual"), cache


# ------------------------------------------------------------ cross-attn
def init_cross(key: InitKey, cfg: ModelConfig) -> dict:
    return init_gqa(key, cfg)


def cross_attention(params, x, enc_kv, cfg: ModelConfig):
    """x: [B, S, D] decoder; enc_kv: (k, v) each [B, T, KV, Dh]
    precomputed."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = einsum("bsd,de->bse", x, params["wq"]).reshape(b, s, h, dh)
    k, v = enc_kv
    t = k.shape[1]
    pos_q = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    out = chunked_attention(q, k, v, pos_q, pos_k, causal=False, window=0,
                            chunk=cfg.attn_chunk, canonical=True)
    return einsum("bse,ed->bsd", out.reshape(b, s, h * dh), params["wo"])


def encode_cross_kv(params, enc_out, cfg: ModelConfig):
    b, t, d = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.dh
    k = einsum("btd,de->bte", enc_out, params["wk"]).reshape(b, t, kv, dh)
    v = einsum("btd,de->bte", enc_out, params["wv"]).reshape(b, t, kv, dh)
    return k, v
