"""Unified decoder substrate: every assigned architecture is an instance.

The counterpart of ``repro.models.transformer``. Layer stack = [prelude] +
cycles of cfg.pattern + [tail]:
  * prelude -- leading dense-FFN layers (deepseek-v3's first 3),
  * cycles  -- the repeated pattern, its parameters (and decode caches)
    stacked on a leading axis as the reference's ``jax.vmap`` init stacks
    them, looped over (the reference scans them); a checkpoint therefore
    crosses between the packages leaf for leaf,
  * tail    -- remainder when n_layers % len(pattern) != 0.

Pre-norm residual blocks; mixer dispatch by pattern entry ('attn' | 'local' |
'rglru' | 'rwkv'); FFN = dense SwiGLU/GELU, MoE, or RWKV channel-mix.
Encoder-decoder (whisper) adds a bidirectional encoder + per-layer
cross-attention. Decode carries per-layer caches (KV / latent / recurrent
state), updated in place and returned. Cross-entropy is chunked over the
sequence (and each chunk recomputed in the backward pass) so the [B, S, V]
f32 logits tensor is never materialized.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .. import _tree
from .. import telemetry as tel
from .._device import resolve_device
from . import attention as attn
from . import moe as moe_lib
from . import recurrent as rec
from .common import (InitKey, _block, _rows_of, _sum_over, batch_local,
                     einsum, embed, ffn, init_dense, init_embed,
                     init_ffn, init_full, layer_norm, merge_heads, rms_norm,
                     settle, shard, split_heads, trace_backward, unembed)
from .config import ModelConfig


# ================================================================ layers
def _layer_kinds(cfg: ModelConfig):
    """(prelude_kinds, cycle_pattern, n_cycles, tail_kinds)."""
    n_prelude = cfg.moe.n_dense_layers if cfg.moe else 0
    prelude = tuple(cfg.pattern[i % len(cfg.pattern)]
                    for i in range(n_prelude))
    rest = cfg.n_layers - n_prelude
    if cfg.is_encdec or not cfg.scan_layers:
        # enc-dec (whisper, 6 layers) unrolls: per-layer cross-KV wiring
        return prelude, cfg.pattern, 0, tuple(
            cfg.pattern[i % len(cfg.pattern)] for i in range(rest))
    n_cycles = rest // len(cfg.pattern)
    tail = tuple(cfg.pattern[i % len(cfg.pattern)]
                 for i in range(rest - n_cycles * len(cfg.pattern)))
    return prelude, cfg.pattern, n_cycles, tail


def _init_mixer(key, kind: str, cfg: ModelConfig) -> dict:
    if kind in ("attn", "local"):
        return attn.init_mla(key, cfg) if cfg.mla else attn.init_gqa(key, cfg)
    if kind == "rglru":
        return rec.init_rglru(key, cfg)
    if kind == "rwkv":
        return rec.init_rwkv(key, cfg)
    raise ValueError(kind)


def _init_block(key, kind: str, cfg: ModelConfig, use_moe: bool) -> dict:
    d = cfg.d_model
    if cfg.rwkv_block == "finch":
        # LayerNorms: weight 1, bias 0
        p = {"ln1": init_full(key, (d,), 1.0),
             "ln1_b": init_full(key, (d,), 0.0),
             "ln2": init_full(key, (d,), 1.0),
             "ln2_b": init_full(key, (d,), 0.0)}
    else:
        # RMS norms: the scale an offset from 1
        p = {"ln1": init_full(key, (d,), 0.0),
             "ln2": init_full(key, (d,), 0.0)}
    p["mixer"] = _init_mixer(key, kind, cfg)
    if kind == "rwkv":
        p["ffn"] = rec.init_rwkv_channel(key, cfg)
    elif use_moe:
        p["ffn"] = moe_lib.init_moe(key, cfg)
    else:
        d_ff = (cfg.moe.d_ff_dense or cfg.d_ff) if (
            cfg.moe and cfg.moe.n_dense_layers) else cfg.d_ff
        p["ffn"] = init_ffn(key, cfg, d_ff)
    if cfg.is_encdec:
        p["ln_x"] = init_full(key, (d,), 0.0)
        p["cross"] = attn.init_cross(key, cfg)
    return p


def _init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                device):
    if kind == "attn":
        if cfg.mla:
            return attn.init_mla_cache(cfg, batch, capacity, device)
        return attn.init_gqa_cache(cfg, batch, capacity, cfg.window, device)
    if kind == "local":
        return attn.init_gqa_cache(cfg, batch, capacity, cfg.local_window,
                                   device)
    if kind == "rglru":
        return rec.init_rglru_state(cfg, batch, device)
    if kind == "rwkv":
        st = rec.init_rwkv_state(cfg, batch, device)
        st["chan_prev"] = torch.zeros((batch, cfg.d_model),
                                      dtype=torch.float32, device=device)
        return st
    raise ValueError(kind)


def _mixer(params, h, pos, kind: str, cfg: ModelConfig, cache, mrope_pos):
    """The block's token mixer on the normed input ``h``: (its output, the
    new cache or None)."""
    new_cache = None
    if kind in ("attn", "local"):
        window = cfg.window if kind == "attn" else cfg.local_window
        if cfg.mla:
            r = attn.mla_attention(params, h, pos, cfg, cache=cache)
        else:
            r = attn.gqa_attention(params, h, pos, cfg, window=window,
                                   cache=cache, mrope_pos=mrope_pos)
        if cache is not None:
            r, new_cache = r
    elif kind == "rglru":
        r = rec.rglru_mixer(params, h, cfg, state=cache)
        if cache is not None:
            r, new_cache = r
    else:  # rwkv
        if cache is not None:
            r, st = rec.rwkv_mixer(params, h, cfg,
                                   state={"s": cache["s"],
                                          "x_prev": cache["x_prev"]})
            new_cache = dict(cache, **st)
        else:
            r = rec.rwkv_mixer(params, h, cfg)
    return r, new_cache


def _traced_mixer(params, h, pos, kind: str, cfg: ModelConfig, cache,
                  mrope_pos):
    """``_mixer`` inside a ``model.mixer`` span (attr ``kind``: the block
    kind, ``mla`` for latent attention). Under autograd its backward is a
    ``model.mixer.backward`` interval on the thread that runs it: from the
    gradient of the mixer's output arriving to the gradient of ``h``,
    which only the mixer reads, being complete."""
    label = "mla" if cfg.mla and kind in ("attn", "local") else kind
    with tel.span("model.mixer", kind=label):
        r, new_cache = _mixer(params, h, pos, kind, cfg, cache, mrope_pos)
    trace_backward("model.mixer.backward", r, h, kind=label)
    return r, new_cache


def _block_norm(params, name: str, x, cfg: ModelConfig):
    """The block's norm ``name`` of ``x``: LayerNorm with bias in the Finch
    block, else the RMS norm."""
    if cfg.rwkv_block == "finch":
        return layer_norm(x, params[name], params[f"{name}_b"], cfg.norm_eps)
    return rms_norm(x, params[name], cfg.norm_eps)


def _apply_block(params, x, pos, kind: str, cfg: ModelConfig, use_moe: bool,
                 cache=None, enc_kv=None, mrope_pos=None):
    """Returns (x, new_cache, aux)."""
    aux = {}
    h = _block_norm(params, "ln1", x, cfg)
    mixer = _traced_mixer if tel.recording() else _mixer
    r, new_cache = mixer(params["mixer"], h, pos, kind, cfg, cache,
                         mrope_pos)
    x = x + r
    if cfg.is_encdec and enc_kv is not None:
        hx = rms_norm(x, params["ln_x"], cfg.norm_eps)
        x = x + attn.cross_attention(params["cross"], hx, enc_kv, cfg)
    h2 = _block_norm(params, "ln2", x, cfg)
    if kind == "rwkv":
        if cache is not None:
            f, chan_prev = rec.rwkv_channel_mix(params["ffn"], h2, cfg,
                                                x_prev=cache["chan_prev"])
            new_cache["chan_prev"] = chan_prev
        else:
            f = rec.rwkv_channel_mix(params["ffn"], h2, cfg)
    elif use_moe:
        f, aux = moe_lib.moe_ffn(params["ffn"], h2, cfg)
    else:
        f = ffn(params["ffn"], h2, cfg)
    return x + f, new_cache, aux


def _unstack(tree, n: int) -> list:
    """The ``n`` per-cycle trees of a stacked tree: one ``unbind`` per
    leaf, whose backward stacks the cycles' gradients in one write (a
    ``[i]`` per cycle would fill a full-size zero gradient per cycle)."""
    flat, tdef = _tree.flatten(tree)
    parts = [torch.unbind(a, 0) for a in flat]
    return [tdef.unflatten(p[i] for p in parts) for i in range(n)]


def _store(dst, src) -> None:
    """Write a decode step's new cache leaves into the stacked cache's
    views ``dst``; leaves the step updated in place are ``dst`` itself."""
    flat, tdef = _tree.flatten(dst)
    for d, s in zip(flat, tdef.flatten_up_to(src)):
        if s is not d:
            d.copy_(s)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


# ================================================================ model
@dataclasses.dataclass(frozen=True)
class Transformer:
    cfg: ModelConfig

    # ------------------------------------------------------------ init
    def init(self, key, device="cuda") -> dict:
        """Random parameters: ``key`` is a seed (drawn on ``device``) or an
        ``InitKey``. The repeated cycles' parameters are stacked on a
        leading axis of ``n_cycles``."""
        cfg = self.cfg
        if not isinstance(key, InitKey):
            key = InitKey.from_seed(key, device)
        prelude, pattern, n_cycles, tail = _layer_kinds(cfg)
        params = {"embed": init_embed(key, cfg),
                  "final_ln": init_full(key, (cfg.d_model,), 0.0)}
        params["prelude"] = [_init_block(key, k, cfg, use_moe=False)
                             for k in prelude]
        if n_cycles:
            stacked = key.stacked(n_cycles)
            params["main"] = {
                f"sub{j}": _init_block(stacked, kind, cfg,
                                       use_moe=cfg.moe is not None)
                for j, kind in enumerate(pattern)}
        params["tail"] = [_init_block(key, k, cfg,
                                      use_moe=cfg.moe is not None)
                          for k in tail]
        if cfg.is_encdec:
            enc = cfg.encoder
            params["enc"] = {
                "blocks": [_init_block(key, "attn",
                                       dataclasses.replace(cfg, encoder=None),
                                       use_moe=False)
                           for _ in range(enc.n_layers)],
                "final_ln": init_full(key, (cfg.d_model,), 0.0)}
        if cfg.mtp:
            params["mtp"] = {
                "proj": init_dense(key, (2 * cfg.d_model, cfg.d_model),
                                   dtype=cfg.dtype),
                "block": _init_block(key, "attn", cfg,
                                     use_moe=cfg.moe is not None),
                "ln": init_full(key, (cfg.d_model,), 0.0)}
        return params

    # ------------------------------------------------------------ encoder
    def encode(self, params, frames):
        """Whisper encoder over precomputed frame embeddings [B, T, D]."""
        cfg = self.cfg
        b, t, _ = frames.shape
        pos = _positions(b, t, frames.device)
        x = frames
        for blk in params["enc"]["blocks"]:
            h = rms_norm(x, blk["ln1"], cfg.norm_eps)
            # bidirectional chunked attention (no causal mask)
            hq = split_heads(einsum("bsd,de->bse", h, blk["mixer"]["wq"]),
                             cfg.n_heads, cfg.dh)
            hk = split_heads(einsum("bsd,de->bse", h, blk["mixer"]["wk"]),
                             cfg.n_kv_heads, cfg.dh)
            hv = split_heads(einsum("bsd,de->bse", h, blk["mixer"]["wv"]),
                             cfg.n_kv_heads, cfg.dh)
            hk, hv = attn._kv_for_heads(hq, hk, hv)
            out = attn.chunked_attention(hq, hk, hv, pos, pos, causal=False,
                                         window=0, chunk=cfg.attn_chunk,
                                         canonical=True)
            r = shard(einsum("bse,ed->bsd",
                             merge_heads(out),
                             blk["mixer"]["wo"]), "residual")
            x = x + r
            h2 = rms_norm(x, blk["ln2"], cfg.norm_eps)
            x = x + ffn(blk["ffn"], h2, cfg)
        return rms_norm(x, params["enc"]["final_ln"], cfg.norm_eps)

    # ------------------------------------------------------------ trunk
    def _trunk(self, params, x, pos, enc_kvs=None, mrope_pos=None,
               out_dtype=None):
        """Full-sequence trunk (train/prefill). Returns (hidden, aux), the
        hidden states after the final norm in ``out_dtype`` (by default
        the stream's)."""
        cfg = self.cfg
        prelude, pattern, n_cycles, tail = _layer_kinds(cfg)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        drop_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        li = 0
        for i, kind in enumerate(prelude):
            x, _, aux = _apply_block(params["prelude"][i], x, pos, kind, cfg,
                                     use_moe=False,
                                     enc_kv=_idx_enc(enc_kvs, li),
                                     mrope_pos=mrope_pos)
            li += 1

        if n_cycles:
            def cycle(x, aux_s, drop_s, cyc_params):
                for j, kind in enumerate(pattern):
                    x, _, aux = _apply_block(
                        cyc_params[f"sub{j}"], x, pos, kind, cfg,
                        use_moe=cfg.moe is not None, mrope_pos=mrope_pos)
                    if aux:
                        aux_s = aux_s + aux["load_balance"]
                        drop_s = drop_s + aux["dropped_frac"]
                return x, aux_s, drop_s

            remat = cfg.remat == "full" and torch.is_grad_enabled()
            for cyc_params in _unstack(params["main"], n_cycles):
                if remat:
                    x, aux_sum, drop_sum = checkpoint(
                        cycle, x, aux_sum, drop_sum, cyc_params,
                        use_reentrant=False)
                else:
                    x, aux_sum, drop_sum = cycle(x, aux_sum, drop_sum,
                                                 cyc_params)
            li += n_cycles * len(pattern)

        for i, kind in enumerate(tail):
            x, _, aux = _apply_block(params["tail"][i], x, pos, kind, cfg,
                                     use_moe=cfg.moe is not None,
                                     enc_kv=_idx_enc(enc_kvs, li),
                                     mrope_pos=mrope_pos)
            if aux:
                aux_sum = aux_sum + aux["load_balance"]
                drop_sum = drop_sum + aux["dropped_frac"]
            li += 1
        x = rms_norm(x, params["final_ln"], cfg.norm_eps, out_dtype)
        return x, {"load_balance": aux_sum, "dropped": drop_sum}

    # ------------------------------------------------------------ losses
    def loss(self, params, batch):
        """Next-token CE (+ MoE aux + MTP). batch: tokens/labels [B, S]
        (+ frames for enc-dec, + mrope_pos for M-RoPE)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        pos = _positions(b, s, tokens.device)
        x = embed(params["embed"], tokens, cfg)
        enc_kvs = None
        if cfg.is_encdec:
            enc_out = self.encode(params, batch["frames"])
            enc_kvs = self._cross_kvs(params, enc_out)
        # the final norm's output in float32, so the head's gradient
        # reaches the norm's float32 backward unrounded (``_FloatLogits``)
        h, aux = self._trunk(params, x, pos, enc_kvs,
                             mrope_pos=batch.get("mrope_pos"),
                             out_dtype=torch.float32)
        loss = _chunked_ce(params["embed"], h, batch["labels"], cfg)
        total = loss + 0.01 * aux["load_balance"]
        if cfg.mtp:
            total = total + 0.3 * self._mtp_loss(
                params, h.to(x.dtype), tokens, batch["labels"], pos)
        return total, dict(aux, ce=loss)

    def _mtp_loss(self, params, h, tokens, labels, pos):
        """DeepSeek-style MTP: one extra block predicts token t+2 from
        [h_t ; emb(token_{t+1})]."""
        cfg = self.cfg
        emb_next = embed(params["embed"], _roll(tokens), cfg)
        hcat = torch.cat(
            [rms_norm(h, params["mtp"]["ln"], cfg.norm_eps), emb_next],
            dim=-1)
        h2 = einsum("bsd,de->bse", hcat, params["mtp"]["proj"])
        h2, _, _ = _apply_block(params["mtp"]["block"], h2, pos, "attn", cfg,
                                use_moe=cfg.moe is not None)
        labels2 = _roll(labels)
        return _chunked_ce(params["embed"], h2, labels2, cfg)

    def _cross_kvs(self, params, enc_out):
        """Per-decoder-layer cross-attention KV (enc-dec is unrolled)."""
        cfg = self.cfg
        kvs = [attn.encode_cross_kv(blk["cross"], enc_out, cfg)
               for blk in params["prelude"]]
        kvs += [attn.encode_cross_kv(blk["cross"], enc_out, cfg)
                for blk in params["tail"]]
        return kvs

    # ------------------------------------------------------------ serving
    def init_caches(self, batch: int, capacity: int, device="cuda"):
        cfg = self.cfg
        dev = resolve_device(device)
        prelude, pattern, n_cycles, tail = _layer_kinds(cfg)
        caches = {"prelude": [_init_cache(k, cfg, batch, capacity, dev)
                              for k in prelude],
                  "tail": [_init_cache(k, cfg, batch, capacity, dev)
                           for k in tail]}
        if n_cycles:
            caches["main"] = {
                f"sub{j}": _tree.tree_map(
                    lambda a: a[None].expand((n_cycles,) + a.shape).clone(),
                    _init_cache(kind, cfg, batch, capacity, dev))
                for j, kind in enumerate(pattern)}
        return caches

    def decode_step(self, params, token, caches, pos_idx, enc_kvs=None):
        """One serving step. token: [B, 1] integer; pos_idx: the cache fill
        level (an int or a 0-dim tensor). Returns (logits [B, 1, V], the
        caches, updated in place)."""
        cfg = self.cfg
        prelude, pattern, n_cycles, tail = _layer_kinds(cfg)
        b = token.shape[0]
        pos = torch.as_tensor(pos_idx, dtype=torch.int32,
                              device=token.device).reshape(1, 1).expand(b, 1)
        mrope = pos[None].expand(3, b, 1) if cfg.mrope_sections else None
        x = embed(params["embed"], token, cfg)
        new_caches = {"prelude": [], "tail": []}
        li = 0
        for i, kind in enumerate(prelude):
            x, c, _ = _apply_block(params["prelude"][i], x, pos, kind, cfg,
                                   use_moe=False, cache=caches["prelude"][i],
                                   enc_kv=_idx_enc(enc_kvs, li),
                                   mrope_pos=mrope)
            new_caches["prelude"].append(c)
            li += 1
        if n_cycles:
            main = caches["main"]
            for i in range(n_cycles):
                for j, kind in enumerate(pattern):
                    sub = f"sub{j}"
                    cyc_cache = _tree.tree_map(lambda a: a[i], main[sub])
                    x, c, _ = _apply_block(
                        _tree.tree_map(lambda a: a[i], params["main"][sub]),
                        x, pos, kind, cfg, use_moe=cfg.moe is not None,
                        cache=cyc_cache, mrope_pos=mrope)
                    _store(cyc_cache, c)
            new_caches["main"] = main
            li += n_cycles * len(pattern)
        for i, kind in enumerate(tail):
            x, c, _ = _apply_block(params["tail"][i], x, pos, kind, cfg,
                                   use_moe=cfg.moe is not None,
                                   cache=caches["tail"][i],
                                   enc_kv=_idx_enc(enc_kvs, li),
                                   mrope_pos=mrope)
            new_caches["tail"].append(c)
            li += 1
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg)
        return logits, new_caches

    def prefill(self, params, tokens, frames=None, mrope_pos=None):
        """Prefill hidden states (logits for the last position)."""
        cfg = self.cfg
        b, s = tokens.shape
        pos = _positions(b, s, tokens.device)
        x = embed(params["embed"], tokens, cfg)
        enc_kvs = None
        if cfg.is_encdec and frames is not None:
            enc_kvs = self._cross_kvs(params, self.encode(params, frames))
        h, aux = self._trunk(params, x, pos, enc_kvs, mrope_pos=mrope_pos)
        return unembed(params["embed"], h[:, -1:], cfg), aux


def _roll(t):
    """``torch.roll(t, -1, 1)`` on each rank's batch rows (DTensor has no
    strategy for ``roll`` in every release)."""
    return batch_local(lambda x: torch.roll(x, -1, 1), t, batch=t.shape[0])


def _idx_enc(enc_kvs, li):
    return None if enc_kvs is None else enc_kvs[li]


def _vocab_split(logits) -> list:
    """The mesh dimensions of more than one rank that split the vocabulary
    (the last dimension) of DTensor logits; [] for anything else."""
    if type(logits).__name__ != "DTensor":
        return []
    last = logits.dim() - 1
    return [i for i, p in enumerate(logits.placements)
            if p.is_shard(last) and logits.device_mesh.size(i) > 1]


def _logsumexp(logits):
    """``logsumexp`` over the last dimension. Over vocab-split DTensor
    logits it reduces a max and a sum of exponentials across the shards
    (two all-reduces of [B, S]) instead of gathering [B, S, V]."""
    if not _vocab_split(logits):
        return torch.logsumexp(logits, dim=-1)
    m = settle(logits.amax(dim=-1)).detach()
    return m + torch.log(settle(torch.exp(logits - m[..., None]).sum(-1)))


def _gold(logits, lx):
    """The logit of each labelled token. Over vocab-split DTensor logits
    each rank picks the labels in its vocabulary block (zero elsewhere)
    and the blocks are summed (Megatron's vocab-parallel cross entropy):
    the gather's gradient stays one [B, S, V / shards] block a rank."""
    idx = torch.clamp_min(lx, 0).long()[..., None]
    vocab = _vocab_split(logits)
    if not vocab:
        return settle(torch.gather(logits, -1, idx))[..., 0]
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    pl = tuple(p if (i in vocab or p.is_shard(0)) else Replicate()
               for i, p in enumerate(logits.placements))
    local = logits.redistribute(mesh, pl).to_local()
    bpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    idx = _rows_of(idx, mesh, bpl)
    n = local.shape[-1]
    rel = idx - _block(mesh, vocab) * n
    hit = (rel >= 0) & (rel < n)
    picked = torch.where(hit, torch.gather(local, -1, rel.clamp(0, n - 1)),
                         torch.zeros((), dtype=local.dtype,
                                     device=local.device))[..., 0]
    return settle(_sum_over(picked, mesh, vocab, bpl))


class _FloatLogits(torch.autograd.Function):
    """``x @ w`` as float32 logits, the product in w's dtype (x is cast to
    it). The backward hands x's gradient back in float32.

    The mean over n labelled positions makes the gold token's gradient,
    -(1 - p) / n, nearly one number at every position while p is small
    (as at initialisation). Rounded once to bf16 it is off by the same
    share everywhere (-0.2 % at n = 2,044), and every gradient of the
    model below the head would be scaled by it. So x's gradient takes two
    products, of hi = g rounded and of lo = g - hi rounded, summed in
    float32: with a float32 x (the final norm's output) the rounding to
    bf16 waits for the norm's backward, where each element differs. w's
    gradient takes hi alone: a gold column seen once stays a bf16 value
    over n, off by that share whatever the rounding."""

    @staticmethod
    def forward(ctx, x, w):
        xw = x.to(w.dtype)
        ctx.save_for_backward(xw, w)
        ctx.x_dtype = x.dtype
        return shard(einsum("...d,dv->...v", xw, w), "logits").float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hi = g.to(w.dtype)
        dx = einsum("...v,dv->...d", hi, w).float()
        if w.dtype != torch.float32:
            lo = torch.sub(g, hi, out=torch.empty_like(hi))
            dx = dx + einsum("...v,dv->...d", lo, w).float()
        return dx.to(ctx.x_dtype), einsum("...d,...v->dv", x, hi)


def _ce_chunk(embed_params, hx, lx, cfg: ModelConfig):
    """(summed CE, count of labelled positions) of one sequence chunk."""
    w = (embed_params["tok"].T if cfg.tie_embeddings
         else embed_params["head"])
    logits = _FloatLogits.apply(hx, w)
    logz = _logsumexp(logits)
    gold = _gold(logits, lx)
    valid = (lx >= 0).float()
    return torch.sum((logz - gold) * valid), valid.sum()


def _chunked_ce(embed_params, h, labels, cfg: ModelConfig, chunk: int = 512):
    """Sequence-chunked cross entropy: never materializes [B, S, V] f32;
    with gradients on, each chunk's logits are recomputed in the backward
    pass instead of saved."""
    b, s, d = h.shape
    pad = (-s) % chunk
    if pad:
        h = torch.cat([h, h.new_zeros((b, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_full((b, pad), -1)], dim=1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled() and h.requires_grad
    for i in range(0, s + pad, chunk):
        args = (embed_params, h[:, i:i + chunk], labels[:, i:i + chunk], cfg)
        t, c = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                else _ce_chunk(*args))
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
