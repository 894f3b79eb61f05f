"""Attention-free mixers: RG-LRU (RecurrentGemma) and RWKV-6 "Finch".

The counterpart of ``repro.models.recurrent``. Both expose the same
interface as the attention mixers:
  * full-sequence mode (train/prefill), a loop over time,
  * single-step decode against a small recurrent state (their "KV cache").
The RG-LRU's recurrence runs step by step where the reference takes a
log-depth ``associative_scan``: the same recurrence, rounded in another
order. The per-head group norm's variance is the population variance
(``correction=0``), as ``jnp.var``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (InitKey, einsum, gelu, init_dense, init_full,
                     merge_heads, shard, split_heads)
from .config import ModelConfig


# ================================================================ RG-LRU
def init_rglru(key: InitKey, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    return {
        "wx": init_dense(key, (d, 2 * w), dtype=cfg.dtype),  # rnn + gate br.
        "conv": init_dense(key, (4, w), scale=0.5, dtype=cfg.dtype),
        "w_a": init_dense(key, (w, w), dtype=cfg.dtype),     # recurrence gate
        "w_i": init_dense(key, (w, w), dtype=cfg.dtype),     # input gate
        # Lambda parameterized so a = exp(-8*softplus(lam)*sigmoid(.)) starts
        # near long memory
        "lam": init_full(key, (w,), 0.5),
        "wo": init_dense(key, (w, d), dtype=cfg.dtype),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 4, w), dtype=torch.float32,
                                device=device)}


_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(params, x):
    """Per-timestep gate terms of the RG-LRU recurrence. x: [..., W] f32
    (post-conv). Returns (a, gated) with h_t = a_t * h_{t-1} + gated_t.
    All dots live here, outside the time recurrence."""
    r = torch.sigmoid(torch.einsum("...w,wv->...v", x,
                                   params["w_a"].float()))
    i = torch.sigmoid(torch.einsum("...w,wv->...v", x,
                                   params["w_i"].float()))
    log_a = -_C * _softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * x)
    return a, gated


def _rglru_step(params, h, x_t):
    """One RG-LRU decode step. x_t: [B, W] (post-conv); h: [B, W]."""
    a, gated = _rglru_gates(params, x_t)
    return a * h + gated


def rglru_mixer(params, x, cfg: ModelConfig, state: dict | None = None):
    """x: [B, S, D]. Full-sequence when state is None; else one decode
    step."""
    b, s, d = x.shape
    xb = einsum("bsd,dw->bsw", x, params["wx"])
    rnn_in, gate = torch.chunk(xb, 2, dim=-1)
    rnn_in = rnn_in.float()

    if state is None:
        # temporal conv (width 4, causal) over the rnn branch
        pad = F.pad(rnn_in, (0, 0, 3, 0))
        conv = sum(pad[:, i:i + s] * params["conv"][i].float()
                   for i in range(4))
        # the elementwise linear recurrence h_t = a_t h_{t-1} + g_t
        a, g = _rglru_gates(params, conv)               # [B, S, W]
        h = torch.zeros_like(a[:, 0])
        hs = []
        for t in range(s):
            h = a[:, t] * h + g[:, t]
            hs.append(h)
        y = torch.stack(hs, dim=1)                      # [B, S, W]
        new_state = None
    else:
        # decode: roll the conv window, one recurrence step
        win = torch.cat([state["conv"][:, 1:], rnn_in], dim=1)
        conv_t = torch.einsum("bkw,kw->bw", win, params["conv"].float())
        h = _rglru_step(params, state["h"], conv_t)
        y = h[:, None, :]
        new_state = {"h": h, "conv": win}

    out = y.to(x.dtype) * gelu(gate.float()).to(x.dtype)
    out = shard(einsum("bsw,wd->bsd", out, params["wo"]), "residual")
    return (out, new_state) if state is not None else out


# ================================================================ RWKV-6
def init_rwkv(key: InitKey, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        # data-dependent token-shift mix coefficients (Finch ddlerp, shared
        # low-rank path simplified to per-channel mu + one lora)
        "mu": init_dense(key, (5, d), scale=0.5, dtype="float32"),
        "w1": init_dense(key, (d, 64), dtype=cfg.dtype),
        "w2": init_dense(key, (64, d), dtype=cfg.dtype),
        "decay_base": init_full(key, (d,), -2.0),
        "u": init_dense(key, (d,), scale=0.5, dtype="float32"),  # bonus
        "wr": init_dense(key, (d, d), dtype=cfg.dtype),
        "wk": init_dense(key, (d, d), dtype=cfg.dtype),
        "wv": init_dense(key, (d, d), dtype=cfg.dtype),
        "wg": init_dense(key, (d, d), dtype=cfg.dtype),
        "wo": init_dense(key, (d, d), dtype=cfg.dtype),
        "ln_x": init_full(key, (d,), 1.0),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    h = d // dh
    return {"s": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, d), dtype=torch.float32,
                                  device=device)}


def _rwkv_inner(params, r, k, v, w, u, s0):
    """Finch recurrence over time. r,k,v,w: [B, S, H, Dh] (f32);
    s0: [B, H, Dh, Dh].

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    s = s0
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               s + u[None, :, :, None] * kv))
        s = w_t[..., None] * s + kv
    return torch.stack(ys, dim=1), s                    # [B, S, H, Dh]


def rwkv_mixer(params, x, cfg: ModelConfig, state: dict | None = None):
    """RWKV-6 time-mix. x: [B, S, D]."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    xf = x.float()
    if state is None:
        x_prev = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    else:
        x_prev = state["x_prev"][:, None, :]
    delta = x_prev - xf
    mu = params["mu"].float()
    # data-dependent shift amount (shared lora across the five mixes)
    dd = torch.tanh(torch.einsum("bsd,dr->bsr", xf, params["w1"].float()))
    dd = torch.einsum("bsr,rd->bsd", dd, params["w2"].float())
    xr, xk, xv, xg, xw = (xf + delta * torch.sigmoid(mu[i] + dd)
                          for i in range(5))

    r = torch.einsum("bsd,de->bse", xr, params["wr"].float())
    k = torch.einsum("bsd,de->bse", xk, params["wk"].float())
    v = torch.einsum("bsd,de->bse", xv, params["wv"].float())
    g = torch.einsum("bsd,de->bse", xg, params["wg"].float())
    # data-dependent decay (the Finch signature): w in (0,1)
    w = torch.exp(-torch.exp(params["decay_base"] + xw))

    hd = lambda a: split_heads(a, h, dh)
    u = params["u"].float().reshape(h, dh)
    s0 = (state["s"] if state is not None
          else torch.zeros((b, h, dh, dh), dtype=torch.float32,
                           device=x.device))
    y, s_new = _rwkv_inner(params, hd(r), hd(k), hd(v), hd(w), u, s0)
    # group-norm per head (ln_x), then output gate
    yh = y.reshape(b, s, h, dh)
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True, correction=0) + 1e-5)
    y = merge_heads(yh) * params["ln_x"]
    y = y * F.silu(g)
    out = shard(einsum("bsd,de->bse", y.to(x.dtype), params["wo"]),
                "residual")
    if state is not None:
        return out, {"s": s_new, "x_prev": xf[:, -1]}
    return out


def init_rwkv_channel(key: InitKey, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": init_dense(key, (d,), scale=0.5, dtype="float32"),
            "mu_r": init_dense(key, (d,), scale=0.5, dtype="float32"),
            "wk": init_dense(key, (d, f), dtype=cfg.dtype),
            "wv": init_dense(key, (f, d), dtype=cfg.dtype),
            "wr": init_dense(key, (d, d), dtype=cfg.dtype)}


def rwkv_channel_mix(params, x, cfg: ModelConfig,
                     x_prev: torch.Tensor | None = None):
    """RWKV channel-mix ("FFN") with token shift. x: [B, S, D]."""
    xf = x.float()
    if x_prev is None:
        prev = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    else:
        prev = x_prev[:, None, :]
    delta = prev - xf
    xk = xf + delta * torch.sigmoid(params["mu_k"])
    xr = xf + delta * torch.sigmoid(params["mu_r"])
    kk = einsum("bsd,df->bsf", xk.to(x.dtype), params["wk"])
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = einsum("bsf,fd->bsd", kk, params["wv"])
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                    params["wr"].float()))
    out = shard(rr.to(x.dtype) * vv, "residual")
    if x_prev is not None:
        return out, xf[:, -1]
    return out
