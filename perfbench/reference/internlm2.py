"""Plain float32 InternLM2 decoder layer [arXiv:2403.17297].

One pre-norm block: RMS norm, grouped-query attention with rotary
positions over the whole causal sequence, residual add; RMS norm, SwiGLU
feed-forward, residual add. Products run through ``common.mm`` so the
control can round their operands.

Departures from the published description, each as the benchmarked
program defines the model:
  * the query, key and value projections are three matrices (``wq``,
    ``wk``, ``wv``); the published checkpoint stores them as one
    interleaved ``wqkv``. The same function, another storage;
  * each RMS norm's scale is stored as an offset from 1 (``x / rms(x) *
    (1 + scale)``) and starts at 0;
  * rotary embedding rotates the two halves of each head (the published
    code's ``rotate_half``), at the configuration's ``rope_theta``, with no
    dynamic scaling;
  * query head ``i`` reads key and value head ``i // (heads / kv_heads)``;
  * the weights are random (``param_specs``), not the released ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import mm, rms_norm


def param_specs(m: dict) -> dict:
    """``{path: (shape, dtype, init)}`` of every parameter. The layers'
    parameters are stacked on a leading axis of ``n_layers`` under
    ``main.sub0``. ``init`` is ``("normal", std)`` or ``("const", v)``."""
    d, h, kv, f, v = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                      m["d_ff"], m["vocab"])
    dh = m.get("head_dim") or d // h
    n, wt = m["n_layers"], m["dtype"]
    normal = lambda *shape: (tuple(shape), wt, ("normal", shape[-2] ** -0.5))
    return {
        "embed.tok": ((v, d), wt, ("normal", 1.0)),
        "embed.head": ((d, v), wt, ("normal", d ** -0.5)),
        "final_ln": ((d,), "float32", ("const", 0.0)),
        "main.sub0.ln1": ((n, d), "float32", ("const", 0.0)),
        "main.sub0.ln2": ((n, d), "float32", ("const", 0.0)),
        "main.sub0.mixer.wq": normal(n, d, h * dh),
        "main.sub0.mixer.wk": normal(n, d, kv * dh),
        "main.sub0.mixer.wv": normal(n, d, kv * dh),
        "main.sub0.mixer.wo": normal(n, h * dh, d),
        "main.sub0.ffn.wi": normal(n, d, 2 * f),
        "main.sub0.ffn.wo": normal(n, f, d),
    }


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, S, H, Dh] at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(L: dict, x: torch.Tensor, m: dict, prec: str) -> torch.Tensor:
    b, s, d = x.shape
    h, kv = m["n_heads"], m["n_kv_heads"]
    dh = m.get("head_dim") or d // h
    theta = m.get("rope_theta", 10000.0)
    q = rope(mm("bsd,de->bse", x, L["mixer.wq"], prec).reshape(b, s, h, dh),
             theta)
    k = rope(mm("bsd,de->bse", x, L["mixer.wk"], prec).reshape(b, s, kv, dh),
             theta)
    v = mm("bsd,de->bse", x, L["mixer.wv"], prec).reshape(b, s, kv, dh)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = mm("bqhd,bkhd->bhqk", q, k, prec) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm("bhqk,bkhd->bqhd", p, v, prec).reshape(b, s, h * dh)
    return mm("bse,ed->bsd", out, L["mixer.wo"], prec)


def feed_forward(L: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    gate, up = mm("bsd,df->bsf", x, L["ffn.wi"], prec).chunk(2, dim=-1)
    return mm("bsf,fd->bsd", F.silu(gate) * up, L["ffn.wo"], prec)


def block(L: dict, x: torch.Tensor, m: dict, prec: str) -> torch.Tensor:
    """One layer. ``L`` holds the layer's slice of every stacked
    parameter, keyed by its path under ``main.sub0.``."""
    eps = m.get("norm_eps", 1e-5)
    x = x + attention(L, rms_norm(x, L["ln1"], eps), m, prec)
    return x + feed_forward(L, rms_norm(x, L["ln2"], eps), prec)
