"""Attention-free mixers: RG-LRU (RecurrentGemma) and RWKV-6 "Finch"
(the JAX package's simplified block, or the published one: ``ModelConfig.
rwkv_block``).

The counterpart of ``repro.models.recurrent``. Both expose the same
interface as the attention mixers:
  * full-sequence mode (train/prefill): one scan over time, the
    hand-written kernels of ``kernels.recurrence`` (``rglru_scan``,
    ``wkv6_scan``; their plain versions on CPU tensors),
  * single-step decode against a small recurrent state (their "KV cache"):
    the RG-LRU's one elementwise step, the RWKV scan over one step.
The RG-LRU's recurrence runs step by step where the reference takes a
log-depth ``associative_scan``: the same recurrence, rounded in another
order. The per-head group norm's variance is the population variance
(``correction=0``), as ``jnp.var``.

On a mesh the scans run on each rank's local block (``_rglru_scan_local``,
``_wkv6_scan_local``; the token shifts' padding too, ``_front_pad``): they
are independent across the batch, the heads (RWKV) and the channels
(RG-LRU), so a split of those dimensions stays, and a split of the
sequence or a pending partial sum is made whole first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import telemetry as tel
from .._device import resolve_device
from ..kernels.recurrence.ops import rglru_scan, wkv6_scan
from .common import (InitKey, _is_dtensor, _rows_of, einsum, gelu,
                     init_dense, init_full, merge_heads, shard, split_heads,
                     trace_backward)
from .config import FINCH_DECAY_RANK, FINCH_MIX_RANK, ModelConfig


def _local_placements(x) -> tuple:
    """``x``'s placements with only the splits of dimension 0 (batch) and
    2 (heads or channels) kept: the scans' blocks."""
    from torch.distributed.tensor import Replicate
    return tuple(p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
                 for p in x.placements)


def _front_pad(x, n: int):
    """``x`` [B, S, D] with ``n`` zero steps put in front of the sequence.
    A DTensor is padded on its local blocks (batch and width splits
    kept, a split of the sequence gathered first): DTensor's own ``pad``
    fails to redistribute under torch 2.11 (an index error in its
    transform planning)."""
    if not _is_dtensor(x):
        return F.pad(x, (0, 0, n, 0))
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    pl = _local_placements(x)
    local = F.pad(x.redistribute(mesh, pl).to_local(), (0, 0, n, 0))
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _rglru_scan_local(a, g):
    """``rglru_scan`` from a zero state; DTensor a, g [B, S, W] on each
    rank's block (batch and channel splits kept)."""
    if not _is_dtensor(a):
        return rglru_scan(a, g)
    from torch.distributed.tensor import DTensor
    mesh = a.device_mesh
    pl = _local_placements(a)
    h = rglru_scan(*(t.redistribute(mesh, pl).to_local() for t in (a, g)))
    return DTensor.from_local(h, mesh, pl, run_check=False)


def _wkv6_scan_local(r, k, v, w, u, s0):
    """``wkv6_scan``; DTensor r, k, v, w [B, S, H, Dh] on each rank's block
    (batch and head splits kept): ``u`` [H, Dh] is cut to the local heads,
    its gradient summed over the ranks that split the batch; the state
    [B, H, Dh, Dh] (``s0`` None: zero) follows the batch and heads."""
    if not _is_dtensor(r):
        if s0 is None:
            b, _, h, d = r.shape
            s0 = r.new_zeros((b, h, d, d))
        return wkv6_scan(r, k, v, w, u, s0)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = r.device_mesh
    pl = _local_placements(r)
    spl = tuple(Shard(1) if p.is_shard(2) else p for p in pl)
    upl = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in pl)
    lr, lk, lv, lw = (t.redistribute(mesh, pl).to_local()
                      for t in (r, k, v, w))
    if _is_dtensor(u):
        u = u.redistribute(mesh, upl).to_local(grad_placements=[
            Partial() if p.is_shard(0) else q for p, q in zip(pl, upl)])
    else:
        u = _rows_of(u, mesh, upl)
    if s0 is None:
        b, _, h, d = lr.shape
        s0 = lr.new_zeros((b, h, d, d))
    else:
        s0 = _rows_of(s0, mesh, spl)
    y, s = wkv6_scan(lr, lk, lv, lw, u, s0)
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(s, mesh, spl, run_check=False))


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


def init_rglru_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    device = resolve_device(device)
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
        pad = _front_pad(rnn_in, 3)
        conv = sum(pad[:, i:i + s] * params["conv"][i].float()
                   for i in range(4))
        # the elementwise linear recurrence h_t = a_t h_{t-1} + g_t
        a, g = _rglru_gates(params, conv)               # [B, S, W]
        y = _rglru_scan_local(a, g)                     # [B, S, W]
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
# The block of ``cfg.rwkv_block``. "simplified", the JAX package's: the five
# token-shift mixes share one LoRA through ``sigmoid(mu + dd)``, the decay
# adds the mixed input itself, RMS block norms, a group norm without bias,
# the channel mix's coefficients through a sigmoid. "finch", RWKV-6 as
# published (RWKV-LM ``RWKV_Tmix_x060`` / ``RWKV_CMix_x060``): with
# xx = shift(x) - x and xxx = x + xx maa_x,
#   x_i = x + xx (maa_i + tanh(xxx W1) W2_i)      i in w, k, v, r, g
#   w   = exp(-exp(decay + tanh(x_w D1) D2))
# r, k, v, g = silu(.) the projections of x_r, x_k, x_v, x_g; the scan; a
# group norm of each head with weight and bias; the output gate. Channel
# mix: sigmoid(x_r Wr) (relu(x_k Wk)^2 Wv), x_* = x + xx maa_*. LayerNorm
# block norms with bias (``transformer._apply_block``).
_SCAN_PATHS = {"kernel": 0, "plain": 0}
# the time mix's group-norm eps by block: Finch's 1e-5 times
# ``head_size_divisor`` 8 squared, the JAX package's 1e-5
GN_EPS = {"finch": 6.4e-4, "simplified": 1e-5}


def scan_paths() -> dict:
    """``{"kernel": n, "plain": n}``: ``wkv6_scan`` calls of the time mix
    on CUDA tensors (the hand-written kernel) and on CPU tensors (the
    plain loop) since the last reset."""
    return dict(_SCAN_PATHS)


def reset_scan_paths() -> None:
    for key in _SCAN_PATHS:
        _SCAN_PATHS[key] = 0


def _shifted(xf, last):
    """The token shift of xf [B, S, D]: each position's previous one,
    zero before the first, or ``last`` [B, D] (the state's last token)
    before it."""
    if last is None:
        return _front_pad(xf, 1)[:, :-1]
    return torch.cat([last[:, None, :], xf[:, :-1]], dim=1)


def _scan(r, k, v, w, u, s0):
    """``_wkv6_scan_local``, counted by path. While spans are made, inside
    a ``model.wkv6`` span, its backward a ``model.wkv6.backward`` interval:
    from the gradient of y arriving to that of r (the scan's backward gives
    every input's gradient at once)."""
    path = {"cuda": "kernel", "cpu": "plain"}.get(r.device.type)
    if path:
        _SCAN_PATHS[path] += 1
    if not tel.recording():
        return _wkv6_scan_local(r, k, v, w, u, s0)
    with tel.span("model.wkv6"):
        y, s = _wkv6_scan_local(r, k, v, w, u, s0)
    trace_backward("model.wkv6.backward", y, r)
    return y, s


def init_rwkv(key: InitKey, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.rwkv_block == "finch":
        return _init_finch(key, cfg)
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


def _init_finch(key: InitKey, cfg: ModelConfig) -> dict:
    """The Finch time mix's parameters: the mixing coefficients and
    decays in float32, the matrices in the config's dtype. The LoRAs' W2
    draw at std 0.01 (the published init's scale), their W1 at fan-in;
    the key and gate matrices at a tenth of fan-in (the published init's
    gains)."""
    d, rm, rd = cfg.d_model, FINCH_MIX_RANK, FINCH_DECAY_RANK
    dense = lambda *shape, scale=None: init_dense(key, shape, scale=scale,
                                                  dtype=cfg.dtype)
    return {
        "maa_x": init_full(key, (d,), 0.5),
        "maa": init_full(key, (5, d), 0.5),             # w, k, v, r, g
        "maa_w1": dense(d, 5 * rm),
        "maa_w2": dense(5, rm, d, scale=0.01),
        "decay": init_full(key, (d,), -2.0),            # w near 0.87
        "decay_w1": dense(d, rd),
        "decay_w2": dense(rd, d, scale=0.01),
        "u": init_dense(key, (d,), scale=0.5, dtype="float32"),
        "wr": dense(d, d), "wk": dense(d, d, scale=0.1 * d ** -0.5),
        "wv": dense(d, d), "wg": dense(d, d, scale=0.1 * d ** -0.5),
        "wo": dense(d, d),
        "ln_x": init_full(key, (d,), 1.0),
        "ln_x_b": init_full(key, (d,), 0.0),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    device = resolve_device(device)
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    h = d // dh
    return {"s": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, d), dtype=torch.float32,
                                  device=device)}


def _simplified_mixes(params, xf, delta):
    """(x_r, x_k, x_v, x_g, w) of the simplified block."""
    mu = params["mu"].float()
    # data-dependent shift amount (shared lora across the five mixes)
    dd = torch.tanh(torch.einsum("bsd,dr->bsr", xf, params["w1"].float()))
    dd = torch.einsum("bsr,rd->bsd", dd, params["w2"].float())
    xr, xk, xv, xg, xw = (xf + delta * torch.sigmoid(mu[i] + dd)
                          for i in range(5))
    # data-dependent decay (the Finch signature): w in (0,1)
    return xr, xk, xv, xg, torch.exp(-torch.exp(params["decay_base"] + xw))


def _finch_mixes(params, xf, delta):
    """(x_r, x_k, x_v, x_g, w) of the Finch block: the five mixing LoRAs
    and the decay LoRA, in float32."""
    xxx = xf + delta * params["maa_x"]
    m = torch.tanh(torch.einsum("bsd,dr->bsr", xxx,
                                params["maa_w1"].float()))
    m = torch.einsum("bsir,ird->bsid", split_heads(m, 5, FINCH_MIX_RANK),
                     params["maa_w2"].float())
    xw, xk, xv, xr, xg = (xf + delta * (params["maa"][i] + m[:, :, i])
                          for i in range(5))
    dec = torch.tanh(torch.einsum("bsd,dr->bsr", xw,
                                  params["decay_w1"].float()))
    dec = torch.einsum("bsr,rd->bsd", dec, params["decay_w2"].float())
    return xr, xk, xv, xg, torch.exp(-torch.exp(params["decay"] + dec))


def rwkv_mixer(params, x, cfg: ModelConfig, state: dict | None = None):
    """RWKV-6 time-mix of ``cfg.rwkv_block``. x: [B, S, D]."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    xf = x.float()
    # the token shift and the mixes: a ``model.ddlerp`` span while spans
    # are made, its backward an interval from the last of the five
    # outputs' gradients to x's
    with tel.span("model.ddlerp"):
        x_prev = _shifted(xf, None if state is None else state["x_prev"])
        mixes = (_finch_mixes if cfg.rwkv_block == "finch"
                 else _simplified_mixes)
        xr, xk, xv, xg, w = mixes(params, xf, x_prev - xf)
    if tel.recording():
        trace_backward("model.ddlerp.backward", (xr, xk, xv, xg, w), x)

    r = torch.einsum("bsd,de->bse", xr, params["wr"].float())
    k = torch.einsum("bsd,de->bse", xk, params["wk"].float())
    v = torch.einsum("bsd,de->bse", xv, params["wv"].float())
    g = F.silu(torch.einsum("bsd,de->bse", xg, params["wg"].float()))

    hd = lambda a: split_heads(a, h, dh)
    u = params["u"].float().reshape(h, dh)
    s0 = state["s"] if state is not None else None
    y, s_new = _scan(hd(r), hd(k), hd(v), hd(w), u, s0)
    # group-norm per head (ln_x), then output gate
    yh = y.reshape(b, s, h, dh)
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True, correction=0) + GN_EPS[cfg.rwkv_block])
    y = merge_heads(yh) * params["ln_x"]
    if cfg.rwkv_block == "finch":
        y = y + params["ln_x_b"]
    y = y * g
    out = shard(einsum("bsd,de->bse", y.to(x.dtype), params["wo"]),
                "residual")
    if state is not None:
        return out, {"s": s_new, "x_prev": xf[:, -1]}
    return out


def init_rwkv_channel(key: InitKey, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.rwkv_block == "finch":
        mix = {"maa_k": init_full(key, (d,), 0.5),
               "maa_r": init_full(key, (d,), 0.5)}
    else:
        mix = {"mu_k": init_dense(key, (d,), scale=0.5, dtype="float32"),
               "mu_r": init_dense(key, (d,), scale=0.5, dtype="float32")}
    return {**mix,
            "wk": init_dense(key, (d, f), dtype=cfg.dtype),
            "wv": init_dense(key, (f, d), dtype=cfg.dtype),
            "wr": init_dense(key, (d, d), dtype=cfg.dtype)}


def rwkv_channel_mix(params, x, cfg: ModelConfig,
                     x_prev: torch.Tensor | None = None):
    """RWKV channel-mix ("FFN") with token shift. x: [B, S, D]. While
    spans are made, inside a ``model.channel_mix`` span, its backward a
    ``model.channel_mix.backward`` interval (x is read by it alone)."""
    with tel.span("model.channel_mix"):
        xf = x.float()
        delta = _shifted(xf, x_prev) - xf
        if cfg.rwkv_block == "finch":
            xk = xf + delta * params["maa_k"]
            xr = xf + delta * params["maa_r"]
        else:
            xk = xf + delta * torch.sigmoid(params["mu_k"])
            xr = xf + delta * torch.sigmoid(params["mu_r"])
        kk = einsum("bsd,df->bsf", xk.to(x.dtype), params["wk"])
        kk = torch.square(torch.relu(kk.float())).to(x.dtype)
        vv = einsum("bsf,fd->bsd", kk, params["wv"])
        rr = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                        params["wr"].float()))
        out = shard(rr.to(x.dtype) * vv, "residual")
    if tel.recording():
        trace_backward("model.channel_mix.backward", out, x)
    if x_prev is not None:
        return out, xf[:, -1]
    return out
