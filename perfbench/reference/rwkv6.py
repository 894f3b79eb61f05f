"""Plain float32 RWKV-6 "Finch" layer [arXiv:2404.05892].

One pre-norm block, as RWKV-LM's ``RWKV_Tmix_x060`` and ``RWKV_CMix_x060``
compute it: LayerNorm, the time mix, residual add; LayerNorm, the channel
mix, residual add. With ``shift(x)`` the previous position's x (zero at the
first), xx = shift(x) - x and xxx = x + xx maa_x:

  time mix      x_i = x + xx (maa_i + tanh(xxx W1) W2_i), i in w, k, v, r, g
                r, k, v = x_r Wr, x_k Wk, x_v Wv; g = silu(x_g Wg)
                w = exp(-exp(decay + tanh(x_w D1) D2))
                y_t = r_t (S_{t-1} + (u k_t)^T v_t), S_t = diag(w_t) S_{t-1}
                      + k_t^T v_t, a head at a time (a plain loop over time)
                out = (GroupNorm_heads(y) gamma + beta) g Wo
  channel mix   x_k = x + xx maa_k, x_r = x + xx maa_r
                out = sigmoid(x_r Wr) (relu(x_k Wk)^2 Wv)

Products of activations and weights run through ``common.mm``, so the
control can round their operands; the recurrence stays float32.

Departures from the published model, each as the benchmarked program
defines it:
  * no ``ln0`` after the embedding;
  * a final RMS norm (``reference/train.py``'s and the program's skeleton)
    in place of the published ``ln_out`` LayerNorm;
  * the weights are random (``param_specs``), not the released ones, drawn
    at scales that keep the model in its working regime: the decays near
    0.87 (``decay`` -2), the mixing coefficients 0.5, the LoRAs' W2 at std
    0.01 (the published init's scale) and their W1 at fan-in, the key and
    gate matrices at a tenth of fan-in (the published init's gains 0.1),
    the other matrices at fan-in, the bonus ``u`` at
    std 0.5, LayerNorm and group-norm weights 1 and biases 0;
  * ``u`` is stored as [d] and read as [heads, head size].

The key and gate gains matter to the comparison: the first token's head
output is r (u k)^T v alone, one vector scaled, and the group norm's
gradient there turns on that scale, near its sign where the scale is
large against the eps. At full-scale keys rounding then moves every
gradient below it, and a full-scale gate carries that through all 32
layers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import mm, token_shift

MIX_RANK = 32       # RWKV-LM x060's LoRA ranks below a width of 4,096
DECAY_RANK = 64
MIXES = ("w", "k", "v", "r", "g")
GN_EPS = 6.4e-4     # the group norm's: 1e-5 x head_size_divisor 8 squared


def param_specs(m: dict) -> dict:
    """``{path: (shape, dtype, init)}`` of every parameter. The layers'
    parameters are stacked on a leading axis of ``n_layers`` under
    ``main.sub0``. ``init`` is ``("normal", std)`` or ``("const", v)``.
    Mixing coefficients, decays, the bonus and the norms are float32; the
    matrices are in the configuration's dtype."""
    d, f, v, n, wt = (m["d_model"], m["d_ff"], m["vocab"], m["n_layers"],
                      m["dtype"])
    const = lambda value, *shape: ((n,) + shape, "float32", ("const", value))
    normal = lambda std, *shape: ((n,) + shape, wt, ("normal", std))
    fan_in = lambda *shape: normal(shape[-2] ** -0.5, *shape)
    t, c = "main.sub0.mixer.", "main.sub0.ffn."
    return {
        "embed.tok": ((v, d), wt, ("normal", 1.0)),
        "embed.head": ((d, v), wt, ("normal", d ** -0.5)),
        "final_ln": ((d,), "float32", ("const", 0.0)),
        "main.sub0.ln1": const(1.0, d),
        "main.sub0.ln1_b": const(0.0, d),
        "main.sub0.ln2": const(1.0, d),
        "main.sub0.ln2_b": const(0.0, d),
        t + "maa_x": const(0.5, d),
        t + "maa": const(0.5, len(MIXES), d),
        t + "maa_w1": fan_in(d, len(MIXES) * MIX_RANK),
        t + "maa_w2": normal(0.01, len(MIXES), MIX_RANK, d),
        t + "decay": const(-2.0, d),
        t + "decay_w1": fan_in(d, DECAY_RANK),
        t + "decay_w2": normal(0.01, DECAY_RANK, d),
        t + "u": ((n, d), "float32", ("normal", 0.5)),
        t + "wr": fan_in(d, d),
        t + "wk": normal(0.1 * d ** -0.5, d, d),
        t + "wv": fan_in(d, d),
        t + "wg": normal(0.1 * d ** -0.5, d, d),
        t + "wo": fan_in(d, d),
        t + "ln_x": const(1.0, d),
        t + "ln_x_b": const(0.0, d),
        c + "maa_k": const(0.5, d),
        c + "maa_r": const(0.5, d),
        c + "wk": fan_in(d, f),
        c + "wv": fan_in(f, d),
        c + "wr": fan_in(d, d),
    }


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension (population variance)."""
    x = x - x.mean(-1, keepdim=True)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * weight + bias


def wkv(r, k, v, w, u) -> torch.Tensor:
    """The recurrence from a zero state, a step at a time over the
    sequence, batched over (batch, heads). r, k, v, w: [B, S, H, Dh];
    u: [H, Dh]. Returns y [B, S, H, Dh]."""
    b, s, h, dh = r.shape
    state = r.new_zeros((b, h, dh, dh))
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               state + u[:, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1)


def time_mix(L: dict, x: torch.Tensor, m: dict, prec: str) -> torch.Tensor:
    b, s, d = x.shape
    dh = m["rwkv_head_dim"]
    h = d // dh
    xx = token_shift(x) - x
    xxx = x + xx * L["mixer.maa_x"]
    lora = torch.tanh(mm("bsd,dr->bsr", xxx, L["mixer.maa_w1"], prec))
    lora = mm("bsir,ird->bsid", lora.reshape(b, s, len(MIXES), MIX_RANK),
              L["mixer.maa_w2"], prec)
    xw, xk, xv, xr, xg = (x + xx * (L["mixer.maa"][i] + lora[:, :, i])
                          for i in range(len(MIXES)))
    heads = lambda a: a.reshape(b, s, h, dh)
    r = heads(mm("bsd,de->bse", xr, L["mixer.wr"], prec))
    k = heads(mm("bsd,de->bse", xk, L["mixer.wk"], prec))
    v = heads(mm("bsd,de->bse", xv, L["mixer.wv"], prec))
    g = F.silu(mm("bsd,de->bse", xg, L["mixer.wg"], prec))
    dec = torch.tanh(mm("bsd,dr->bsr", xw, L["mixer.decay_w1"], prec))
    dec = mm("bsr,rd->bsd", dec, L["mixer.decay_w2"], prec)
    w = heads(torch.exp(-torch.exp(L["mixer.decay"] + dec)))
    y = wkv(r, k, v, w, L["mixer.u"].reshape(h, dh))
    y = y - y.mean(-1, keepdim=True)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True)
                        + GN_EPS)
    y = y.reshape(b, s, d) * L["mixer.ln_x"] + L["mixer.ln_x_b"]
    return mm("bsd,de->bse", y * g, L["mixer.wo"], prec)


def channel_mix(L: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    xx = token_shift(x) - x
    xk = x + xx * L["ffn.maa_k"]
    xr = x + xx * L["ffn.maa_r"]
    kk = torch.square(torch.relu(mm("bsd,df->bsf", xk, L["ffn.wk"], prec)))
    kv = mm("bsf,fd->bsd", kk, L["ffn.wv"], prec)
    return torch.sigmoid(mm("bsd,de->bse", xr, L["ffn.wr"], prec)) * kv


def block(L: dict, x: torch.Tensor, m: dict, prec: str) -> torch.Tensor:
    """One layer. ``L`` holds the layer's slice of every stacked
    parameter, keyed by its path under ``main.sub0.``."""
    eps = m["norm_eps"]
    x = x + time_mix(L, layer_norm(x, L["ln1"], L["ln1_b"], eps), m, prec)
    return x + channel_mix(L, layer_norm(x, L["ln2"], L["ln2_b"], eps), prec)
