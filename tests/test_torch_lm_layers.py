"""The LM stack's layers in the port against the JAX package's, on the
same numpy inputs and the reference's weights (``params_from_numpy``).

* ``chunked_attention`` over the cases of ``test_attention_chunked.py``
  (both mask modes) within rtol, atol 1e-5 of the reference and 2e-4 of
  the dense oracle; its gradients through the recomputed KV steps within
  1e-4 * max|ref|.
* ``rms_norm`` and (M-)RoPE within 1e-6 * max|ref| (f32).
* both gelu call sites (the dense FFN, the RG-LRU's gate branch), f32,
  within 1e-5 * max|ref|: the exact gelu is off by 3x that and more.
* ``moe_ffn`` / ``_route`` / ``_group_dispatch``: the routed ids equal,
  the dispatch maps and buffer equal, the dense oracle within the
  reference's 0.05 * max|ref| + 1e-3, capacity drops and the shared
  expert as ``test_moe_dispatch.py``; at f32 within 1e-5 * max|ref|.
* the RG-LRU and RWKV-6 mixers and the channel mix, full sequence and
  decode, f32: the RG-LRU within 1e-5 * max|ref| (the reference takes an
  associative scan, the port a loop; they differ by 1e-7 here), RWKV-6
  within 1e-4 (a head dim of 16 makes the population variance of the
  group norm count: the unbiased one is 3 % off).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.models import attention as jx_attn
from repro.models import common as jx_common
from repro.models import moe as jx_moe
from repro.models import recurrent as jx_rec
from repro.models.config import ModelConfig as JxModelConfig
from repro.models.config import MoEConfig as JxMoEConfig
from repro_torch.configs import get_config
from repro_torch.models import attention, common, moe, recurrent
from repro_torch.models import params_from_numpy
from repro_torch.models.config import ModelConfig, MoEConfig


def _t(a):
    return params_from_numpy(np.asarray(a), device="cpu")


def _close(got: torch.Tensor, ref, rel: float, rtol: float = 0.0):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=rel * (float(np.abs(ref).max()) or 1.0))


# ------------------------------------------------------------ attention
# (sq, h, kv_div, dk, chunk, causal, window, seed) from the reference
# test's hypothesis domain
ATTN_CASES = [(3, 2, 1, 4, 4, True, 0, 0), (9, 4, 2, 8, 4, True, 5, 1),
              (16, 6, 2, 4, 8, False, 0, 2), (33, 4, 1, 8, 16, True, 5, 3),
              (17, 6, 1, 4, 8, True, 0, 4), (24, 2, 2, 8, 16, False, 0, 5),
              (33, 6, 2, 8, 4, True, 5, 6), (5, 4, 2, 4, 16, True, 5, 7),
              (12, 4, 1, 8, 4, True, 5, 8), (31, 2, 1, 4, 8, True, 0, 9)]


def _dense_oracle(q, k, v, causal, window):
    b, sq, h, dk = q.shape
    kv = k.shape[2]
    g = h // kv
    s = np.einsum("bqkgd,bckd->bqkgc", q.reshape(b, sq, kv, g, dk), k) \
        * dk ** -0.5
    if causal:
        rel = np.arange(sq)[:, None] - np.arange(k.shape[1])[None, :]
        mask = rel >= 0
        if window:
            mask &= rel < window
        s = np.where(mask[None, :, None, None, :], s, jx_attn.NEG_INF)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bqkgc,bckd->bqkgd", p, v).reshape(b, sq, h, -1)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("canonical", [False, True])
def test_chunked_attention_matches_reference(case, canonical):
    sq, h, kv_div, dk, chunk, causal, window, seed = case
    kv, b = h // kv_div, 2
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, sq, kv, dk)).astype(np.float32)
    v = rng.normal(size=(b, sq, kv, dk)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32)[None], (b, sq))
    ref = jx_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=causal, window=window, chunk=chunk,
        canonical=canonical)
    got = attention.chunked_attention(
        _t(q), _t(k), _t(v), _t(pos), _t(pos), causal=causal, window=window,
        chunk=chunk, canonical=canonical)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               _dense_oracle(q, k, v, causal, window),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_gradients_match_reference(window):
    """Gradients through the KV steps recomputed in the backward pass."""
    rng = np.random.default_rng(0)
    b, s, h, dk = 1, 16, 2, 4
    q, k, v = (rng.normal(size=(b, s, h, dk)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))

    def jf(q, k, v):
        o = jx_attn.chunked_attention(q, k, v, jnp.asarray(pos),
                                      jnp.asarray(pos), causal=True,
                                      window=window, chunk=4, canonical=True)
        return jnp.sum(o ** 2)

    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = attention.chunked_attention(tq, tk, tv, _t(pos), _t(pos),
                                    causal=True, window=window, chunk=4,
                                    canonical=True)
    got = torch.autograd.grad(torch.sum(o ** 2), (tq, tk, tv))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
        _close(g, r, 1e-4)


# ------------------------------------------------------------ numerics
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 24)), jnp.dtype(dtype))
    scale = rng.normal(size=(24,)).astype(np.float32) * 0.1
    ref = jx_common.rms_norm(x, jnp.asarray(scale), 1e-5)
    got = common.rms_norm(_t(x), _t(scale), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, 1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("sections", [(), (2, 3, 3)])
def test_rope_matches_reference(sections):
    """Halves rotated (not interleaved pairs); M-RoPE with a distinct
    position per axis."""
    rng = np.random.default_rng(2)
    b, s, h, dh = 2, 7, 3, 16
    x = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    if sections:
        pos = rng.integers(0, 50, (3, b, s)).astype(np.int32)
    else:
        pos = rng.integers(0, 50, (b, s)).astype(np.int32)
    ref = jx_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                               sections)
    got = common.apply_rope(_t(x), _t(pos), 10000.0, sections)
    _close(got, ref, 1e-6)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _jx_cfg(cfg):
    """The reference's ModelConfig with the same fields."""
    from repro.configs import get_config as jx_get_config
    return dataclasses.replace(jx_get_config(
        {"whisper-smoke": "whisper-base", "rgemma-smoke": "recurrentgemma-9b",
         "rwkv6-smoke": "rwkv6-3b"}[cfg.name], smoke=True), dtype=cfg.dtype)


def _jx_init(fn, cfg, seed=0):
    params = fn(jax.random.key(seed), _jx_cfg(cfg))
    return params, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")


def test_ffn_gelu_is_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form: the port's dense gelu
    FFN matches the reference, and an exact gelu would not."""
    cfg = _f32(get_config("whisper-base", smoke=True))
    jp, tp = _jx_init(jx_common.init_ffn, cfg)
    x = np.random.default_rng(3).normal(size=(2, 6, cfg.d_model)) \
        .astype(np.float32) * 4
    ref = np.asarray(jx_common.ffn(jp, jnp.asarray(x), _jx_cfg(cfg)))
    _close(common.ffn(tp, _t(x), cfg), ref, 1e-5)
    exact = F.gelu(_t(x) @ tp["wi"]) @ tp["wo"]
    assert np.abs(exact.numpy() - ref).max() > 3e-5 * np.abs(ref).max()


# ------------------------------------------------------------ MoE
def _moe_cfgs(e=8, k=2, cap_f=8.0, d=32, f=16, shared=0, router="softmax",
              dtype="bfloat16"):
    kw = dict(name="t", n_layers=2, d_model=d, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab=64, dtype=dtype)
    mo = dict(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cap_f,
              n_shared=shared, router=router)
    return (JxModelConfig(moe=JxMoEConfig(**mo), **kw),
            ModelConfig(moe=MoEConfig(**mo), **kw))


def _moe_case(jcfg, b=2, s=16, seed=0):
    jp = jx_moe.init_moe(jax.random.key(seed), jcfg)
    x = jax.random.normal(jax.random.key(seed + 1), (b, s, jcfg.d_model),
                          jnp.float32).astype(jnp.dtype(jcfg.dtype))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, x, tp, _t(x)


def _moe_oracle(params, x2d, ids, gates, cfg):
    e_ff = cfg.moe.d_ff_expert
    wi = np.asarray(params["wi"], np.float32)
    wo = np.asarray(params["wo"], np.float32)
    xf = np.asarray(x2d, np.float32)
    out = np.zeros((xf.shape[0], cfg.d_model), np.float32)
    for t in range(xf.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(ids[t, j])
            h = xf[t] @ wi[e]
            gt, up = h[:e_ff], h[e_ff:]
            out[t] += float(gates[t, j]) * (
                (gt / (1 + np.exp(-gt))) * up @ wo[e])
    return out


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_matches_reference_and_dense_oracle(router):
    jcfg, tcfg = _moe_cfgs(router=router)
    jp, x, tp, tx = _moe_case(jcfg)
    d = jcfg.d_model
    jids, jgates = jx_moe._route(jp, x.reshape(-1, d), jcfg)
    ids, gates = moe._route(tp, tx.reshape(-1, d), tcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(gates, jgates, 1e-6, rtol=1e-6)
    ref, jaux = jx_moe.moe_ffn(jp, x, jcfg)
    out, aux = moe.moe_ffn(tp, tx, tcfg)
    assert out.dtype == torch.bfloat16 and float(aux["dropped_frac"]) == 0.0
    ref = np.asarray(ref, np.float32)
    _close(out, ref, 0.01)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(jaux["load_balance"]), rtol=1e-5)
    oracle = _moe_oracle(jp, x.reshape(-1, d), jids, jgates, jcfg)
    got = out.reshape(-1, d).float().numpy()
    np.testing.assert_allclose(got, oracle,
                               atol=0.05 * np.abs(oracle).max() + 1e-3)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_f32_matches_reference(shared, router):
    jcfg, tcfg = _moe_cfgs(router=router, shared=shared, cap_f=1.25,
                           dtype="float32")
    jp, x, tp, tx = _moe_case(jcfg, seed=shared)
    ref, jaux = jx_moe.moe_ffn(jp, x, jcfg)
    out, aux = moe.moe_ffn(tp, tx, tcfg)
    _close(out, ref, 1e-5)
    for key in ("load_balance", "dropped_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-5, atol=1e-7)


def test_moe_shared_expert_added():
    jcfg0, tcfg0 = _moe_cfgs(shared=0)
    jcfg1, tcfg1 = _moe_cfgs(shared=1)
    jp1, x, tp1, tx = _moe_case(jcfg1, b=1, s=8)
    ref1, _ = jx_moe.moe_ffn(jp1, x, jcfg1)
    out1, _ = moe.moe_ffn(tp1, tx, tcfg1)
    tp0 = {k: v for k, v in tp1.items() if not k.startswith("shared")}
    out0, _ = moe.moe_ffn(tp0, tx, tcfg0)
    _close(out1, ref1, 0.01)
    assert not torch.allclose(out0.float(), out1.float())


def test_moe_capacity_drops_match_reference():
    jcfg, tcfg = _moe_cfgs(e=2, k=1, cap_f=0.5)
    jp, x, tp, tx = _moe_case(jcfg, b=1, s=32)
    ref, jaux = jx_moe.moe_ffn(jp, x, jcfg)
    out, aux = moe.moe_ffn(tp, tx, tcfg)
    dropped = float(aux["dropped_frac"])
    assert 0.0 < dropped < 1.0
    assert dropped == pytest.approx(float(jaux["dropped_frac"]), abs=1e-7)
    _close(out, ref, 0.01)


# (s, e, k, seed) from test_dispatch_properties' domain
DISPATCH_CASES = [(4, 2, 1, 0), (7, 3, 2, 1), (16, 8, 3, 2), (32, 5, 2, 3),
                  (13, 8, 1, 4), (32, 2, 3, 5)]


@pytest.mark.parametrize("s,e,k,seed", DISPATCH_CASES)
def test_group_dispatch_matches_reference(s, e, k, seed):
    """The buffer and the slot maps equal the reference's; every kept slot
    lands in its expert's row; capacity respected; unfilled rows zero."""
    k = min(k, e)
    rng = np.random.default_rng(seed)
    d = 8
    x = rng.normal(size=(s, d)).astype(np.float32)
    ids = rng.integers(0, e, (s, k)).astype(np.int32)
    cap = max(int(2.0 * s * k / e), 1)
    jbuf, jmaps = jx_moe._group_dispatch(jnp.asarray(x), jnp.asarray(ids),
                                         e, cap)
    buf, maps = moe._group_dispatch(_t(x), _t(ids).long(), e, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for got, ref in zip(maps, jmaps):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    flat_ids, rank, keep = (m.numpy() for m in maps)
    for slot in range(s * k):
        if keep[slot]:
            np.testing.assert_array_equal(buf[flat_ids[slot], rank[slot]],
                                          x[slot // k])
    counts = np.bincount(flat_ids[keep], minlength=e)
    assert (counts <= cap).all()
    for ee in range(e):
        assert (buf[ee, counts[ee]:] == 0).all()


# ------------------------------------------------------------ recurrent
def _seq(cfg, b=2, s=9, seed=5):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def test_rglru_mixer_full_and_decode_match_reference():
    cfg = _f32(get_config("recurrentgemma-9b", smoke=True))
    jcfg = _jx_cfg(cfg)
    jp, tp = _jx_init(jx_rec.init_rglru, cfg)
    x = _seq(cfg)
    _close(recurrent.rglru_mixer(tp, _t(x), cfg),
           jx_rec.rglru_mixer(jp, jnp.asarray(x), jcfg), 1e-5)
    jst = jx_rec.init_rglru_state(jcfg, 2)
    tst = params_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for t in range(3):
        ry, jst = jx_rec.rglru_mixer(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     state=jst)
        y, tst = recurrent.rglru_mixer(tp, _t(x[:, t:t + 1]), cfg,
                                       state=tst)
        _close(y, ry, 1e-5)
        for key in ("h", "conv"):
            _close(tst[key], jst[key], 1e-5)


def test_rglru_gelu_branch_is_tanh_approximation(monkeypatch):
    """The RG-LRU's gate branch: with the exact gelu the mixer leaves the
    reference's tolerance."""
    cfg = _f32(get_config("recurrentgemma-9b", smoke=True))
    jp, tp = _jx_init(jx_rec.init_rglru, cfg)
    x = _seq(cfg) * 4
    ref = np.asarray(jx_rec.rglru_mixer(jp, jnp.asarray(x), _jx_cfg(cfg)))
    _close(recurrent.rglru_mixer(tp, _t(x), cfg), ref, 1e-5)
    monkeypatch.setattr(recurrent, "gelu", F.gelu)
    exact = recurrent.rglru_mixer(tp, _t(x), cfg).numpy()
    assert np.abs(exact - ref).max() > 3e-5 * np.abs(ref).max()


def test_rwkv_mixer_full_and_decode_match_reference():
    cfg = _f32(get_config("rwkv6-3b", smoke=True))
    jcfg = _jx_cfg(cfg)
    jp, tp = _jx_init(jx_rec.init_rwkv, cfg)
    x = _seq(cfg)
    _close(recurrent.rwkv_mixer(tp, _t(x), cfg),
           jx_rec.rwkv_mixer(jp, jnp.asarray(x), jcfg), 1e-4)
    jst = jx_rec.init_rwkv_state(jcfg, 2)
    tst = params_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for t in range(3):
        ry, jst = jx_rec.rwkv_mixer(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    state=jst)
        y, tst = recurrent.rwkv_mixer(tp, _t(x[:, t:t + 1]), cfg, state=tst)
        _close(y, ry, 1e-4)
        for key in ("s", "x_prev"):
            _close(tst[key], jst[key], 1e-4)


def test_rwkv_channel_mix_full_and_decode_match_reference():
    cfg = _f32(get_config("rwkv6-3b", smoke=True))
    jcfg = _jx_cfg(cfg)
    jp, tp = _jx_init(jx_rec.init_rwkv_channel, cfg)
    x = _seq(cfg)
    _close(recurrent.rwkv_channel_mix(tp, _t(x), cfg),
           jx_rec.rwkv_channel_mix(jp, jnp.asarray(x), jcfg), 1e-5)
    prev = np.zeros((2, cfg.d_model), np.float32)
    ry, rprev = jx_rec.rwkv_channel_mix(jp, jnp.asarray(x[:, :1]), jcfg,
                                        x_prev=jnp.asarray(prev))
    y, tprev = recurrent.rwkv_channel_mix(tp, _t(x[:, :1]), cfg,
                                          x_prev=_t(prev))
    _close(y, ry, 1e-5)
    _close(tprev, rprev, 0.0)
