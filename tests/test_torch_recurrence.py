"""The two sequence scans (``repro_torch.kernels.recurrence``) against the
reference's recurrences, on the CPU.

* ``rglru_scan`` (the custom op; on CPU tensors its plain version) against
  ``jax.lax.associative_scan`` of the reference's combine, and
  ``wkv6_scan`` against the reference's ``_rwkv_inner`` (``jax.lax.scan``):
  values within rtol 1e-5 (atol 1e-5 * max|ref|), the gradients of every
  input (the backward ops, against ``jax.grad``) within 1e-4 * max|g|,
  over a Hypothesis sweep of B, S (1-40), H and Dh (16, 32) from a zero
  and from a nonzero initial state; inputs drawn with numpy from a seed.
* ``rglru_mixer`` / ``rwkv_mixer`` at f32 (smoke widths), which reach the
  ops: values and the gradients of the input and every parameter against
  the reference's mixers under ``jax.grad``.
* The fake implementations' shapes and dtypes (under ``FakeTensorMode``),
  and a meta-tensor run under ``analysis.opcount.OpCounter``: one op a
  scan forward and one backward, whatever the length, charged the cost
  rule's FLOPs.
* The local-block path: smoke rwkv6-3b and recurrentgemma-9b training on
  1x2 and 2x1 meshes of gloo CPU ranks (``tests/_recurrence_ranks.py``)
  against one rank: losses within 1e-5 relative, parameters within 1e-4
  of each leaf's max|ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _recurrence_ranks as ranks
from _hyp import given, settings, st
from _lm_mesh_cases import spawn_ranks
from repro.models import recurrent as jx_rec
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import get_config
from repro_torch.kernels.recurrence import (CHUNK, rglru_scan, wkv6_scan)
from repro_torch.models import params_from_numpy, recurrent


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, ref, atol_rel: float, rtol: float = 0.0):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * (float(np.abs(ref).max())
                                                or 1.0))


# ---------------------------------------------------------------- RG-LRU
def _jx_rglru(a, g, h0):
    """The reference's associative scan; a nonzero h0 enters as
    a_0 * h0 added to g_0."""
    def comb(lhs, rhs):
        a1, g1 = lhs
        a2, g2 = rhs
        return a1 * a2, g2 + a2 * g1
    g = g.at[:, 0].add(a[:, 0] * h0)
    return jax.lax.associative_scan(comb, (a, g), axis=1)[1]


@settings(max_examples=12, deadline=None)
@given(b=st.integers(1, 3), s=st.integers(1, 40), w=st.sampled_from([8, 16]),
       init=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_rglru_scan_matches_associative_scan(b, s, w, init, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    g = rng.normal(size=(b, s, w)).astype(np.float32)
    h0 = (rng.normal(size=(b, w)) if init else np.zeros((b, w))
          ).astype(np.float32)
    cot = rng.normal(size=(b, s, w)).astype(np.float32)
    ref = _jx_rglru(jnp.asarray(a), jnp.asarray(g), jnp.asarray(h0))
    ta, tg, th = _t(a, True), _t(g, True), _t(h0, True)
    h = rglru_scan(ta, tg, th)
    _close(h, ref, 1e-5, rtol=1e-5)
    (h * _t(cot)).sum().backward()
    refs = jax.grad(lambda *x: jnp.sum(_jx_rglru(*x) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(g),
                                       jnp.asarray(h0))
    for got, want in zip((ta.grad, tg.grad, th.grad), refs):
        _close(got, want, 1e-4)


# ---------------------------------------------------------------- RWKV-6
def _wkv_inputs(rng, b, s, h, d, init):
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 1.0, (b, s, h, d)))).astype(
        np.float32)
    u = (rng.normal(size=(h, d)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) if init else np.zeros((b, h, d, d))
          ).astype(np.float32)
    return r, k, v, w, u, s0


@settings(max_examples=12, deadline=None)
@given(b=st.integers(1, 2), s=st.integers(1, 40), h=st.integers(1, 3),
       d=st.sampled_from([16, 32]), init=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_wkv6_scan_matches_rwkv_inner(b, s, h, d, init, seed):
    rng = np.random.default_rng(seed)
    xs = _wkv_inputs(rng, b, s, h, d, init)
    cy = rng.normal(size=(b, s, h, d)).astype(np.float32)
    cs = rng.normal(size=(b, h, d, d)).astype(np.float32)
    jxs = [jnp.asarray(x) for x in xs]
    y_ref, s_ref = jx_rec._rwkv_inner(None, *jxs)
    ts = [_t(x, True) for x in xs]
    y, s_out = wkv6_scan(*ts)
    _close(y, y_ref, 1e-5, rtol=1e-5)
    _close(s_out, s_ref, 1e-5, rtol=1e-5)
    ((y * _t(cy)).sum() + (s_out * _t(cs)).sum()).backward()

    def loss(*x):
        yy, ss = jx_rec._rwkv_inner(None, *x)
        return jnp.sum(yy * cy) + jnp.sum(ss * cs)
    refs = jax.grad(loss, argnums=tuple(range(6)))(*jxs)
    for t, want in zip(ts, refs):
        _close(t.grad, want, 1e-4)


def test_wkv6_scan_saves_states_only_for_a_gradient():
    rng = np.random.default_rng(0)
    xs = _wkv_inputs(rng, 1, 70, 2, 16, True)
    with OpCounter() as c:
        wkv6_scan(*(_t(x) for x in xs))
        ts = [_t(x, True) for x in xs]
        y, _ = wkv6_scan(*ts)
    outs = [row[4] for row in c.rows() if row[3] == "wkv6_scan"]
    assert outs[0].endswith("float32[1,2,0,16,16]")     # no gradient
    assert outs[1].endswith(f"float32[1,2,{-(-70 // CHUNK)},16,16]")


# ---------------------------------------------------------------- mixers
def _f32(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _jx_cfg(cfg):
    from repro.configs import get_config as jx_get_config
    name = {"rgemma-smoke": "recurrentgemma-9b",
            "rwkv6-smoke": "rwkv6-3b"}[cfg.name]
    return dataclasses.replace(jx_get_config(name, smoke=True),
                               dtype=cfg.dtype)


MIXERS = {"recurrentgemma-9b": (jx_rec.init_rglru, jx_rec.rglru_mixer,
                                recurrent.rglru_mixer, "rglru_scan"),
          "rwkv6-3b": (jx_rec.init_rwkv, jx_rec.rwkv_mixer,
                       recurrent.rwkv_mixer, "wkv6_scan")}


@pytest.mark.parametrize("arch", list(MIXERS))
def test_mixer_reaches_the_op_and_matches_reference_with_gradients(arch):
    init, jx_mixer, mixer, op = MIXERS[arch]
    cfg = _f32(arch)
    jcfg = _jx_cfg(cfg)
    jp = init(jax.random.key(0), jcfg)
    x = np.random.default_rng(5).normal(size=(2, 11, cfg.d_model)).astype(
        np.float32)
    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for leaf in tp.values():
        leaf.requires_grad_(True)
    tx = _t(x, True)
    with OpCounter() as c:
        out = mixer(tp, tx, cfg)
        (out * _t(cot)).sum().backward()
    runs = {row[3]: row[2] for row in c.rows()}
    assert runs[op] == 1 and runs[op + "_backward"] == 1

    def loss(p, xx):
        return jnp.sum(jx_mixer(p, xx, jcfg) * cot)
    ref = jx_mixer(jp, jnp.asarray(x), jcfg)
    _close(out, ref, 1e-4 if op == "wkv6_scan" else 1e-5)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    _close(tx.grad, gx, 1e-4)
    for name, leaf in tp.items():
        _close(leaf.grad, gp[name], 1e-4)


# ---------------------------------------------------------------- fake, meta
def test_fake_implementations_give_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, s, h, d, w = 2, 9, 3, 16, 8
    with FakeTensorMode():
        f = lambda *shape: torch.empty(shape)
        hs = torch.ops.repro_torch.rglru_scan(f(b, s, w), f(b, s, w),
                                              f(b, w))
        da, dg, dh0 = torch.ops.repro_torch.rglru_scan_backward(
            f(b, s, w), f(b, s, w), f(b, w), f(b, s, w))
        y, st_, ck = torch.ops.repro_torch.wkv6_scan(
            *(f(b, s, h, d) for _ in range(4)), f(h, d), f(b, h, d, d), 4)
        grads = torch.ops.repro_torch.wkv6_scan_backward(
            *(f(b, s, h, d) for _ in range(4)), f(h, d), ck, f(b, s, h, d),
            f(b, h, d, d), 4)
    assert hs.shape == da.shape == dg.shape == (b, s, w)
    assert dh0.shape == (b, w)
    assert y.shape == (b, s, h, d) and st_.shape == (b, h, d, d)
    assert ck.shape == (b, h, 3, d, d)
    assert [tuple(g.shape) for g in grads] == [(b, s, h, d)] * 4 + [
        (h, d), (b, h, d, d)]
    assert all(t.dtype == torch.float32
               for t in (hs, da, dh0, y, st_, ck, *grads))


@pytest.mark.parametrize("s", [64, 4096])
def test_meta_run_counts_one_op_a_scan_and_the_rule(s):
    b, h, d, w = 2, 4, 64, 32
    m = lambda *shape: torch.empty(shape, device="meta", requires_grad=True)
    with OpCounter() as c:
        y, st_ = wkv6_scan(m(b, s, h, d), m(b, s, h, d), m(b, s, h, d),
                           m(b, s, h, d), m(h, d),
                           torch.zeros((b, h, d, d), device="meta"))
        (y.sum() + st_.sum()).backward()
        rglru_scan(m(b, s, w), m(b, s, w)).sum().backward()
    rows = {row[3]: row for row in c.rows()}
    for op in ("wkv6_scan", "wkv6_scan_backward", "rglru_scan",
               "rglru_scan_backward"):
        assert rows[op][2] == 1, op
    step = b * h * d * d
    assert rows["wkv6_scan"][1] == 2.0 * s * step
    assert rows["wkv6_scan_backward"][1] == 6.0 * s * step
    assert rows["rglru_scan"][1] == rows["rglru_scan_backward"][1] == 0.0
    # the forward moves its operands and results once: r, k, v, w, u, S0
    # in; y, S, the checkpoints out
    nc = -(-s // CHUNK)
    assert rows["wkv6_scan"][0] == 4 * (5 * b * s * h * d + h * d
                                        + 2 * step + nc * step)


# ---------------------------------------------------------------- on a mesh
@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn_ranks(ranks.run_meshes, 2, tmp_path_factory, "scan_meshes",
                       [(1, 2), (2, 1)])[0]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_local_block_path_matches_one_rank(sharded, arch, mesh):
    losses, params = sharded[(arch, mesh)]
    want_l, want_p = ranks.one_rank(arch)
    np.testing.assert_allclose(losses, want_l, rtol=1e-5, atol=0)
    for g, r in zip(params, want_p):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())
