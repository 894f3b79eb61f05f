"""The two scan kernels' order of work, emulated in plain PyTorch on the
CPU and held to the plain loops (``kernels.recurrence.ref``) and to the
reference's recurrences (``_rwkv_inner``, ``jax.lax.associative_scan``).

The kernels run only on the card; these emulations walk their
decomposition step for step, with their constants read from the sources
(``csrc/wkv6_scan.cu``, ``csrc/rglru_scan.cu``):

* ``wkv6_scan`` forward: the state split into 16-column slabs of 16 row
  groups; each thread's sum over its rows as a chain of fused
  multiply-adds, a pairwise tree over a warp's 8 groups, then the two
  warps; the bonus term ``v_j sum(r u k)`` apart (16 lanes' partial sums
  added as a tree); a checkpoint every ``CHUNK`` steps.
* ``wkv6_scan`` backward: the chunks in reverse, each chunk's states
  recomputed from its checkpoint (a pass forward keeping every fourth
  state, then 4-step pieces walked back); 16-row slabs, dr / dk / dw
  summed over a thread's columns, a tree over a warp's 4 column groups,
  then the two warps; dv's column sums over a thread's two rows, a tree
  over the slab's 8 row pairs, the slab's ``dy sum(r u k)`` added, then
  the slabs in order.
* ``rglru_scan``: 16-step tiles through a ring of slots filled ahead of
  the walk (9 tiles ahead in the forward, 6 in the backward), the
  backward's tiles in reverse with h shifted by one step.

Final states (and every RG-LRU state) ``torch.equal`` to the plain loop;
y within rtol 1e-5 + 1e-5 max|y|; gradients within 1e-4 of max|g_ref|
(K3's tolerances on the card), over Dh 16 / 32 / 64, S = 1, S a
multiple of the chunk and not, and zero and nonzero initial states.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jx_rec
from repro_torch.kernels.recurrence import (CHUNK, rglru_scan_backward_ref,
                                            rglru_scan_ref,
                                            wkv6_scan_backward_ref,
                                            wkv6_scan_ref)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


K_CHUNK = _constant("wkv6_scan.cu", "kChunk")
K_SUB = _constant("wkv6_scan.cu", "kSub")
K_SLAB = _constant("wkv6_scan.cu", "kSlab")
K_WARPS = _constant("wkv6_scan.cu", "kThreads") // 32
K_T = _constant("rglru_scan.cu", "kT")
FWD_STAGES = _constant("rglru_scan.cu", "kFwdStages")
BWD_STAGES = _constant("rglru_scan.cu", "kBwdStages")


def fma(a, b, c):
    """``fmaf``: a * b + c rounded once (a float32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def tree_sum(x, dim: int):
    """The sum over ``dim`` (a power of two long) as a shuffle butterfly
    adds it: neighbours first, then pairs of pairs."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def chain(terms_a, terms_b, dim: int, start=None):
    """A fused multiply-add chain over ``dim`` in order, from 0."""
    a, b = terms_a.movedim(dim, 0), terms_b.movedim(dim, 0)
    acc = torch.zeros_like(a[0]) if start is None else start
    for i in range(a.shape[0]):
        acc = fma(a[i], b[i], acc)
    return acc


# ---------------------------------------------------------------- RWKV-6
def wkv6_forward_emulated(r, k, v, w, u, s0, save: bool):
    """``wkv6_forward``'s order of work. Returns (y, S, checkpoints)."""
    b, s, h, d = r.shape
    groups, rows = 16, d // 16
    st = s0.clone()
    ys, ckpt = [], []
    for t in range(s):
        if save and t % K_CHUNK == 0:
            ckpt.append(st.clone())
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        # thread (group, column): its rows' r_i S[i][j] as a chain in row
        # order; then a tree over the 8 groups of a warp; then the warps
        sg = st.reshape(b, h, groups, rows, d)
        rg = rt.reshape(b, h, groups, rows)
        acc = chain(rg[..., None].expand_as(sg), sg, dim=3)  # [b,h,16,d]
        warps = tree_sum(acc.reshape(b, h, K_WARPS, 8, d), 3)
        tot = warps[:, :, 0] + warps[:, :, 1]
        # r u k: lane j of half a warp sums rows j Dh/16 .. as a chain,
        # then the 16 lanes as a tree
        ru = (rt * u).reshape(b, h, 16, d // 16)
        ruk = tree_sum(chain(ru, kt.reshape(b, h, 16, d // 16), dim=3), 2)
        ys.append(fma(vt, ruk[..., None], tot))
        st = wt[..., None] * st + kt[..., :, None] * vt[..., None, :]
    ck = (torch.stack(ckpt, dim=2) if ckpt else
          s0.new_empty((b, h, 0, d, d)))
    return torch.stack(ys, dim=1), st, ck


def wkv6_backward_emulated(r, k, v, w, u, ckpt, dy, ds):
    """``wkv6_backward``'s order of work from the forward's checkpoints.
    Returns (dr, dk, dv, dw, du, dS0)."""
    b, s, h, d = r.shape
    slabs, cc = d // K_SLAB, d // 8
    nc = -(-s // K_CHUNK)
    assert ckpt.shape[2] == nc
    g = ds.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((K_SUB, b, h, d))     # a thread's du, per step slot
    step = lambda st, t: (w[:, t, ..., None] * st
                          + k[:, t, ..., :, None] * v[:, t, ..., None, :])

    def rows_sum(x, y):
        """A row's sum of x * y over the columns: a chain over a thread's
        cc columns, a tree over a warp's 4 column groups, then the two
        warps."""
        part = chain(x.reshape(*x.shape[:-1], K_WARPS, 4, cc),
                     y.reshape(*y.shape[:-1], K_WARPS, 4, cc), -1)
        part = tree_sum(part, -1)
        return part[..., 0] + part[..., 1]

    for c in range(nc - 1, -1, -1):
        t0 = c * K_CHUNK
        length = min(K_CHUNK, s - t0)
        pieces = -(-length // K_SUB)
        # per step: v . dy (4 lanes, a chain each, then a tree); the
        # slab's sum(r u k) (rows 4p .. 4p + 3 of lane p)
        vd = {t: tree_sum(chain(v[:, t].reshape(b, h, 4, d // 4),
                                dy[:, t].reshape(b, h, 4, d // 4), 3), 2)
              for t in range(t0, t0 + length)}
        ruk = {t: tree_sum(chain((r[:, t] * u).reshape(b, h, slabs, 4, 4),
                                 k[:, t].reshape(b, h, slabs, 4, 4), 4), 3)
               for t in range(t0, t0 + length)}
        # pass A: the states at the pieces' starts
        starts = [ckpt[:, :, c]]
        st = ckpt[:, :, c]
        for x in range((pieces - 1) * K_SUB):
            st = step(st, t0 + x)
            if (x + 1) % K_SUB == 0:
                starts.append(st)
        for m in range(pieces - 1, -1, -1):
            p0 = t0 + m * K_SUB
            plen = min(K_SUB, t0 + length - p0)
            ring = [starts[m]]
            for x in range(1, plen):
                ring.append(step(ring[-1], p0 + x - 1))
            for x in range(plen - 1, -1, -1):
                t = p0 + x
                prev = ring[x]
                rt, kt, wt, dyt, vt = (a[:, t] for a in (r, k, w, dy, v))
                full = lambda vec: vec[..., None, :].expand_as(prev)
                drs = rows_sum(prev, full(dyt))
                dks = rows_sum(g, full(vt))
                dws = rows_sum(g, prev)
                # a thread's two rows, then a tree over a slab's 8 pairs
                gk = g.reshape(b, h, slabs, 8, 2, d)
                kp = kt.reshape(b, h, slabs, 8, 2, 1)
                cs = fma(gk[:, :, :, :, 1], kp[:, :, :, :, 1],
                         gk[:, :, :, :, 0] * kp[:, :, :, :, 0])
                g = fma(wt[..., :, None], g,
                        rt[..., :, None] * dyt[..., None, :])
                dr[:, t] = fma(u * kt, vd[t][..., None], drs)
                dk[:, t] = fma(u * rt, vd[t][..., None], dks)
                dw[:, t] = dws
                du[x] = fma(rt * kt, vd[t][..., None], du[x])
                # dv: the slab's bonus added, then the slabs in order
                part = fma(dyt[:, :, None, :], ruk[t][..., None],
                           tree_sum(cs, 3))
                acc = part[:, :, 0]
                for q in range(1, slabs):
                    acc = acc + part[:, :, q]
                dv[:, t] = acc
    du = ((du[0] + du[1]) + du[2]) + du[3]
    return dr, dk, dv, dw, du.sum(0), g


def _wkv_inputs(rng, b, s, h, d, init):
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 1.0, (b, s, h, d)))).astype(
        np.float32)
    u = (rng.normal(size=(h, d)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) if init else np.zeros((b, h, d, d))
          ).astype(np.float32)
    return r, k, v, w, u, s0


def _close_rel(got, ref, rel: float, rtol: float = 0.0):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rel * (float(np.abs(ref).max()) or 1.0))


def test_the_emulations_read_the_kernels_constants():
    assert K_CHUNK == CHUNK
    assert (K_CHUNK % K_SUB, K_SUB, K_SLAB, K_WARPS) == (0, 4, 16, 2)
    assert K_T == 16 and FWD_STAGES > 1 and BWD_STAGES > 1


@pytest.mark.parametrize("init", [False, True], ids=["S0 zero", "S0 set"])
@pytest.mark.parametrize("s", [1, 16, 23, 40])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv6_kernel_order_matches_plain_loop_and_reference(d, s, init):
    rng = np.random.default_rng(1000 * d + 10 * s + init)
    xs = _wkv_inputs(rng, 2, s, 2, d, init)
    cy = rng.normal(size=(2, s, 2, d)).astype(np.float32)
    cs = rng.normal(size=(2, 2, d, d)).astype(np.float32)
    ts = [torch.from_numpy(x) for x in xs]
    y, st, ck = wkv6_forward_emulated(*ts, save=True)
    y_ref, st_ref, ck_ref = wkv6_scan_ref(*ts, CHUNK)
    assert torch.equal(st, st_ref)
    assert torch.equal(ck, ck_ref)
    assert ck.shape[2] == -(-s // CHUNK)
    top = float(y_ref.abs().max())
    assert bool(((y - y_ref).abs() <= 1e-5 * y_ref.abs() + 1e-5 * top).all())
    jy, js = jx_rec._rwkv_inner(None, *(jnp.asarray(x) for x in xs))
    _close_rel(y.numpy(), jy, 1e-5, rtol=1e-5)
    _close_rel(st.numpy(), js, 1e-5, rtol=1e-5)

    grads = wkv6_backward_emulated(*ts[:5], ck, torch.from_numpy(cy),
                                   torch.from_numpy(cs))
    plain = wkv6_scan_backward_ref(*ts, torch.from_numpy(cy),
                                   torch.from_numpy(cs))

    def loss(*x):
        yy, ss = jx_rec._rwkv_inner(None, *x)
        return jnp.sum(yy * cy) + jnp.sum(ss * cs)
    refs = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in xs))
    for got, p, want in zip(grads, plain, refs):
        assert got.shape == p.shape
        _close_rel(got.numpy(), p.numpy(), 1e-4)
        _close_rel(got.numpy(), want, 1e-4)


# ---------------------------------------------------------------- RG-LRU
def rglru_forward_emulated(a, g, h0):
    """``rglru_forward``: tile n lands in slot n % stages, issued stages -
    1 tiles ahead of the walk, which reads it back."""
    b, s, width = a.shape
    nt = -(-s // K_T)
    ra = torch.full((FWD_STAGES, K_T, b, width), float("nan"))
    rg = ra.clone()
    pending = set()

    def issue(n):
        if n < nt:
            slot = n % FWD_STAGES
            assert all(p % FWD_STAGES != slot for p in pending), "overwrite"
            for x in range(K_T):
                if n * K_T + x < s:
                    ra[slot, x], rg[slot, x] = a[:, n * K_T + x], \
                        g[:, n * K_T + x]
            pending.add(n)

    for n in range(FWD_STAGES - 1):
        issue(n)
    state, out = h0.clone(), torch.empty_like(a)
    for n in range(nt):
        issue(n + FWD_STAGES - 1)
        slot = n % FWD_STAGES
        for x in range(K_T):
            t = n * K_T + x
            if t < s:
                state = ra[slot, x] * state + rg[slot, x]
                out[:, t] = state
        pending.discard(n)
    return out


def rglru_backward_emulated(a, h, h0, dy):
    """``rglru_backward``: the tiles in reverse through the ring, h_{t-1}
    in row t of the h tile, h0 where t = 0."""
    b, s, width = a.shape
    nt = -(-s // K_T)
    ra = torch.full((BWD_STAGES, K_T, b, width), float("nan"))
    rd, rh = ra.clone(), ra.clone()
    pending = set()

    def issue(j):
        if j < nt:
            slot, t0 = j % BWD_STAGES, (nt - 1 - j) * K_T
            assert all(p % BWD_STAGES != slot for p in pending), "overwrite"
            for x in range(K_T):
                t = t0 + x
                if t < s:
                    ra[slot, x], rd[slot, x] = a[:, t], dy[:, t]
                    if t > 0:
                        rh[slot, x] = h[:, t - 1]
            pending.add(j)

    for j in range(BWD_STAGES - 1):
        issue(j)
    da, dg = torch.empty_like(a), torch.empty_like(a)
    carry = torch.zeros_like(h0)
    for j in range(nt):
        issue(j + BWD_STAGES - 1)
        slot, t0 = j % BWD_STAGES, (nt - 1 - j) * K_T
        for x in range(K_T - 1, -1, -1):
            t = t0 + x
            if t < s:
                dh = rd[slot, x] + carry
                da[:, t] = dh * (rh[slot, x] if t > 0 else h0)
                dg[:, t] = dh
                carry = ra[slot, x] * dh
        pending.discard(j)
    return da, dg, carry


def _jx_rglru(a, g, h0):
    def comb(lhs, rhs):
        a1, g1 = lhs
        a2, g2 = rhs
        return a1 * a2, g2 + a2 * g1
    g = g.at[:, 0].add(a[:, 0] * h0)
    return jax.lax.associative_scan(comb, (a, g), axis=1)[1]


@pytest.mark.parametrize("init", [False, True], ids=["h0 zero", "h0 set"])
@pytest.mark.parametrize("b, s, width", [(1, 1, 32), (2, 16, 64),
                                         (3, 37, 40), (1, 150, 32)])
def test_rglru_kernel_order_matches_plain_loop_and_reference(b, s, width,
                                                             init):
    rng = np.random.default_rng(s * 100 + width + init)
    a = rng.uniform(0.5, 1.0, (b, s, width)).astype(np.float32)
    g = rng.normal(size=(b, s, width)).astype(np.float32)
    h0 = (rng.normal(size=(b, width)) if init else np.zeros((b, width))
          ).astype(np.float32)
    cot = rng.normal(size=(b, s, width)).astype(np.float32)
    ta, tg, th, tc = (torch.from_numpy(x) for x in (a, g, h0, cot))
    h = rglru_forward_emulated(ta, tg, th)
    assert torch.equal(h, rglru_scan_ref(ta, tg, th))
    _close_rel(h.numpy(), _jx_rglru(jnp.asarray(a), jnp.asarray(g),
                                    jnp.asarray(h0)), 1e-5, rtol=1e-5)
    grads = rglru_backward_emulated(ta, h, th, tc)
    plain = rglru_scan_backward_ref(ta, h, th, tc)
    refs = jax.grad(lambda *x: jnp.sum(_jx_rglru(*x) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(g),
                                       jnp.asarray(h0))
    for got, p, want in zip(grads, plain, refs):
        assert torch.equal(got, p)
        _close_rel(got.numpy(), want, 1e-4)


# ---------------------------------------------------------------- fakes
@pytest.mark.parametrize("s", [1, CHUNK, CHUNK + 7, 4 * CHUNK])
def test_fake_implementations_at_the_kernels_chunk(s):
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, h, d = 2, 3, 64
    with FakeTensorMode():
        f = lambda *shape: torch.empty(shape)
        y, st, ck = torch.ops.repro_torch.wkv6_scan(
            *(f(b, s, h, d) for _ in range(4)), f(h, d), f(b, h, d, d),
            CHUNK)
        grads = torch.ops.repro_torch.wkv6_scan_backward(
            *(f(b, s, h, d) for _ in range(4)), f(h, d), ck, f(b, s, h, d),
            f(b, h, d, d), CHUNK)
        _, _, none = torch.ops.repro_torch.wkv6_scan(
            *(f(b, s, h, d) for _ in range(4)), f(h, d), f(b, h, d, d), 0)
    assert y.shape == (b, s, h, d) and st.shape == (b, h, d, d)
    assert ck.shape == (b, h, -(-s // CHUNK), d, d)
    assert none.shape == (b, h, 0, d, d)
    assert [tuple(g.shape) for g in grads] == [(b, s, h, d)] * 4 + [
        (h, d), (b, h, d, d)]


@pytest.mark.parametrize("width, offset", [(70, 0), (33, 0), (100, 0),
                                           (64, 1)],
                         ids=["W 70", "W 33", "W 100", "W 64 unaligned"])
def test_rglru_wrapper_layout_for_the_copy_engine(width, offset):
    """The wrapper hands the kernel W padded to a multiple of 4 and 16-byte
    aligned bases; the padded channels change no state or gradient of the
    others, and slicing them off gives the plain loop's arrays bit for
    bit."""
    from repro_torch.kernels.recurrence import ops
    b, s = 2, 19
    rng = np.random.default_rng(width + offset)

    def tensor(*shape, low=None):
        x = (rng.uniform(low, 1.0, shape) if low is not None
             else rng.normal(size=shape)).astype(np.float32)
        flat = torch.empty(x.size + offset)     # offset: a base 4 bytes on
        flat[offset:] = torch.from_numpy(x.ravel())
        return flat[offset:].view(shape)

    a, g, cot = tensor(b, s, width, low=0.5), tensor(b, s, width), \
        tensor(b, s, width)
    h0 = tensor(b, width)
    ta, tg, th0 = ops._tileable(a, g, h0)
    assert ta.shape[-1] % 4 == 0 and ta.shape[-1] - width < 4
    assert all(t.data_ptr() % 16 == 0 and t.is_contiguous()
               for t in (ta, tg, th0))
    h = ops._unpadded(rglru_scan_ref(ta, tg, th0), width)
    want = rglru_scan_ref(a, g, h0)
    assert h.is_contiguous() and torch.equal(h, want)
    padded = ops._tileable(a, want, h0, cot)
    got = [ops._unpadded(x, width)
           for x in rglru_scan_backward_ref(*padded)]
    for x, y in zip(got, rglru_scan_backward_ref(a, want, h0, cot)):
        assert x.is_contiguous() and torch.equal(x, y)


def _offset_view(x: np.ndarray, offset: int) -> torch.Tensor:
    """``x`` as a contiguous view ``flat[offset:]`` of a flat buffer: at
    offset 1 its base sits 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.size + offset)
    flat[offset:] = torch.from_numpy(x.ravel())
    return flat[offset:].view(x.shape)


@pytest.mark.parametrize("init", [False, True], ids=["S0 zero", "S0 set"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "4-byte offset"])
def test_wkv6_wrapper_layout_for_the_kernels_loads(offset, init):
    """The forward and backward wrappers hand their kernels every tensor
    contiguous at a 16-byte aligned base: S0, the checkpoints and dS too,
    which the kernels read with float4 loads. The plain loops on what the
    kernels are handed equal the plain loops on the originals bit for
    bit."""
    from repro_torch.kernels.recurrence import ops
    b, s, h, d = 2, CHUNK + 7, 3, 16
    rng = np.random.default_rng(7 + offset)
    r, k, v, w, u, s0 = (_offset_view(x, offset)
                         for x in _wkv_inputs(rng, b, s, h, d, init))
    if offset:
        assert s0.data_ptr() % 16 == 4 and r.data_ptr() % 16 == 4
    fwd = ops._wkv6_forward_args(r, k, v, w, u, s0, CHUNK)
    assert len(fwd) == 9 and all(
        t.is_contiguous() and t.data_ptr() % 16 == 0 for t in fwd)
    want = wkv6_scan_ref(r, k, v, w, u, s0, CHUNK)
    for x, y in zip(wkv6_scan_ref(*fwd[:6], CHUNK), want):
        assert torch.equal(x, y)

    ckpt = _offset_view(want[2].numpy(), offset)
    dy = _offset_view(rng.normal(size=(b, s, h, d)).astype(np.float32),
                      offset)
    ds = _offset_view(rng.normal(size=(b, h, d, d)).astype(np.float32),
                      offset)
    bwd = ops._wkv6_backward_args(r, k, v, w, u, ckpt, dy, ds)
    assert len(bwd) == 14 and all(
        t.is_contiguous() and t.data_ptr() % 16 == 0 for t in bwd)
    assert [tuple(t.shape) for t in bwd[8:]] == [(b, s, h, d)] * 4 + [
        (b, h, d), (b, h, d, d)]
    r_, k_, v_, w_, u_, ck_, dy_, ds_ = bwd[:8]
    got = wkv6_scan_backward_ref(r_, k_, v_, w_, u_, ck_[:, :, 0], dy_, ds_)
    for x, y in zip(got, wkv6_scan_backward_ref(r, k, v, w, u, ckpt[:, :, 0],
                                                dy, ds)):
        assert torch.equal(x, y)
