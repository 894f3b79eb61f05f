"""The flash-attention kernels (``csrc/flash_attention.cu``) and the rule
that sends ``chunked_attention`` to them (``kernels/attention``).

On the CPU:

* the wrapper's plain version (``kernels.attention.ref``: the kernels'
  tiles, online softmax, L, D from the float32 O, the three-term split
  products, the GQA sums for dK and dV, the skipped tiles) against the
  JAX reference's ``chunked_attention`` and ``jax.vjp``, and against
  autograd through the port's composed ``chunked_attention``, both on
  float32 copies of the same bf16 values, for out, dq, dk and dv, and L
  against a float64 log-sum-exp: causal with window 0 and with a window,
  G in {1, 2, 6}, head width 128, lengths that are no multiple of a tile,
  B > 1;
* the three-term bf16 split of float32 values sums back exactly;
* the control that rounds P and dS to bf16 lands farther from a float64
  result than the split does;
* the dispatch table: only bf16, head width 128, causal, canonical calls
  without ``k_valid`` take the kernel, and DTensors go to their local
  blocks first;
* the wrapper's refusals, the launch counters and the path counter;
* the plain version's tile sizes are the kernels' (read from the source).

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_flash_attention.py`` there): the kernels against a
float64 result and the composed path at both LM cells' layer shapes, a
window and G = 6; the control; the refusal on a CUDA tensor; the same
gradients on every run.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import attention as fa
from repro_torch.kernels.attention import ref as fa_ref
from repro_torch.models import attention as lm_attn
from repro_torch.models.attention import (attention_paths, chunked_attention,
                                          kernel_takes, reset_attention_paths)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "flash_attention.cu")


def _inputs(b, s, h, kv, seed, device="cpu", d=128):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(
            device)
    return draw(b, s, h, d), draw(b, s, kv, d), draw(b, s, kv, d), \
        draw(b, s, h, d)


def _positions(q):
    return torch.arange(q.shape[1], device=q.device)[None].expand(
        q.shape[0], -1)


@pytest.fixture
def card():
    """The CUDA device, for tests marked ``card``; they skip without one
    (decided when the test runs, never while modules are imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _composed(q, k, v, dout, window, chunk=64):
    """(O, dq, dk, dv) in float32: autograd through the composed path."""
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    pos = _positions(q)
    o = chunked_attention(qf, kf, vf, pos, pos, causal=True, window=window,
                          chunk=chunk, canonical=True)
    o.backward(dout.float())
    return o.detach(), qf.grad, kf.grad, vf.grad


def _jax(q, k, v, dout, window, chunk=64):
    """(O, dq, dk, dv) in float32 from the JAX reference's
    ``chunked_attention`` and ``jax.vjp`` on the same values (JAX is
    imported here: the card tests of this module run without it)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jx_attn
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    pos = jnp.broadcast_to(jnp.arange(q.shape[1], dtype=jnp.int32)[None],
                           (q.shape[0], q.shape[1]))

    def attend(q_, k_, v_):
        return jx_attn.chunked_attention(q_, k_, v_, pos, pos, causal=True,
                                         window=window, chunk=chunk,
                                         canonical=True)
    o, vjp = jax.vjp(attend, qj, kj, vj)
    grads = vjp(jnp.asarray(dout.float().numpy()))
    return tuple(torch.from_numpy(np.array(t)) for t in (o, *grads))


def _exact(q, k, v, dout, window):
    """(O, dq, dk, dv, L) in float64 over the whole score matrix."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    i = torch.arange(s, device=q.device)
    rel = i[:, None] - i[None, :]
    ok = (rel >= 0) & ((rel < window) if window else True)
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(g, 2))
    sc = torch.where(ok, sc * d ** -0.5, -torch.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                     vd.repeat_interleave(g, 2))
    o.backward(dout.double())
    lse = torch.logsumexp(sc, -1).permute(0, 2, 1)
    return o.detach(), qd.grad, kd.grad, vd.grad, lse.detach()


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


CASES = [   # (B, S, H, KV, window)
    (2, 150, 4, 2, 0),      # G 2, S no multiple of a tile, B > 1
    (2, 150, 4, 2, 37),     # a window
    (1, 200, 6, 6, 0),      # G 1
    (2, 100, 6, 1, 0),      # G 6
    (1, 190, 12, 2, 50),    # G 6 with a window
    (1, 300, 2, 1, 0),      # many key tiles
]


@pytest.mark.parametrize("b,s,h,kv,window", CASES,
                         ids=[f"B{c[0]}-S{c[1]}-H{c[2]}-KV{c[3]}-w{c[4]}"
                              for c in CASES])
def test_plain_version_matches_composed_autograd(b, s, h, kv, window):
    """Float32 tolerances: out, dq, dk, dv within 1e-5 of max|ref| of the
    JAX reference's ``chunked_attention`` and ``jax.vjp``, and of
    autograd through the port's composed path (float32 sums in other
    orders: 1e-7 to 1e-6 read); L within 1e-5 of max|L| of a float64
    log-sum-exp."""
    q, k, v, dout = _inputs(b, s, h, kv, seed=s + h)
    out, o32, lse = fa.flash_attention_forward_ref(q, k, v, window=window)
    dq, dk, dv = fa.flash_attention_backward_ref(q, k, v, o32, lse, dout,
                                                 window=window)
    for ref in (_jax(q, k, v, dout, window), _composed(q, k, v, dout,
                                                       window)):
        for name, got, want in zip(("out", "dq", "dk", "dv"),
                                   (o32, dq, dk, dv), ref):
            assert got.shape == want.shape, name
            assert _rel(got, want) < 1e-5, (name, _rel(got, want))
    assert torch.equal(out, o32.to(torch.bfloat16))
    lse_ref = _exact(q, k, v, dout, window)[4]
    assert _rel(lse, lse_ref) < 1e-5


def test_wrapper_runs_the_plain_version_under_autograd_on_cpu():
    """``flash_attention`` on CPU tensors: the plain version's out, and
    its float32 gradients rounded once to bf16; no kernel launch, and a
    ``chunked_attention`` call on the CPU is not counted by path."""
    reset_launch_counts()
    reset_attention_paths()
    q, k, v, dout = _inputs(2, 70, 4, 2, seed=3)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, window=20)
    out.backward(dout)
    want, o32, lse = fa.flash_attention_forward_ref(q, k, v, window=20)
    grads = fa.flash_attention_backward_ref(q, k, v, o32, lse, dout,
                                            window=20)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
    for got, g in zip((qg.grad, kg.grad, vg.grad), grads):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, g.to(torch.bfloat16))
    pos = _positions(q)
    chunked_attention(q, k, v, pos, pos, causal=True, window=0, chunk=32,
                      canonical=True)
    counts = launch_counts()
    assert counts["flash_attention_forward"] == 0
    assert counts["flash_attention_backward"] == 0
    assert attention_paths() == {"kernel": 0, "composed": 0}


SPLITS = {
    "random": lambda g: torch.randn(4096, generator=g)
    * torch.logspace(-20, 20, 4096),
    "near_one": lambda g: 1.0 + (torch.rand(4096, generator=g) - 0.5)
    * 2 ** -10,
    "tiny": lambda g: torch.rand(4096, generator=g) * 2.0 ** -100
    + 2.0 ** -109,
}


@pytest.mark.parametrize("kind", sorted(SPLITS))
def test_three_term_split_sums_back_exactly(kind):
    x = SPLITS[kind](torch.Generator().manual_seed(5)).float()
    hi, mid, lo = fa.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())


def test_control_lands_farther_from_float64_than_the_split():
    """Rounding P and dS to bf16 before their products (``terms=1``)
    moves the float32 results by about 1e-3 of their size; the split
    keeps them within float32 rounding: at least 20x closer here."""
    q, k, v, dout = _inputs(1, 200, 4, 2, seed=11)
    exact = _exact(q, k, v, dout, 0)
    errs = {}
    for terms in (3, 1):
        _, o32, lse = fa.flash_attention_forward_ref(q, k, v, terms=terms)
        grads = fa.flash_attention_backward_ref(q, k, v, o32, lse, dout,
                                                terms=terms)
        errs[terms] = [_rel(got, want)
                       for got, want in zip((o32, *grads), exact)]
    for split, control in zip(errs[3], errs[1]):
        assert control > 20 * split, errs


def _dtensor_like(t):
    """A tensor whose type is named DTensor, as ``_is_dtensor`` tests."""
    class DTensor(torch.Tensor):
        pass
    return t.as_subclass(DTensor)


def _path_of(q, k, v, *, causal, window, k_valid, canonical, monkeypatch):
    """The path ``chunked_attention`` gives the call: ``local`` (a DTensor,
    handed to its local blocks before anything else), else ``kernel`` or
    ``composed`` by ``kernel_takes``."""
    if type(q).__name__ == "DTensor":
        monkeypatch.setattr(lm_attn, "_local_heads",
                            lambda *a, **kw: "local")
        pos = torch.arange(q.shape[1])[None].expand(q.shape[0], -1)
        return chunked_attention(q, k, v, pos, pos, causal=causal,
                                 window=window, chunk=8, k_valid=k_valid,
                                 canonical=canonical)
    return "kernel" if kernel_takes(q, k, v, causal=causal, window=window,
                                    k_valid=k_valid,
                                    canonical=canonical) else "composed"


DISPATCH = {   # name -> (q, k, v dims, changes) ; True: the kernel takes it
    "gqa_128": ((128, 128, 128), {}, True),
    "window": ((128, 128, 128), {"window": 4096}, True),
    "danube_120": ((120, 120, 120), {}, False),
    "minicpm3_mla_96_64": ((96, 96, 64), {}, False),
    "deepseek_mla_192_128": ((192, 192, 128), {}, False),
    "local_256": ((256, 256, 256), {}, False),
    "not_causal": ((128, 128, 128), {"causal": False}, False),
    "k_valid": ((128, 128, 128), {"k_valid": True}, False),
    "not_canonical": ((128, 128, 128), {"canonical": False}, False),
    "float32": ((128, 128, 128), {"dtype": torch.float32}, False),
    "dtensor": ((128, 128, 128), {"dtensor": True}, False),
    "heads_not_a_multiple": ((128, 128, 128), {"kv": 3}, False),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_table(name, monkeypatch):
    (dq_, dk_, dv_), change, takes = DISPATCH[name]
    kv = change.get("kv", 2)
    dt = change.get("dtype", torch.bfloat16)
    q = torch.zeros((1, 8, 4, dq_), dtype=dt)
    k = torch.zeros((1, 8, kv, dk_), dtype=dt)
    v = torch.zeros((1, 8, kv, dv_), dtype=dt)
    if change.get("dtensor"):
        q, k, v = (_dtensor_like(t) for t in (q, k, v))
    k_valid = torch.ones((1, 8), dtype=torch.bool) \
        if change.get("k_valid") else None
    got = _path_of(q, k, v, causal=change.get("causal", True),
                   window=change.get("window", 0), k_valid=k_valid,
                   canonical=change.get("canonical", True),
                   monkeypatch=monkeypatch)
    want = "local" if change.get("dtensor") else \
        "kernel" if takes else "composed"
    assert got == want


REFUSED = {
    "head_width_120": (dict(d=120), ValueError),
    "float32": (dict(dtype=torch.float32), TypeError),
    "heads_not_a_multiple": (dict(kv=4), ValueError),
    "not_contiguous": (dict(transpose=True), ValueError),
    "negative_window": (dict(window=-1), ValueError),
    "terms_2": (dict(terms=2), ValueError),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    change, err = REFUSED[name]
    q, k, v, _ = _inputs(1, 16, 6, change.get("kv", 2), seed=1,
                         d=change.get("d", 128))
    if "dtype" in change:
        q, k, v = (t.to(change["dtype"]) for t in (q, k, v))
    if change.get("transpose"):
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        fa.flash_attention_forward(q, k, v, window=change.get("window", 0),
                                   terms=change.get("terms", 3))


def test_launch_counts_and_attention_paths_list_the_new_names(monkeypatch):
    """The two counters' names; ``attention_paths()`` counts the calls on
    CUDA tensors (a CPU tensor posing as one here, the kernel stubbed) and
    ``reset_attention_paths()`` clears it."""
    reset_launch_counts()
    reset_attention_paths()
    counts = launch_counts()
    assert counts["flash_attention_forward"] == 0
    assert counts["flash_attention_backward"] == 0
    assert attention_paths() == {"kernel": 0, "composed": 0}

    class Cuda(torch.Tensor):
        is_cuda = True
    monkeypatch.setattr(lm_attn, "flash_attention", lambda q, *a, **kw: q)
    for d, dtype in ((128, torch.bfloat16), (120, torch.bfloat16),
                     (128, torch.float32)):
        q, k, v, _ = _inputs(1, 8, 4, 2, seed=1, d=d)
        q, k, v = (t.to(dtype).as_subclass(Cuda) for t in (q, k, v))
        pos = _positions(q)
        chunked_attention(q, k, v, pos, pos, causal=True, window=0, chunk=8,
                          canonical=True)
    assert attention_paths() == {"kernel": 1, "composed": 2}
    reset_attention_paths()
    assert attention_paths() == {"kernel": 0, "composed": 0}


@pytest.mark.parametrize("name,constant", [
    ("FWD_ROWS", "kFwdRows"), ("FWD_KEYS", "kFwdKeys"),
    ("DQ_ROWS", "kDqRows"), ("DQ_KEYS", "kDqKeys"),
    ("BWD_KEYS", "kBwdKeys"), ("BWD_ROWS", "kBwdRows")])
def test_plain_version_tiles_are_the_kernels(name, constant):
    text = CU.read_text()
    found = re.search(rf"constexpr int {constant} = (\d+);", text)
    assert found and int(found[1]) == getattr(fa_ref, name)
    assert fa_ref.NEG_INF == float(re.search(
        r"constexpr float kNegInf = (-?[0-9.e]+)f;", text)[1])


# ------------------------------------------------------------------ card
CARD_SHAPES = [   # (B, S, H, KV, window): both cells' layers, more
    (1, 4096, 16, 8, 0),
    (4, 512, 16, 8, 0),
    (1, 4096, 16, 8, 1000),
    (2, 1000, 12, 2, 0),
]


def _bf16_steps(got, want) -> int:
    """Largest distance in bf16 steps between bf16 ``got`` and the bf16
    rounding of ``want``, over the elements with |want| at least 1/64 of
    max|want| (nearer zero a float32 sum's own rounding is more than a
    bf16 step of the element)."""
    def ordered(t):
        x = t.contiguous().view(torch.int16).int()
        return torch.where(x < 0, -(x & 0x7FFF), x)
    big = want.abs() >= want.abs().max() / 64
    dist = (ordered(got) - ordered(want.to(torch.bfloat16))).abs()
    return int(dist[big].max())


@pytest.mark.card
@pytest.mark.parametrize("b,s,h,kv,window", CARD_SHAPES,
                         ids=[f"B{c[0]}-S{c[1]}-H{c[2]}-KV{c[3]}-w{c[4]}"
                              for c in CARD_SHAPES])
def test_kernels_against_float64_and_the_composed_path(card, b, s, h, kv,
                                                       window):
    """bf16 out, dq, dk, dv within one bf16 step of the float64 result and
    of the composed float32 path (elements at least 1/64 of the largest);
    L within 1e-6 of max|L|; the float32 accumulators within 1e-4 of the
    float64 result (the tensor cores' sums over 8,192 rows read 5e-5),
    and the control at least 20x farther off; the backward the same bit
    for bit on a second run."""
    q, k, v, dout = _inputs(b, s, h, kv, seed=b + s + h + window,
                            device=card)
    res = {}
    for terms in (3, 1):
        out, o32, lse = fa.flash_attention_forward(q, k, v, window=window,
                                                   terms=terms)
        grads = fa.flash_attention_backward(q, k, v, o32, lse, dout,
                                            window=window, terms=terms,
                                            f32=True)
        res[terms] = (out, o32, lse, *grads)
    torch.cuda.synchronize()
    exact = _exact(q, k, v, dout, window)
    composed = _composed(q, k, v, dout, window, chunk=1024)
    out, o32, lse, dq, dk, dv, dq32, dk32, dv32 = res[3]
    assert torch.equal(out, o32.to(torch.bfloat16))
    for got, want, want32 in zip((out, dq, dk, dv), exact, composed):
        assert _bf16_steps(got, want) <= 1
        assert _bf16_steps(got, want32) <= 1
    assert float((lse - exact[4]).abs().max()
                 / exact[4].abs().max()) < 1e-6
    for i, want in zip((1, 6, 7, 8), exact):
        split, control = _rel(res[3][i], want), _rel(res[1][i], want)
        assert split < 1e-4 and control > 20 * split, (i, split, control)
    again = fa.flash_attention_backward(q, k, v, o32, lse, dout,
                                        window=window)
    assert all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv)))


@pytest.mark.card
def test_kernel_refuses_a_shape_it_does_not_take_on_the_card(card):
    q, k, v, _ = _inputs(1, 64, 4, 2, seed=2, device=card, d=120)
    with pytest.raises(ValueError):
        fa.flash_attention_forward(q, k, v)


@pytest.mark.card
def test_chunked_attention_takes_the_kernel_on_the_card(card):
    """The dispatch on CUDA tensors: the kernel for internlm2's layer
    (bf16, 128), the composed path for head width 120, each counted."""
    reset_launch_counts()
    reset_attention_paths()
    q, k, v, _ = _inputs(2, 256, 16, 8, seed=4, device=card)
    pos = _positions(q)
    got = chunked_attention(q, k, v, pos, pos, causal=True, window=0,
                            chunk=1024, canonical=True)
    want = fa.flash_attention(q, k, v)
    assert torch.equal(got, want)
    q2, k2, v2, _ = _inputs(2, 64, 4, 2, seed=4, device=card, d=120)
    chunked_attention(q2, k2, v2, _positions(q2), _positions(q2),
                      causal=True, window=0, chunk=1024, canonical=True)
    assert attention_paths() == {"kernel": 1, "composed": 1}
    assert launch_counts()["flash_attention_forward"] == 2
