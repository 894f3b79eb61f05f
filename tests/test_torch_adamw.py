"""The AdamW kernels (``csrc/adamw.cu``) behind ``kernels.optim``, and the
contract ``optim.adamw_update`` keeps on the card.

On the CPU: the wrappers run the plain version (``kernels.optim.ref``),
``adamw_update`` writing its results over its inputs as the kernel does;
on meta tensors the step is in place and allocates what the kernels do;
their refusals; the wrapper's leaves a launch are the kernel's.

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_adamw.py`` there): for each (parameter, gradient) dtype
pair, leaves of ragged sizes (1, 7, 8 k + 3, past a chunk, an unaligned
view) and more leaves than one launch takes, ``optim.adamw_update`` hands
back the tensors it was given, updated in place, equal bit for bit to the
plain version given the kernel's clip scale; the norm within 1e-6 of a
float64 sum and the same on every run; one ``kernel`` call and the launches
counted. Through DTensors on two gloo ranks sharing the card, the kernels
update each rank's blocks in place, within 1e-6 of the kernels on the
whole leaves (one bf16 step for the bf16 parameter).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch import _tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import optim as kopt
from repro_torch.kernels.optim import ref as kref
from repro_torch.launch.mesh import spawn
from repro_torch.optim import (AdamWConfig, adamw_update, reset_update_paths,
                               update_paths)

import _optim_ranks as optim_ranks

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "adamw.cu")
CFG = AdamWConfig(lr=1e-2, warmup=1, clip_norm=0.5, weight_decay=0.1)
PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
         (torch.bfloat16, torch.float32)]
SIZES = (1, 7, 8 * 37 + 3, 2 * 16384 + 5, 100_003)


@pytest.fixture
def card():
    """The CUDA device, for tests marked ``card``; they skip without one
    (decided when the test runs, never while modules are imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _leaves(sizes, p_dtype, g_dtype, seed, device="cpu"):
    """Lists (p, g, m, v) of leaves of ``sizes`` elements: p ~ N(0, 0.02),
    g ~ N(0, 1e-3), m ~ N(0, 1e-4), v = N(0, 1e-3)^2."""
    gen = torch.Generator().manual_seed(seed)
    draw = lambda n, s, dtype: (torch.randn(n, generator=gen) * s).to(dtype)
    p = [draw(n, 0.02, p_dtype) for n in sizes]
    g = [draw(n, 1e-3, g_dtype) for n in sizes]
    m = [draw(n, 1e-4, torch.float32) for n in sizes]
    v = [draw(n, 1e-3, torch.float32) ** 2 for n in sizes]
    return tuple([t.to(device) for t in ts] for ts in (p, g, m, v))


def _schedule(step: int, device):
    t = torch.tensor(float(step), device=device)
    return (CFG.lr * torch.clamp_max(t / CFG.warmup, 1.0),
            1.0 - CFG.b1 ** t, 1.0 - CFG.b2 ** t)


@pytest.mark.parametrize("p_dtype,g_dtype", PAIRS)
def test_wrappers_on_cpu_write_the_plain_version_in_place(p_dtype, g_dtype):
    p, g, m, v = _leaves(SIZES[:4], p_dtype, g_dtype, seed=1)
    scale, gn = kopt.adamw_norm(g, CFG.clip_norm)
    want_scale, want_gn = kref.clip_scale(g, CFG.clip_norm)
    assert torch.equal(scale, want_scale) and torch.equal(gn, want_gn)
    lr, b1c, b2c = _schedule(3, "cpu")
    want = [kref.adamw_leaf(*leaf, scale, lr, b1c, b2c, CFG)
            for leaf in zip(p, g, m, v)]
    ptrs = [t.data_ptr() for t in p + m + v]
    kopt.adamw_update(p, g, m, v, scale, lr, b1c, b2c, CFG)
    assert [t.data_ptr() for t in p + m + v] == ptrs
    for got, new in zip(zip(p, m, v), want):
        for a, b in zip(got, new):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _refusal(case: str):
    p, g, m, v = _leaves((8, 8), torch.float32, torch.float32, seed=2)
    if case == "f16 parameter":
        p[0] = p[0].half()
    elif case == "f16 gradient":
        g[1] = g[1].half()
    elif case == "f64 moment":
        v[0] = v[0].double()
    elif case == "shapes":
        m[1] = m[1].reshape(2, 4)
    elif case == "strided parameter":
        p[0] = torch.zeros(16)[::2]
    elif case == "lengths":
        v = v[:1]
    elif case == "no leaves":
        p = g = m = v = []
    return p, g, m, v


@pytest.mark.parametrize("case,error", [
    ("f16 parameter", TypeError), ("f16 gradient", TypeError),
    ("f64 moment", TypeError), ("shapes", ValueError),
    ("strided parameter", ValueError), ("lengths", ValueError),
    ("no leaves", ValueError)])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, error):
    p, g, m, v = _refusal(case)
    lr, b1c, b2c = _schedule(1, "cpu")
    with pytest.raises(error):
        kopt.adamw_update(p, g, m, v, torch.tensor(1.0), lr, b1c, b2c, CFG)


def test_step_on_meta_tensors_allocates_what_the_kernels_do():
    """A dry run's meta leaves are updated in place, as the card's: the
    step hands back the tensors it was given and makes no storage beyond
    the norm's partial sums and its two numbers (and the step's scalars)."""
    from repro_torch.analysis.opcount import OpCounter
    meta = lambda ts: [t.to("meta") for t in ts]
    p, g, m, v = (meta(ts) for ts in _leaves((4096, 7, 100_003),
                                             torch.bfloat16, torch.float32,
                                             seed=4))
    state = {"m": m, "v": v,
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    reset_update_paths()
    with OpCounter() as counter:
        got_p, got_s, _ = adamw_update(p, g, state, CFG)
    assert update_paths() == {"kernel": 0, "plain": 1, "dtensor": 0}
    assert all(a is b for a, b in zip(got_p + got_s["m"] + got_s["v"],
                                      p + m + v))
    assert counter.peak_bytes < 256


def test_wrappers_leaves_a_launch_are_the_kernels():
    found = re.search(r"constexpr int kMaxLeaves = (\d+);", CU.read_text())
    assert found and int(found[1]) == kopt.MAX_LEAVES


# ------------------------------------------------------------------ card
@pytest.mark.card
@pytest.mark.parametrize("p_dtype,g_dtype", PAIRS)
@pytest.mark.parametrize("n_extra", [0, 50])
def test_kernels_update_in_place_bit_for_bit_on_the_card(card, p_dtype,
                                                         g_dtype, n_extra):
    sizes = SIZES + tuple(range(1, 8 * n_extra, 8))[:n_extra]
    p, g, m, v = _leaves(sizes, p_dtype, g_dtype, seed=3, device=card)
    # a parameter one element past a 16-byte boundary: the scalar path
    p.append((torch.randn(1001, device=card) * 0.02).to(p_dtype)[1:])
    g.append((torch.randn(1000, device=card) * 1e-3).to(g_dtype))
    m.append(torch.zeros(1000, device=card))
    v.append(torch.full((1000,), 1e-6, device=card))
    scale, gn = kopt.adamw_norm(g, CFG.clip_norm)
    scale2, gn2 = kopt.adamw_norm(g, CFG.clip_norm)
    assert torch.equal(gn, gn2) and torch.equal(scale, scale2)
    want_gn = sum(float(t.double().square().sum()) for t in g) ** 0.5
    assert abs(float(gn) - want_gn) <= 1e-6 * want_gn
    lr, b1c, b2c = _schedule(3, card)
    want = [kref.adamw_leaf(*leaf, scale, lr, b1c, b2c, CFG)
            for leaf in zip(p, g, m, v)]
    params, state = {"p": p}, {"m": {"p": m}, "v": {"p": v},
                               "step": torch.tensor(2, dtype=torch.int32,
                                                    device=card)}
    ptrs = [t.data_ptr() for t in p + m + v]
    reset_update_paths()
    reset_launch_counts()
    got_p, got_s, got_gn = adamw_update(params, {"p": g}, state, CFG)
    torch.cuda.synchronize()
    groups = -(-len(g) // kopt.MAX_LEAVES)
    counts = launch_counts()
    assert update_paths() == {"kernel": 1, "plain": 0, "dtensor": 0}
    assert counts["adamw_norm"] == groups + 1
    assert counts["adamw_update"] == groups
    assert got_p is params and got_s["m"] is state["m"]
    assert got_s["v"] is state["v"] and int(got_s["step"]) == 3
    assert torch.equal(got_gn, gn)
    assert [t.data_ptr() for t in _tree.leaves(
        (got_p, got_s["m"], got_s["v"]))] == ptrs
    for got, new in zip(zip(p, m, v), want):
        for a, b in zip(got, new):
            assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_kernels_update_dtensor_blocks_in_place_on_the_card(card, shape,
                                                            tmp_path):
    res = spawn(optim_ranks.dtensor_step, 2,
                (str(tmp_path / "rendezvous"), shape, "cuda:0"),
                deadline=300.0)
    for r in res:
        assert r["paths"] == {"kernel": 0, "plain": 0, "dtensor": 1}
        assert r["seen"]["norm"][1] and r["same_storage"] and r["step"] == 1
        assert r["gn"][0] == pytest.approx(r["gn"][1], rel=1e-6)
        # leaves b, u, w of p, then of m and v; w's parameter is bf16
        assert r["errs"][2] <= 2 ** -8
        assert max(r["errs"][:2] + r["errs"][3:]) <= 1e-6
