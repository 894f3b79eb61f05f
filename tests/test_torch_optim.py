"""The port's optimizer, compression, graph batches, checkpoints and trees
against the JAX package's.

Both sides take the same numpy inputs. AdamW over 5 steps of the same
gradients within rtol 1e-5, atol 1e-6 * max|ref| (``adamw_update`` and
the AdamW kernels' plain version, ``kernels.optim.ref``, alike); on the CPU
``adamw_update`` builds new trees and leaves its inputs as they were; CUDA
leaves (stubbed) go to the kernels and are handed back updated in place,
DTensors (on a mesh of gloo ranks) to the same wrappers as their local
blocks; the int8 compression,
the graph batches and the tree order equal the reference's exactly; a
checkpoint written by either package restores into the other.
"""
import json
import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import checkpoint as jx_ckpt
from repro.core import taxi as jx_taxi
from repro.core.graph import random_graph as jx_random_graph
from repro.data.graphs import graph_batches as jx_graph_batches
from repro.optim import AdamWConfig as JxAdamWConfig
from repro.optim import adamw_init as jx_adamw_init
from repro.optim import adamw_update as jx_adamw_update
from repro.optim import clip_by_global_norm as jx_clip
from repro.optim import int8_compress as jx_int8_compress
from repro.optim import int8_decompress as jx_int8_decompress
from repro_torch import _tree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import taxi
from repro_torch.core.graph import random_graph
from repro_torch.data import graph_batches
from repro_torch.kernels.optim import ref as adamw_ref
from repro_torch.launch.mesh import spawn
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, int8_compress,
                               int8_decompress, reset_update_paths,
                               update_paths)
from repro_torch.optim import adamw as pt_adamw

import _optim_ranks as optim_ranks

SEEDS = list(range(12))


def _np_tree(seed: int) -> dict:
    """A nested tree of float32 arrays: dict keys out of sorted order, a
    list, a tuple."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": f(5, 3), "b": [f(3), (f(2, 2), f(4))], "a": f(6)}


def _to_torch(tree):
    return _tree.tree_map(lambda a: torch.tensor(a), tree)


def _assert_tree_close(got, ref, rtol=1e-5, atol_rel=1e-6) -> None:
    flat_got, tdef = _tree.flatten(got)
    flat_ref, jdef = jax.tree.flatten(ref)
    assert str(tdef) == str(jdef)
    for g, r in zip(flat_got, flat_ref):
        r = np.asarray(r)
        assert g.dtype == getattr(torch, str(r.dtype))
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=atol_rel * float(np.abs(r).max()))


# ------------------------------------------------------------ trees
def test_tree_flatten_order_equals_jax():
    tree = {"b": {"w": 1, "step": 2}, "a": [3, (4,), None], "c": (5, 6),
            "d": None}
    leaves, tdef = _tree.flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    assert str(tdef) == str(jdef)
    back = tdef.unflatten(leaves)
    assert back == tree and list(back) == sorted(tree)
    assert _tree.tree_map(lambda x: 2 * x, tree) == jax.tree.map(
        lambda x: 2 * x, tree)
    with pytest.raises(ValueError):
        tdef.flatten_up_to({"a": 1})


def test_value_and_grad_leaves_inputs_detached():
    params = {"w": torch.tensor([2.0, -1.0]), "b": [torch.tensor(0.5)]}
    loss, grads = _tree.value_and_grad(
        lambda p, k: k * (p["w"] ** 2).sum() + p["b"][0], params, 3.0)
    assert float(loss) == 15.5 and not loss.requires_grad
    assert torch.equal(grads["w"], torch.tensor([12.0, -6.0]))
    assert float(grads["b"][0]) == 1.0
    assert not params["w"].requires_grad


# ------------------------------------------------------------ AdamW
@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1e-2, clip_norm=1e3, weight_decay=0.0, warmup=1),    # no clip
    dict(lr=1e-2, clip_norm=0.5, weight_decay=0.0, warmup=3),    # clipping
    dict(lr=3e-3, clip_norm=1.0, weight_decay=0.1, warmup=100),  # defaults
    dict(lr=5e-2, clip_norm=0.1, weight_decay=0.3, warmup=2),
], ids=["unclipped", "clipped-warmup", "decay", "clipped-decay"])
def test_adamw_update_matches_reference(cfg_kw):
    params_np = _np_tree(0)
    ref, got = params_np, _to_torch(params_np)
    st_jx, st = jx_adamw_init(ref), adamw_init(got)
    for step in range(5):
        g_np = jax.tree.map(lambda a: a * (step + 1), _np_tree(100 + step))
        ref, st_jx, gn_jx = jx_adamw_update(ref, g_np, st_jx,
                                            JxAdamWConfig(**cfg_kw))
        got, st, gn = adamw_update(got, _to_torch(g_np), st,
                                   AdamWConfig(**cfg_kw))
        np.testing.assert_allclose(float(gn), float(gn_jx), rtol=1e-6)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 5
    _assert_tree_close(got, ref)
    _assert_tree_close(st["m"], st_jx["m"])
    _assert_tree_close(st["v"], st_jx["v"])


def test_adamw_defaults_equal_reference():
    assert AdamWConfig().__dict__ == JxAdamWConfig().__dict__


@pytest.mark.parametrize("seed", SEEDS)
def test_clip_by_global_norm_contract(seed):
    rng = np.random.default_rng(seed)
    max_norm = float(rng.uniform(0.1, 10.0))
    g_np = jax.tree.map(lambda a: a * 10, _np_tree(seed))
    clipped, gn = clip_by_global_norm(_to_torch(g_np), max_norm)
    ref, gn_ref = jx_clip(g_np, max_norm)
    np.testing.assert_allclose(float(gn), float(gn_ref), rtol=1e-6)
    _assert_tree_close(clipped, ref, rtol=1e-6, atol_rel=0)
    cn = float(torch.sqrt(sum((x ** 2).sum() for x in _tree.leaves(clipped))))
    assert cn <= max_norm * 1.01
    small, _ = clip_by_global_norm(_to_torch(g_np), 1e6)   # untouched
    for x, y in zip(_tree.leaves(small), jax.tree.leaves(g_np)):
        np.testing.assert_array_equal(x.numpy(), y)


def test_adamw_step_counter_and_dtype():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state["step"].shape == () and state["step"].dtype == torch.int32
    g = {"w": torch.ones(4, dtype=torch.bfloat16)}
    params, state, _ = adamw_update(params, g, state, AdamWConfig())
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert params["w"].dtype == torch.bfloat16
    assert state["m"]["w"].dtype == torch.float32
    ref_p = {"w": jnp.zeros((4,), jnp.bfloat16)}
    ref_p, _, _ = jx_adamw_update(ref_p, {"w": jnp.ones((4,), jnp.bfloat16)},
                                  jx_adamw_init(ref_p), JxAdamWConfig())
    np.testing.assert_array_equal(params["w"].float().numpy(),
                                  np.asarray(ref_p["w"], np.float32))


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0, warmup=1)
    for _ in range(150):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]},
                                        state, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-3


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1e-2, clip_norm=1e3, weight_decay=0.0, warmup=1),
    dict(lr=5e-2, clip_norm=0.1, weight_decay=0.3, warmup=2),
], ids=["unclipped", "clipped-decay"])
def test_kernels_plain_version_matches_reference(cfg_kw):
    """``kernels.optim.ref``, the arithmetic the kernels repeat, step by
    step as ``adamw_update`` composes it, against the reference."""
    cfg = AdamWConfig(**cfg_kw)
    ref = _np_tree(0)
    flat, tdef = _tree.flatten(_to_torch(ref))
    st_jx = jx_adamw_init(ref)
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    for step in range(1, 6):
        g_np = jax.tree.map(lambda a: a * step, _np_tree(100 + step))
        ref, st_jx, gn_jx = jx_adamw_update(ref, g_np, st_jx,
                                            JxAdamWConfig(**cfg_kw))
        grads = _tree.leaves(_to_torch(g_np))
        scale, gn = adamw_ref.clip_scale(grads, cfg.clip_norm)
        t = torch.tensor(float(step))
        lr = cfg.lr * torch.clamp_max(t / max(cfg.warmup, 1), 1.0)
        out = [adamw_ref.adamw_leaf(p, g, mi, vi, scale, lr,
                                    1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t,
                                    cfg)
               for p, g, mi, vi in zip(flat, grads, m, v)]
        flat, m, v = ([o[i] for o in out] for i in range(3))
        np.testing.assert_allclose(float(gn), float(gn_jx), rtol=1e-6)
    _assert_tree_close(tdef.unflatten(flat), ref)
    _assert_tree_close(tdef.unflatten(m), st_jx["m"])
    _assert_tree_close(tdef.unflatten(v), st_jx["v"])


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_on_cpu_builds_new_trees(g_dtype):
    """On CPU tensors the step runs the plain version: new parameters and
    moments, its inputs as they were, one ``plain`` call counted."""
    params = {"w": torch.randn(4, 3).bfloat16(), "b": torch.randn(5)}
    grads = {k: torch.randn(p.shape).to(g_dtype) for k, p in params.items()}
    state = adamw_init(params)
    state["m"] = _tree.tree_map(torch.randn_like, state["m"])
    before = _tree.tree_map(torch.clone, (params, grads, state))
    reset_update_paths()
    new_p, new_s, _ = adamw_update(params, grads, state,
                                   AdamWConfig(lr=1e-2, warmup=1))
    assert update_paths() == {"kernel": 0, "plain": 1, "dtensor": 0}
    for a, b in zip(_tree.leaves((params, grads, state)),
                    _tree.leaves(before)):
        assert torch.equal(a, b)
    for new, old in zip(_tree.leaves((new_p, new_s["m"], new_s["v"])),
                        _tree.leaves((params, state["m"], state["v"]))):
        assert new is not old and new.data_ptr() != old.data_ptr()
        assert not torch.equal(new, old)
    assert int(new_s["step"]) == 1 and int(state["step"]) == 0


class _Cuda(torch.Tensor):
    is_cuda = True


@pytest.mark.parametrize("kind", ["cuda", "dtensor"])
def test_adamw_update_sends_leaves_by_kind(kind, monkeypatch,
                                           tmp_path_factory):
    """Plain CUDA leaves (CPU tensors posing as them, the kernels stubbed)
    go to the kernel wrappers, which get the flat leaves and the step's
    lr and bias corrections, and the same trees come back. DTensors (four
    gloo ranks on a 2x2 mesh) go to the same wrappers as their local
    blocks in the moments' placements, the norm's partial sums reduced
    over the mesh and a replicated leaf counted on its first rank alone;
    the results are the plain version's on the whole leaves."""
    if kind == "dtensor":
        rdv = str(tmp_path_factory.mktemp("optim") / "rendezvous")
        res = spawn(optim_ranks.dtensor_step, 4, (rdv, (2, 2), "cpu"),
                    deadline=120.0)
        for rank, r in enumerate(res):
            assert r["paths"] == {"kernel": 0, "plain": 0, "dtensor": 1}
            assert r["seen"]["update"] == [(5,), (4, 3), (4, 6)]
            # rank (data, model) = divmod(rank, 2) counts b at (0, 0), u
            # (its moments replicated over data) at data 0, w at model 0
            data, model = divmod(rank, 2)
            counted = [(5,) if rank == 0 else (0,),
                       (4, 3) if data == 0 else (0,),
                       (4, 6) if model == 0 else (0,)]
            assert r["seen"]["norm"] == (counted, True)
            assert r["gn"][0] == pytest.approx(r["gn"][1], rel=1e-6)
            assert max(r["errs"]) <= 1e-6
            assert r["unchanged"] and r["step"] == 1
        return
    calls = []

    def norm(grads, max_norm, reduce=None):
        calls.append(("norm", len(grads), max_norm, reduce))
        return torch.tensor(0.5), torch.tensor(2.0)

    def update(ps, gs, ms, vs, scale, lr, b1c, b2c, cfg):
        calls.append(("update", len(ps), float(scale), float(lr),
                      float(b1c), float(b2c)))
    monkeypatch.setattr(pt_adamw, "_kernel", types.SimpleNamespace(
        adamw_norm=norm, adamw_update=update))
    params = {"w": torch.randn(4, 3), "b": [torch.randn(5)]}
    grads = _tree.tree_map(torch.randn_like, params)
    state = adamw_init(params)
    cfg = AdamWConfig(lr=1e-2, warmup=4, clip_norm=0.3)
    pose = lambda tree: _tree.tree_map(lambda t: t.as_subclass(_Cuda), tree)
    state_c = dict(state, m=pose(state["m"]), v=pose(state["v"]))
    params_c = pose(params)
    reset_update_paths()
    got_p, got_s, gn = adamw_update(params_c, pose(grads), state_c, cfg)
    assert update_paths() == {"kernel": 1, "plain": 0, "dtensor": 0}
    close = lambda x: pytest.approx(x, rel=1e-6)
    assert calls == [("norm", 2, 0.3, None),
                     ("update", 2, 0.5, close(2.5e-3), close(0.1),
                      close(0.05))]
    assert got_p is params_c and got_s["m"] is state_c["m"]
    assert got_s["v"] is state_c["v"] and float(gn) == 2.0
    assert int(got_s["step"]) == 1


def test_adamw_update_refuses_leaves_split_across_devices():
    params = [torch.randn(3), torch.randn(3).as_subclass(_Cuda)]
    with pytest.raises(ValueError, match="some leaves are on CUDA"):
        adamw_update(params, _tree.tree_map(torch.randn_like, params),
                     adamw_init(params), AdamWConfig())


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed", SEEDS)
def test_int8_compress_equals_reference(seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    g = (rng.normal(size=64) * scale).astype(np.float32)
    resid = (rng.normal(size=64) * scale * 0.01).astype(np.float32)
    q_ref, s_ref, r_ref = jx_int8_compress(jnp.asarray(g), jnp.asarray(resid))
    q, s, r = int8_compress(torch.from_numpy(g), torch.from_numpy(resid))
    assert q.dtype == torch.int8 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(int8_decompress(q, s).numpy(),
                                  np.asarray(jx_int8_decompress(q_ref, s_ref)))


def test_error_feedback_unbiased_over_steps():
    g = torch.full((16,), 0.003)
    resid = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(200):
        q, s, resid = int8_compress(g, resid)
        sent = sent + int8_decompress(q, s)
    np.testing.assert_allclose(sent.numpy(), g.numpy() * 200, rtol=0.02)


# ------------------------------------------------------------ graph batches
def test_graph_batches_equal_reference():
    g_ref = jx_random_graph(64, 256, 8, seed=0)
    g = random_graph(64, 256, 8, seed=0)
    it_ref, it = jx_graph_batches(g_ref, 16, 4, seed=1), graph_batches(
        g, 16, 4, seed=1)
    for step in range(3):
        b_ref, b = next(it_ref), next(it)
        assert sorted(b) == sorted(b_ref) and b["step"] == step
        for k in ("node_ids", "neighbors", "weights", "features"):
            assert b[k].dtype == b_ref[k].dtype
            np.testing.assert_array_equal(b[k], b_ref[k])


# ------------------------------------------------------------ checkpoints
def _ckpt_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=gen),
            "b": {"w": torch.randn(3, generator=gen).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "c": [torch.arange(5, dtype=torch.int64), None]}


def _zeros_like(tree):
    return _tree.tree_map(torch.zeros_like, tree)


def test_roundtrip_with_bf16(tmp_path):
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 5, t)
    got, step = restore_checkpoint(str(tmp_path), _zeros_like(t))
    assert step == 5
    for a, b in zip(_tree.leaves(t), _tree.leaves(got)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert got["c"][1] is None


def test_corruption_falls_back(tmp_path):
    t0, t1 = _ckpt_tree(0), _ckpt_tree(1)
    save_checkpoint(str(tmp_path), 1, t0)
    save_checkpoint(str(tmp_path), 2, t1)
    npz = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    got, step = restore_checkpoint(str(tmp_path), _zeros_like(t0))
    assert step == 1
    assert torch.equal(got["a"], t0["a"])
    assert restore_checkpoint(str(tmp_path / "none"), t0) == (None, None)


def test_manager_keeps_and_saves_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    t = _ckpt_tree()
    for s in range(5):
        assert mgr.maybe_save(s, t, blocking=False)
    mgr.finalize()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert len(steps) <= 3 and steps[-1] == 4
    assert latest_step(str(tmp_path)) == 4
    mgr._gc()
    assert len([d for d in os.listdir(str(tmp_path))
                if d.startswith("step_")]) == 2
    got, step = mgr.restore(_zeros_like(t))
    assert step == 4 and torch.equal(got["a"], t["a"])
    assert not CheckpointManager(str(tmp_path), every=3).maybe_save(4, t)
    # either alone restores plainly, as the reference's; both place
    # shards, which needs shardings shaped like the tree
    for kw in (dict(mesh=object()), dict(shardings=object())):
        got, step = mgr.restore(_zeros_like(t), **kw)
        assert step == 4 and torch.equal(got["a"], t["a"])
    with pytest.raises(ValueError, match="tree structure"):
        mgr.restore(_zeros_like(t), mesh=object(), shardings=object())


def test_reference_checkpoint_restores_into_port(tmp_path):
    """The reference's taxi parameters saved by ``repro.checkpoint``
    restore into the port (sorted leaf order, the same layout) and give
    the reference's forward within rtol 1e-5, atol 1e-5 * max|ref|."""
    cfg_jx = jx_taxi.TaxiConfig(m=4, n=4, p_hist=3, q_future=2, hidden=16,
                                lstm_hidden=16, sample=4)
    cfg = taxi.TaxiConfig(m=4, n=4, p_hist=3, q_future=2, hidden=16,
                          lstm_hidden=16, sample=4)
    key = jax.random.key(2)
    params = jx_taxi.init_params(key, cfg_jx)
    jx_ckpt.save_checkpoint(str(tmp_path), 9, params)
    like = taxi.init_params(cfg, seed=5, device="cpu")
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 9 and list(got) == sorted(like)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(params[k]))
    n = 20
    nbrs, wtss = [], []
    for r in range(3):
        nb, wt = jx_random_graph(n, n * 3, 1, seed=r).gcn_normalize() \
            .neighbor_sample(4)
        nbrs.append(nb)
        wtss.append(wt)
    x_hist = np.asarray(jx_taxi.synthetic_stream(key, n, 3, cfg_jx))
    ref = np.asarray(jx_taxi.forward(params, jnp.asarray(x_hist),
                                     jnp.asarray(np.stack(nbrs)),
                                     jnp.asarray(np.stack(wtss)), cfg_jx))
    out = taxi.forward(got, torch.tensor(x_hist),
                       torch.from_numpy(np.stack(nbrs)),
                       torch.from_numpy(np.stack(wtss)), cfg)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    # and the other way: the port's checkpoint restores into the reference
    save_checkpoint(str(tmp_path / "port"), 3, got)
    back, step = jx_ckpt.restore_checkpoint(
        str(tmp_path / "port"), jax.tree.map(np.zeros_like, params))
    assert step == 3
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(params[k]))
    with open(tmp_path / "step_0000000009" / "tree.json") as f_ref, \
            open(tmp_path / "port" / "step_0000000003" / "tree.json") as f:
        assert json.load(f)["treedef"] == json.load(f_ref)["treedef"]
