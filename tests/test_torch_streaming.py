"""The port's streaming path against the JAX package's.

The cases of ``tests/test_streaming.py`` (delta rebuild contract, k-hop
frontier exactness, incremental == full recompute on every setting x
backend, incremental traffic invariants, the refresh policies), the
streaming case of ``tests/test_bucketed.py``, and the two properties of
``tests/test_streaming_properties.py`` (through ``tests/_hyp``), run on
``repro_torch.streaming`` with ``device="cpu"``. Beside them the port is
held to the reference on the same seeded graphs, host tables and
parameters (the reference's ``init_params`` through
``gnn.params_from_numpy``):

  * the incremental embeddings equal the reference engine's within rtol
    1e-4, atol 1e-4 * max|ref| (as ``test_torch_gnn.py``), and the full
    recompute of the mutated graph within 1e-4, on the 3 x 3 setting x
    backend grid and with ``buckets="auto"``;
  * the mutated graphs, the frontier masks (every mode), the recompute
    fractions and the incremental traffic reports equal the reference's
    exactly;
  * bit-accurate numerics fall back to a full refresh on every backend;
  * ``python -m repro_torch.launch.gnn --stream`` prints its report lines,
    and the new entry points raise without CUDA unless given the CPU.
"""
import numpy as np
import pytest
import jax
import torch

from _hyp import given, settings, st
from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro import streaming as jx_streaming
from repro_torch.core import gnn
from repro_torch.core.graph import Graph, random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics
from repro_torch.streaming import (FRONTIER_MODES, GraphDelta,
                                   IncrementalEngine, StreamingGNNServer,
                                   apply_deltas, expand_frontier)

from test_torch_traffic import assert_reports_equal

SETTINGS = ("centralized", "decentralized", "semi")
BACKENDS = ("jnp", "pallas", "fused")
QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)


def make_graph(n=40, e=200, f=12, seed=1, normalize=True, weighted=True):
    """The port's copy of the shared conftest graph factory."""
    g = random_graph(n, e, f, seed=seed, weighted=weighted)
    return g.gcn_normalize() if normalize else g


def jx_graph(n=40, e=200, f=12, seed=1):
    return jx_random_graph(n, e, f, seed=seed).gcn_normalize()


def _raw_edges(g: Graph):
    dst = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    return dst, g.indices.astype(np.int64)


def _cfg(f=8, numerics=None, **kw):
    n = dict(numerics=CrossbarNumerics(**numerics)) if numerics else {}
    return gnn.GNNConfig(in_dim=f, hidden_dims=(8,), out_dim=4, sample=4,
                         **n, **kw)


def _params(cfg, seed=0):
    return gnn.init_params(cfg, seed=seed, device="cpu")


def _engine(plan, cfg, params, **kw):
    eng = IncrementalEngine(plan, cfg, params, device="cpu", **kw)
    eng.full_refresh()
    return eng


def assert_close(got, ref, what=""):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=what)


# ---- delta: amortized rebuild + renormalization contract ----------------

def test_feature_only_delta_keeps_structure():
    g = make_graph()
    d = GraphDelta(g.n_nodes)
    rows = np.ones((3, g.feature_len), np.float32)
    d.update_features([5, 1, 9], rows)
    res = apply_deltas(g, d)
    assert res.graph is not g and res.graph.features is not g.features
    np.testing.assert_array_equal(res.graph.indptr, g.indptr)
    np.testing.assert_array_equal(res.graph.indices, g.indices)
    np.testing.assert_array_equal(res.graph.features[[1, 5, 9]], rows)
    assert set(np.nonzero(res.feature_dirty)[0]) == {1, 5, 9}
    assert not res.structure_dirty.any()


def test_structural_delta_matches_scratch_renormalization():
    """apply_deltas on a normalized graph must equal rebuilding the raw
    graph with the same edits and calling gcn_normalize from scratch."""
    g_raw = random_graph(30, 150, 4, seed=3, weighted=False)
    g = g_raw.gcn_normalize()
    d = GraphDelta(g.n_nodes)
    d.add_edges([2, 17, 17], [9, 4, 4])
    rm_dst, rm_src = int(np.repeat(np.arange(30), np.diff(g.indptr))[0]), \
        int(g.indices[0])
    d.remove_edges([rm_dst], [rm_src])
    res = apply_deltas(g, d)

    dst, src = _raw_edges(g_raw)
    keep = ~((dst == rm_dst) & (src == rm_src))
    dst = np.concatenate([dst[keep], [2, 17, 17]])
    src = np.concatenate([src[keep], [9, 4, 4]])
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(31, np.int64)
    np.add.at(indptr, dst + 1, 1)
    oracle = Graph(np.cumsum(indptr), src[order].astype(np.int32), None,
                   g_raw.features).gcn_normalize()

    np.testing.assert_array_equal(res.graph.indptr, oracle.indptr)
    np.testing.assert_array_equal(res.graph.indices, oracle.indices)
    np.testing.assert_allclose(res.graph.edge_weight, oracle.edge_weight,
                               rtol=1e-6)
    np.testing.assert_allclose(res.graph.self_loop, oracle.self_loop,
                               rtol=1e-6)
    for u in (2, 17, rm_dst):
        assert res.structure_dirty[u]


def test_remove_edges_drops_all_parallel_duplicates():
    g = Graph(np.array([0, 0, 3]), np.array([0, 0, 1], np.int32),
              np.ones(3, np.float32), np.zeros((2, 2), np.float32))
    d = GraphDelta(2).remove_edges([1], [0])
    res = apply_deltas(g, d)
    assert res.graph.n_edges == 1 and res.graph.indices[0] == 1


def test_remove_cancels_earlier_buffered_add_but_not_later():
    g = make_graph(20, 60, 4, seed=5)
    has = (np.repeat(np.arange(20), np.diff(g.indptr)) * 20
           + g.indices).tolist()
    pair = next((d, s) for d in range(20) for s in range(20)
                if d * 20 + s not in has)
    d = GraphDelta(20).add_edges([pair[0]], [pair[1]])
    d.remove_edges([pair[0]], [pair[1]])
    assert apply_deltas(g, d).graph.n_edges == g.n_edges    # netted out
    d2 = GraphDelta(20).remove_edges([pair[0]], [pair[1]])
    d2.add_edges([pair[0]], [pair[1]])
    assert apply_deltas(g, d2).graph.n_edges == g.n_edges + 1


def test_delta_rejects_out_of_range_ids():
    d = GraphDelta(10)
    with pytest.raises(IndexError):
        d.update_features([10], np.zeros((1, 3), np.float32))
    with pytest.raises(IndexError):
        d.add_edges([0], [-1])


def test_engine_keeps_shared_plan_consistent():
    """The engine mutates the ExecutionPlan in place; after streaming, the
    plan's own make_forward must reproduce the engine's embeddings (feats
    and structural tables both tracked the live graph)."""
    g = make_graph(30, 140, 8, seed=2)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=4,
                          n_clusters=2)
    cfg = _cfg()
    params = _params(cfg)
    eng = _engine(plan, cfg, params)
    rng = np.random.default_rng(3)
    d = GraphDelta(g.n_nodes).update_features(
        [4], rng.normal(size=(1, 8)).astype(np.float32))
    eng.apply_delta(d)
    assert plan.graph is eng.graph
    np.testing.assert_array_equal(plan.graph.features, eng.graph.features)
    d = GraphDelta(g.n_nodes).update_features(
        [2, 8], rng.normal(size=(2, 8)).astype(np.float32))
    d.add_edges([6], [19])
    eng.apply_delta(d)
    assert plan.graph is eng.graph
    out = plan.scatter(plan.make_forward(cfg, device="cpu")(params))
    np.testing.assert_allclose(out, eng.embeddings(), atol=1e-5)


# ---- frontier: exact k-hop masks over the sampled adjacency -------------

def _chain_graph(n=6, f=4):
    """Row i reads node i-1 (row 0 empty): dirt at 0 walks one hop/layer."""
    indptr = np.concatenate([[0], np.arange(n)]).astype(np.int64)
    indices = np.arange(n - 1, dtype=np.int32)
    return Graph(indptr, indices, np.ones(n - 1, np.float32),
                 np.zeros((n, f), np.float32))


@pytest.mark.parametrize("mode", FRONTIER_MODES)
def test_frontier_walks_one_hop_per_layer_and_ignores_padding(mode):
    g = _chain_graph(6)
    nbr, wts = g.neighbor_sample(4)
    fd = np.zeros(6, bool)
    fd[0] = True
    fr = expand_frontier(nbr, wts, fd, np.zeros(6, bool), 3, mode=mode,
                         device="cpu")
    assert set(np.nonzero(fr.masks[1])[0]) == {0, 1}
    assert set(np.nonzero(fr.masks[2])[0]) == {0, 1, 2}
    assert set(np.nonzero(fr.masks[3])[0]) == {0, 1, 2, 3}
    assert 0.0 < fr.recompute_fraction() < 1.0


def test_frontier_monotone_and_structure_dirty_everywhere():
    g = make_graph(50, 300, 4, seed=7)
    nbr, wts = g.neighbor_sample(6)
    rng = np.random.default_rng(0)
    fd = rng.random(50) < 0.1
    sd = rng.random(50) < 0.05
    fr = expand_frontier(nbr, wts, fd, sd, 3)
    for l in range(1, 3):
        assert not (fr.masks[l] & ~fr.masks[l + 1]).any()   # monotone
    for l in range(1, 4):
        assert (fr.masks[l] | ~sd).all()                    # sd always dirty


def test_frontier_cam_modes_bit_identical_and_equal_to_reference():
    """Every mode gives the numpy masks bit for bit, and the reference's
    masks on the same sample (its CAM modes in interpret mode)."""

    @settings(max_examples=8, deadline=None)
    @given(n=st.integers(10, 60), e=st.integers(20, 200),
           frac=st.floats(0.0, 0.6), seed=st.integers(0, 4))
    def run(n, e, frac, seed):
        g = make_graph(n, min(e, n * (n - 1)), 4, seed=seed)
        nbr, wts = g.neighbor_sample(5)
        rng = np.random.default_rng(seed + 100)
        fd = rng.random(n) < frac
        sd = rng.random(n) < frac / 3
        ref = expand_frontier(nbr, wts, fd, sd, 3, mode="numpy")
        for mode in FRONTIER_MODES[1:]:
            fr = expand_frontier(nbr, wts, fd, sd, 3, mode=mode,
                                 device="cpu")
            np.testing.assert_array_equal(fr.masks, ref.masks)
        jx = jx_streaming.expand_frontier(nbr, wts, fd, sd, 3,
                                          mode="cam-pallas", interpret=True)
        np.testing.assert_array_equal(ref.masks, jx.masks)
    run()


def test_frontier_cam_empty_and_full_dirty():
    """Degenerate dirty sets: no dirty ids (CAM search never runs) and
    everything dirty must both match the numpy expansion exactly."""
    g = make_graph(30, 120, 4, seed=11)
    nbr, wts = g.neighbor_sample(4)
    for fd in (np.zeros(30, bool), np.ones(30, bool)):
        ref = expand_frontier(nbr, wts, fd, np.zeros(30, bool), 2)
        for mode in FRONTIER_MODES[1:]:
            fr = expand_frontier(nbr, wts, fd, np.zeros(30, bool), 2,
                                 mode=mode, device="cpu")
            np.testing.assert_array_equal(fr.masks, ref.masks)


def test_frontier_cam_splits_queries_into_chunks(monkeypatch):
    """The CAM frontier searches in chunks of the bitmap budget; a budget
    that forces many chunks gives the same masks."""
    from repro_torch.streaming import frontier
    g = make_graph(40, 200, 4, seed=12)
    nbr, wts = g.neighbor_sample(5)
    fd = np.random.default_rng(1).random(40) < 0.2
    ref = expand_frontier(nbr, wts, fd, np.zeros(40, bool), 3)
    monkeypatch.setattr(frontier, "_BITMAP_BUDGET", 37)
    fr = expand_frontier(nbr, wts, fd, np.zeros(40, bool), 3,
                         mode="cam-pallas", device="cpu")
    np.testing.assert_array_equal(fr.masks, ref.masks)


def test_frontier_mode_validation():
    g = make_graph(10, 30, 4)
    nbr, wts = g.neighbor_sample(3)
    fd = np.zeros(10, bool)
    with pytest.raises(ValueError, match="frontier mode"):
        expand_frontier(nbr, wts, fd, fd, 2, mode="bloom")
    plan = plan_execution(g, "centralized", n_clusters=2)
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(8,), out_dim=4,
                        sample=3)
    with pytest.raises(ValueError, match="frontier"):
        IncrementalEngine(plan, cfg, _params(cfg), frontier_mode="bloom",
                          device="cpu")


def test_engine_cam_frontier_matches_numpy():
    """The engine's dirty sets (and therefore its refresh output) are
    identical whichever membership path expands the frontier."""
    g = make_graph(24, 100, 6, seed=3)
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    params = _params(cfg, seed=1)
    outs, fracs = {}, {}
    for fm in FRONTIER_MODES:
        plan = plan_execution(g, "centralized", n_clusters=2)
        eng = _engine(plan, cfg, params, frontier_mode=fm)
        d = GraphDelta(g.n_nodes)
        d.update_features([2, 9], np.ones((2, 6), np.float32))
        upd = eng.apply_delta(d)
        outs[fm] = eng.embeddings()
        fracs[fm] = upd.recompute_fraction
    for fm in FRONTIER_MODES[1:]:
        assert fracs[fm] == fracs["numpy"]
        np.testing.assert_array_equal(outs[fm], outs["numpy"])


# ---- incremental == full, and == the reference engine -------------------

def _ticks(g, rng_seed=5):
    """The two ticks of the reference's grid test: feature churn, then
    feature + structural churn (adds and a remove)."""
    rng = np.random.default_rng(rng_seed)
    d1 = dict(feat=([3, 11], rng.normal(size=(2, 8)).astype(np.float32)))
    rm = ([3], [g.indices[g.indptr[3]]] if g.indptr[4] > g.indptr[3]
          else [0])
    d2 = dict(feat=([7], rng.normal(size=(1, 8)).astype(np.float32)),
              add=([4, 9], [22, 1]), rm=rm)
    return [d1, d2]


def _delta(cls, n, tick):
    d = cls(n)
    if "feat" in tick:
        d.update_features(*tick["feat"])
    if "add" in tick:
        d.add_edges(*tick["add"])
    if "rm" in tick:
        d.remove_edges(*tick["rm"])
    return d


GRID = [(s, b, None) for s in SETTINGS for b in BACKENDS] + [
    ("decentralized", "fused", "auto"), ("semi", "pallas", "auto")]


@pytest.mark.parametrize("setting,backend,buckets", GRID,
                         ids=lambda p: str(p))
def test_incremental_matches_full_recompute(setting, backend, buckets):
    g = make_graph(30, 140, 8, seed=2)
    k = None if setting == "centralized" else 2
    plan = plan_execution(g, setting, backend=backend, sample=4,
                          n_clusters=k, buckets=buckets)
    cfg = _cfg()
    params = _params(cfg)
    eng = _engine(plan, cfg, params)
    t1, t2 = _ticks(g)
    upd = eng.apply_delta(_delta(GraphDelta, g.n_nodes, t1))
    assert not upd.full and upd.recompute_fraction < 1.0
    eng.apply_delta(_delta(GraphDelta, g.n_nodes, t2))

    fresh = plan_execution(eng.graph, setting, backend=backend, sample=4,
                           n_clusters=k, buckets=buckets)
    ref = fresh.scatter(fresh.make_forward(cfg, device="cpu")(params))
    err = np.abs(eng.embeddings() - ref).max()
    assert err < 1e-4, (setting, backend, err)


@pytest.mark.parametrize("setting,backend,buckets", GRID,
                         ids=lambda p: str(p))
def test_incremental_matches_reference_engine(setting, backend, buckets):
    """Same graph, parameters and ticks through the reference's engine and
    the port's: embeddings within the serving tolerance after every tick;
    graphs, frontier masks, recompute fractions and traffic exactly."""
    g_jx, g = jx_graph(30, 140, 8, seed=2), make_graph(30, 140, 8, seed=2)
    k = None if setting == "centralized" else 2
    kw = dict(backend=backend, sample=4, n_clusters=k, buckets=buckets)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=4)
    params_jx = jx_gnn.init_params(jax.random.key(0), cfg_jx)
    eng_jx = jx_streaming.IncrementalEngine(
        jx_plan_execution(g_jx, setting, **kw), cfg_jx, params_jx)
    eng_jx.full_refresh()
    eng = _engine(plan_execution(g, setting, **kw), _cfg(),
                  gnn.params_from_numpy(params_jx, device="cpu"))
    assert_close(eng.embeddings(), eng_jx.embeddings(), "cold")
    for i, tick in enumerate(_ticks(g)):
        u_jx = eng_jx.apply_delta(_delta(jx_streaming.GraphDelta,
                                         g.n_nodes, tick))
        u = eng.apply_delta(_delta(GraphDelta, g.n_nodes, tick))
        for name in ("indptr", "indices", "edge_weight", "features",
                     "self_loop"):
            np.testing.assert_array_equal(getattr(eng.graph, name),
                                          getattr(eng_jx.graph, name))
        np.testing.assert_array_equal(u.frontier.masks, u_jx.frontier.masks)
        assert u.full == u_jx.full
        assert u.recompute_fraction == u_jx.recompute_fraction
        if u_jx.traffic is None:
            assert u.traffic is None
        else:
            assert_reports_equal(u.traffic, u_jx.traffic)
        assert_close(eng.embeddings(), eng_jx.embeddings(), f"tick {i}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_bit_accurate_numerics_degrade_to_full_refresh(backend):
    """The global DAC scale couples every row: incremental must fall back
    to a full refresh rather than quantize against a stale max|Z|, and the
    refresh equals the plan's own forward on the mutated graph exactly
    (same layer steps on the same inputs)."""
    g = make_graph(30, 140, 8, seed=2)
    plan = plan_execution(g, "centralized", backend=backend, sample=4)
    cfg = _cfg(numerics=QUANT)
    params = _params(cfg)
    eng = _engine(plan, cfg, params)
    d = GraphDelta(g.n_nodes).update_features(
        [0], np.ones((1, 8), np.float32) * 3)
    upd = eng.apply_delta(d)
    assert upd.full and upd.recompute_fraction == 1.0
    fresh = plan_execution(eng.graph, "centralized", backend=backend,
                           sample=4)
    ref = fresh.scatter(fresh.make_forward(cfg, device="cpu")(params))
    assert np.abs(eng.embeddings() - ref).max() < 1e-4
    np.testing.assert_array_equal(
        eng.embeddings(),
        plan.scatter(plan.make_forward(cfg, device="cpu")(params)))


def test_bit_accurate_commit_equals_reference():
    g_jx, g = jx_graph(30, 140, 8, seed=2), make_graph(30, 140, 8, seed=2)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=4, numerics=JxNumerics(**QUANT))
    params_jx = jx_gnn.init_params(jax.random.key(0), cfg_jx)
    eng_jx = jx_streaming.IncrementalEngine(
        jx_plan_execution(g_jx, "semi", backend="fused", sample=4,
                          n_clusters=2), cfg_jx, params_jx)
    eng_jx.full_refresh()
    eng = _engine(plan_execution(g, "semi", backend="fused", sample=4,
                                 n_clusters=2), _cfg(numerics=QUANT),
                  gnn.params_from_numpy(params_jx, device="cpu"))
    tick = _ticks(g)[1]
    u_jx = eng_jx.apply_delta(_delta(jx_streaming.GraphDelta, 30, tick))
    u = eng.apply_delta(_delta(GraphDelta, 30, tick))
    assert u.full and u_jx.full
    assert_reports_equal(u.traffic, u_jx.traffic)
    assert_close(eng.embeddings(), eng_jx.embeddings())


# ---- incremental traffic invariants -------------------------------------

@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_incremental_traffic_bounded_by_full(setting):
    from repro_torch.distributed.traffic import measure_execution
    g = make_graph(60, 400, 8, seed=4)
    plan = plan_execution(g, setting, backend="jnp", sample=4, n_clusters=3)
    cfg = _cfg()
    eng = _engine(plan, cfg, _params(cfg))
    rng = np.random.default_rng(1)
    d = GraphDelta(g.n_nodes).update_features(
        [0, 5], rng.normal(size=(2, 8)).astype(np.float32))
    upd = eng.apply_delta(d)
    full = measure_execution(plan, cfg=cfg, mode="alltoall")
    assert upd.traffic.total_bytes() <= full.total_bytes()
    assert (upd.traffic.tier1_rows <= full.tier1_rows[None]).all()
    if setting == "semi":
        assert (upd.traffic.tier0_rows <= full.tier0_rows).all()
        assert upd.traffic.tier0_rows.sum() == 2   # the two mutated rows


@pytest.mark.parametrize("mode", ["allgather", "alltoall"])
@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_incremental_traffic_equals_reference(setting, mode):
    """Structural churn creates new send slots: the ``new_send`` billing
    of the next tick equals the reference's, field for field."""
    g_jx, g = jx_graph(60, 400, 8, seed=4), make_graph(60, 400, 8, seed=4)
    kw = dict(backend="jnp", sample=4, n_clusters=3)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=4)
    params_jx = jx_gnn.init_params(jax.random.key(0), cfg_jx)
    eng_jx = jx_streaming.IncrementalEngine(
        jx_plan_execution(g_jx, setting, **kw), cfg_jx, params_jx,
        mode=mode)
    eng_jx.full_refresh()
    eng = _engine(plan_execution(g, setting, **kw), _cfg(),
                  gnn.params_from_numpy(params_jx, device="cpu"), mode=mode)
    rng = np.random.default_rng(2)
    for _ in range(3):
        tick = dict(feat=(rng.choice(60, 3, replace=False),
                          rng.normal(size=(3, 8)).astype(np.float32)),
                    add=(rng.integers(0, 60, 4), rng.integers(0, 60, 4)))
        u_jx = eng_jx.apply_delta(_delta(jx_streaming.GraphDelta, 60, tick))
        u = eng.apply_delta(_delta(GraphDelta, 60, tick))
        assert_reports_equal(u.traffic, u_jx.traffic)
        assert_close(eng.embeddings(), eng_jx.embeddings())


def test_empty_delta_recomputes_and_ships_nothing():
    g = make_graph(40, 200, 8, seed=6)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=4,
                          n_clusters=3)
    cfg = _cfg()
    eng = _engine(plan, cfg, _params(cfg))
    before = eng.embeddings().copy()
    upd = eng.apply_delta(GraphDelta(g.n_nodes))
    assert upd.recompute_fraction == 0.0
    assert upd.traffic.total_bytes() == 0
    np.testing.assert_array_equal(eng.embeddings(), before)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("setting", SETTINGS)
def test_bucketed_streaming_refresh_matches_dense(setting, backend):
    """Dense and bucketed engines fed identical churn commit to the same
    embeddings — the bucketed dirty-refresh path (per-cluster row writes
    into the per-bucket activation caches) through feature and structural
    deltas."""
    g = random_graph(50, 240, 8, seed=5).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(10,), out_dim=4, sample=5,
                        backend=backend)
    params = _params(cfg, seed=1)
    engines = {}
    for name, buckets in (("dense", None), ("bucketed", "auto")):
        plan = plan_execution(g, setting, backend=backend, sample=5,
                              n_clusters=4, seed=2, buckets=buckets)
        engines[name] = _engine(plan, cfg, params)
    rng = np.random.default_rng(0)
    for tick in range(3):
        ids = rng.choice(50, 5, replace=False)
        rows = rng.normal(size=(5, 8)).astype(np.float32)
        u, v = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        for eng in engines.values():
            d = GraphDelta(50)
            d.update_features(ids, rows)
            d.add_edges([u], [v], [0.5])
            eng.apply_delta(d)
        a = engines["dense"].embeddings()
        b = engines["bucketed"].embeddings()
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"tick {tick}")


# ---- StreamingGNNServer policies ---------------------------------------

def _streaming_server(policy="eager", **kw):
    g = make_graph(40, 200, 12, seed=8)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=4,
                          n_clusters=3)
    cfg = gnn.GNNConfig(in_dim=12, hidden_dims=(8,), out_dim=4, sample=4)
    srv = StreamingGNNServer(plan, cfg, policy=policy, device="cpu", **kw)
    srv.refresh()
    return srv, g


def _tick(srv, g, seed):
    rng = np.random.default_rng(seed)
    nodes = rng.choice(g.n_nodes, 3, replace=False)
    return srv.ingest(nodes=nodes,
                      rows=rng.normal(size=(3, g.feature_len)))


def test_eager_policy_commits_every_tick():
    srv, g = _streaming_server("eager")
    for t in range(3):
        assert _tick(srv, g, t) is not None
    assert srv.commits == 4 and srv.full_refreshes == 1   # 1 = cold start
    assert all(not u.full for u in srv.updates[1:])


def test_interval_policy_buffers_between_commits():
    srv, g = _streaming_server("interval", interval=3)
    assert _tick(srv, g, 0) is None and _tick(srv, g, 1) is None
    upd = _tick(srv, g, 2)
    assert upd is not None and srv.pending_ticks == 0
    assert upd.frontier.masks[0].sum() >= 3


def test_bounded_staleness_triggers_on_dirty_fraction():
    srv, g = _streaming_server("bounded-staleness", max_staleness=100,
                               max_dirty_frac=0.2)
    committed = 0
    for t in range(12):
        if _tick(srv, g, t) is not None:
            committed += 1
            assert not srv._pending_dirty.any()
    assert committed >= 1
    assert srv.commits < 13


def test_flush_and_param_update_force_full_refresh():
    srv, g = _streaming_server("interval", interval=100)
    _tick(srv, g, 0)
    assert srv.flush() is not None and srv.flush() is None
    srv.update_params(_params(srv.cfg, seed=9))
    _tick(srv, g, 1)
    upd = srv.flush()
    assert upd is not None and upd.full          # params moved: full rebuild
    assert srv.full_refreshes == 2


def test_streaming_query_serves_policy_bounded_staleness():
    srv, g = _streaming_server("interval", interval=5)
    before = srv.query(np.arange(4)).copy()
    _tick(srv, g, 0)
    np.testing.assert_array_equal(srv.query(np.arange(4)), before)  # stale
    srv.flush()
    assert not np.allclose(srv.query(np.arange(4)), before)


def test_streaming_server_equals_reference_server():
    """The same stream through both packages' servers (eager, cam
    frontier) serves the same embeddings."""
    g_jx, g = jx_graph(40, 200, 12, seed=8), make_graph(40, 200, 12, seed=8)
    kw = dict(backend="fused", sample=4, n_clusters=3)
    cfg_jx = jx_gnn.GNNConfig(in_dim=12, hidden_dims=(8,), out_dim=4,
                              sample=4)
    params_jx = jx_gnn.init_params(jax.random.key(3), cfg_jx)
    srv_jx = jx_streaming.StreamingGNNServer(
        jx_plan_execution(g_jx, "decentralized", **kw), cfg_jx,
        params=params_jx)
    srv = StreamingGNNServer(
        plan_execution(g, "decentralized", **kw),
        gnn.GNNConfig(in_dim=12, hidden_dims=(8,), out_dim=4, sample=4),
        params=gnn.params_from_numpy(params_jx, device="cpu"),
        frontier_mode="cam-pallas", device="cpu")
    for s in (srv, srv_jx):
        s.refresh()
    for t in range(3):
        u, u_jx = _tick(srv, g, t), _tick(srv_jx, g, t)
        np.testing.assert_array_equal(u.frontier.masks, u_jx.frontier.masks)
        assert_close(srv.query(np.arange(40)), srv_jx.query(np.arange(40)),
                     f"tick {t}")
    assert srv.commits == srv_jx.commits == 4


# ---- the CLI and the device guard ---------------------------------------

def test_cli_streams_on_cpu(capsys):
    from repro_torch.launch.gnn import main
    main(["--stream", "4", "--device", "cpu", "--hidden", "8",
          "--clusters", "3", "--churn", "0.02"])
    out = capsys.readouterr().out
    assert "decentralized/fused" in out and "policy eager" in out
    assert "frontier membership via numpy" in out
    assert "4 ticks, 5 commits (1 full)" in out
    assert "mean incremental recompute fraction" in out
    assert "measured incremental traffic" in out
    assert "full-refresh equivalent" in out
    assert "served 64 lookups alongside the stream" in out


def test_cli_stream_policy_and_telemetry_dumps(capsys, tmp_path):
    from repro_torch import telemetry as tel
    from repro_torch.launch.gnn import main
    mpath, tpath = tmp_path / "m.jsonl", tmp_path / "t.jsonl"
    try:
        main(["--stream", "4", "--device", "cpu", "--hidden", "8",
              "--setting", "semi", "--policy", "interval",
              "--neighbor-mode", "cam-pallas", "--metrics", str(mpath),
              "--trace", str(tpath)])
    finally:
        tel.disable()
        tel.reset()
    out = capsys.readouterr().out
    assert "semi/fused" in out and "policy interval" in out
    assert "frontier membership via cam-pallas" in out
    assert "4 ticks, 2 commits (1 full)" in out
    assert "telemetry: wrote" in out and str(tpath) in out
    assert mpath.read_text().count("\n") > 0
    main(["--device", "cpu", "--hidden", "8", "--clusters", "3",
          "--requests", "1", "--batch", "2"])
    assert "measured traffic — decentralized/alltoall:" in \
        capsys.readouterr().out


@pytest.mark.parametrize("call", ["engine", "server", "frontier", "cli"])
def test_streaming_entry_points_raise_without_cuda(call, monkeypatch):
    """Asked for the default device on a host without CUDA, the new entry
    points raise; they never fall back to the CPU on their own."""
    from repro_torch.launch.gnn import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = make_graph(20, 60, 8, seed=1)
    plan = plan_execution(g, "centralized", sample=4)
    cfg = _cfg()
    nbr, wts = g.neighbor_sample(4)
    calls = {
        "engine": lambda: IncrementalEngine(plan, cfg, _params(cfg)),
        "server": lambda: StreamingGNNServer(plan, cfg,
                                             params=_params(cfg)),
        "frontier": lambda: expand_frontier(
            nbr, wts, np.ones(20, bool), np.zeros(20, bool), 2,
            mode="cam-pallas"),
        "cli": lambda: main(["--scale", "0.0002", "--stream", "2"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()


# ---- properties of the delta buffer (tests/_hyp shim-safe) -------------

def _ops(rng, g, n_ops: int) -> list:
    """Random interleaved op sequence over ``g``'s node set, biased toward
    collisions (removes drawn from live edges) and always ending in an
    explicit add→remove→re-add cancellation chain."""
    n, f = g.n_nodes, g.feature_len
    dst0 = np.repeat(np.arange(n), np.diff(g.indptr))
    live = list(zip(dst0.tolist(), g.indices.tolist()))
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.4:
            m = int(rng.integers(1, 4))
            nodes = rng.choice(n, size=m, replace=False)
            ops.append(("feat", nodes,
                        rng.normal(size=(m, f)).astype(np.float32)))
        elif r < 0.7:
            m = int(rng.integers(1, 3))
            d, s = rng.integers(0, n, m), rng.integers(0, n, m)
            ops.append(("add", d, s))
            live += list(zip(d.tolist(), s.tolist()))
        else:
            if live and rng.random() < 0.8:
                pair = live[int(rng.integers(0, len(live)))]
            else:
                pair = (int(rng.integers(0, n)), int(rng.integers(0, n)))
            ops.append(("rm", np.array([pair[0]]), np.array([pair[1]])))
    d, s = int(rng.integers(0, n)), int(rng.integers(0, n))
    ops += [("add", np.array([d]), np.array([s])),
            ("rm", np.array([d]), np.array([s])),
            ("add", np.array([d]), np.array([s]))]
    return ops


def _delta_from(ops, n: int, cls=GraphDelta):
    delta = cls(n)
    for kind, a, b in ops:
        if kind == "feat":
            delta.update_features(a, b)
        elif kind == "add":
            delta.add_edges(a, b)
        else:
            delta.remove_edges(a, b)
    return delta


def _oracle_rebuild(g_raw: Graph, ops) -> Graph:
    """From-scratch replay: plain edge list + feature table, then a fresh
    CSR build and gcn_normalize — no delta machinery involved."""
    n = g_raw.n_nodes
    dst0 = np.repeat(np.arange(n), np.diff(g_raw.indptr))
    pairs = list(zip(dst0.tolist(), g_raw.indices.tolist()))
    feats = g_raw.features.copy()
    for kind, a, b in ops:
        if kind == "feat":
            feats[a] = b
        elif kind == "add":
            pairs += list(zip(a.tolist(), b.tolist()))
        else:
            gone = (int(a[0]), int(b[0]))
            pairs = [p for p in pairs if p != gone]
    dst = np.array([p[0] for p in pairs], np.int64)
    src = np.array([p[1] for p in pairs], np.int64)
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    return Graph(np.cumsum(indptr), src[order].astype(np.int32), None,
                 feats).gcn_normalize()


def _changed_rows(base: Graph, new: Graph) -> np.ndarray:
    """[N] bool: rows whose aggregation inputs differ between two
    normalized graphs (neighbor ids, edge weights, or self-loop)."""
    n = base.n_nodes
    changed = np.zeros(n, bool)
    for u in range(n):
        b = slice(int(base.indptr[u]), int(base.indptr[u + 1]))
        m = slice(int(new.indptr[u]), int(new.indptr[u + 1]))
        changed[u] = (
            b.stop - b.start != m.stop - m.start
            or not np.array_equal(base.indices[b], new.indices[m])
            or not np.allclose(base.edge_weight[b], new.edge_weight[m],
                               rtol=1e-6)
            or not np.isclose(base.self_loop[u], new.self_loop[u],
                              rtol=1e-6))
    return changed


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(3, 8),
       n=st.sampled_from([6, 13, 20]))
def test_property_every_prefix_equals_scratch_rebuild(seed, n_ops, n):
    """Every prefix of a buffered op sequence commits to the from-scratch
    rebuild (structure, renormalized weights, features), with exact
    feature dirt and sound structure dirt — and to the reference's
    ``apply_deltas`` result bit for bit."""
    rng = np.random.default_rng(seed)
    g_raw = random_graph(n, 3 * n, 4, seed=seed % 1000, weighted=False)
    g = g_raw.gcn_normalize()
    g_jx = jx_random_graph(n, 3 * n, 4, seed=seed % 1000,
                           weighted=False).gcn_normalize()
    ops = _ops(rng, g, n_ops)
    for cut in range(len(ops) + 1):
        prefix = ops[:cut]
        res = apply_deltas(g, _delta_from(prefix, n))
        oracle = _oracle_rebuild(g_raw, prefix)
        msg = f"prefix {cut}"
        np.testing.assert_array_equal(res.graph.indptr, oracle.indptr,
                                      err_msg=msg)
        np.testing.assert_array_equal(res.graph.indices, oracle.indices,
                                      err_msg=msg)
        np.testing.assert_allclose(res.graph.edge_weight,
                                   oracle.edge_weight, rtol=1e-6,
                                   err_msg=msg)
        np.testing.assert_allclose(res.graph.self_loop, oracle.self_loop,
                                   rtol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(res.graph.features, oracle.features,
                                      err_msg=msg)
        touched = np.zeros(n, bool)
        for kind, a, _ in prefix:
            if kind == "feat":
                touched[a] = True
        np.testing.assert_array_equal(res.feature_dirty, touched,
                                      err_msg=msg)
        missed = _changed_rows(g, res.graph) & ~res.structure_dirty
        assert not missed.any(), (
            f"{msg}: rows {np.nonzero(missed)[0]} changed but not "
            f"structure_dirty")
        ref = jx_streaming.apply_deltas(
            g_jx, _delta_from(prefix, n, jx_streaming.GraphDelta))
        for name in ("indptr", "indices", "edge_weight", "features",
                     "self_loop"):
            np.testing.assert_array_equal(getattr(res.graph, name),
                                          getattr(ref.graph, name),
                                          err_msg=msg)
        np.testing.assert_array_equal(res.structure_dirty,
                                      ref.structure_dirty, err_msg=msg)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_property_cancelled_buffer_is_clean_structurally(seed):
    """A buffer whose every structural op cancels (add e → remove e, for e
    not in the base graph) must commit to the base structure exactly."""
    rng = np.random.default_rng(seed)
    g_raw = random_graph(12, 30, 3, seed=seed % 997, weighted=False)
    g = g_raw.gcn_normalize()
    present = set(zip(
        np.repeat(np.arange(12), np.diff(g.indptr)).tolist(),
        g.indices.tolist()))
    fresh = [(d, s) for d in range(12) for s in range(12)
             if (d, s) not in present]
    pairs = [fresh[int(rng.integers(0, len(fresh)))] for _ in range(3)]
    delta = GraphDelta(12)
    for d, s in pairs:
        delta.add_edges([d], [s])
    for d, s in pairs:
        delta.remove_edges([d], [s])
    res = apply_deltas(g, delta)
    np.testing.assert_array_equal(res.graph.indptr, g.indptr)
    np.testing.assert_array_equal(res.graph.indices, g.indices)
    np.testing.assert_allclose(res.graph.edge_weight, g.edge_weight,
                               rtol=1e-6)
    np.testing.assert_allclose(res.graph.self_loop, g.self_loop, rtol=1e-6)
