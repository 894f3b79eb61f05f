"""``repro_torch.tuning``: the Hopper kernels' launch choices, tuned.

The cases of ``tests/test_tuning.py`` that carry over, on the port:
  * candidates come default first, unique and legal on the card (for every
    numerics a geometry key leaves open), and deterministic;
  * ``prune`` is deterministic and keeps the default;
  * ``tune`` with a deterministic fake ``measure_fn`` gives byte-identical
    caches; a cache hit skips measurement; the registry works;
    ``TunedKernels`` is hashable;
  * ``plan_geometries`` keys equal the reference's for the same plans,
    per backend and bucketed;
  * ``tune_kernels`` runs end to end with a fake measure, and its tuned
    CPU forward equals the untuned one;
  * a launch choice resolves explicit -> tuned -> registry -> default,
    and an illegal explicit one raises ``ValueError``;
  * real measuring on the CPU raises (no kernel runs there);
  * the calibration artifact round-trips and goes stale off its platform.
The launch plans are the CUDA launchers' own (``kernels.launch_plans``);
that every candidate gives the default launch's bits is checked on the
card (``chip_smoke.py`` path E), where the kernels run.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import gnn as jx_gnn
from repro.core.graph import TAXI_STATS as JX_TAXI
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.mapper.compile import compile_mapping as jx_compile
from repro.devices.calibrate import HostCalibration as JxCalibration
from repro.tuning import plan_geometries as jx_plan_geometries
from repro_torch.core import gnn
from repro_torch.core.graph import TAXI_STATS, random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.devices import (CalibrationStaleError, HostCalibration,
                                 load_calibration, save_calibration)
from repro_torch.kernels import launch_plans as lp
from repro_torch.kernels.cam_match import search
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics
from repro_torch.kernels.crossbar_mvm import ops as xb
from repro_torch.kernels.csr_aggregate import aggregate, csr_aggregate
from repro_torch.kernels.fused_layer import fused_gnn_layer
from repro_torch.mapper.compile import compile_mapping
from repro_torch.tuning import (AggregateConfig, AggregateGeometry,
                                CamConfig, CamGeometry, CrossbarConfig,
                                CrossbarGeometry, FusedConfig, FusedGeometry,
                                TuneCache, TunedKernels, candidates,
                                current_platform, default_config,
                                launch_cost, plan_geometries, prune,
                                registry, tune)
from repro_torch.tuning import autotune
from repro_torch.tuning.autotune import plan_tables, tune_plan
from repro_torch.tuning.measure import make_inputs, measure, measurer
from repro_torch.tuning.space import fits_everywhere, resolve_plan


@pytest.fixture(autouse=True)
def _clean_registry():
    registry.clear()
    yield
    registry.clear()


XGEOM = CrossbarGeometry(m=40, k=700, n=64, rows_per_xbar=128)
FGEOM = FusedGeometry(nd=40, n=40, f_in=12, f_out=16, sample=8)
QGEOM = FusedGeometry(nd=40, n=40, f_in=216, f_out=40, sample=8,
                      ideal=False, rows_per_xbar=128)
GEOMS = {
    "crossbar": XGEOM,
    "crossbar-layer1": CrossbarGeometry(m=372_475, k=496, n=64),
    "crossbar-deep": CrossbarGeometry(m=3000, k=3703, n=64, rows_per_xbar=48,
                                      in_bits=16),
    "ideal": FGEOM,
    "ideal-layer1": FusedGeometry(372_475, 372_475, 496, 64, 8),
    "ideal-layer2": FusedGeometry(372_475, 372_475, 64, 16, 8),
    "ideal-deep": FusedGeometry(3000, 4000, 3703, 64, 8),
    "quant": QGEOM,
    "quant-layer1": FusedGeometry(372_475, 372_475, 496, 64, 8, False),
    "quant-deep": FusedGeometry(3000, 4000, 3703, 64, 8, False, 64),
    "aggregate": AggregateGeometry(nd=40, n=40, f=24, sample=6),
    "cam": CamGeometry(e=160_000, q=104),
}


# ---- candidate space + pruning determinism --------------------------------

@pytest.mark.parametrize("name", sorted(GEOMS))
def test_candidates_default_first_unique_and_legal(name):
    geom = GEOMS[name]
    cands = candidates(geom)
    assert cands[0] == default_config(geom)
    assert len(set(cands)) == len(cands) and len(cands) > 1
    assert cands == candidates(geom)               # deterministic
    assert cands[1:] == sorted(cands[1:])
    assert all(fits_everywhere(geom, c) for c in cands)
    own = resolve_plan(geom, cands[0])
    assert all(resolve_plan(geom, c) != own for c in cands[1:])
    if geom.kernel == "crossbar_mvm":               # depth divides n_k
        assert all(c.depth == 0 or geom.n_k % c.depth == 0 for c in cands)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_prune_deterministic_and_keeps_default(name):
    geom = GEOMS[name]
    a, b = prune(geom), prune(geom)
    assert a == b
    assert any(c == default_config(geom) for c, _ in a)
    assert len(a) <= 4 + 1                         # max_survivors (+default)
    assert all(bd > 0 for _, bd in a)


def test_prune_bounds_sorted_and_slack_filtered():
    survivors = prune(XGEOM, slack=2.0, max_survivors=16)
    bounds = [b for _, b in survivors]
    body = bounds[:-1] if survivors[-1][0] == default_config(XGEOM) \
        else bounds
    assert body == sorted(body)
    assert all(b <= 2.0 * min(bounds) for b in body)


def test_launch_cost_scales_with_geometry():
    c = CrossbarConfig(bn=16, depth=1)
    small = launch_cost(XGEOM, c)
    big = launch_cost(dataclasses.replace(XGEOM, m=80), c)
    assert big.flops == 2 * small.flops
    assert big.hbm_bytes > small.hbm_bytes
    assert small.smem_bytes > 0 and small.grid_steps >= 1
    assert small.precision == "int8"


def test_narrow_column_blocks_gather_once_per_block():
    """A block narrower than the output gathers its rows of A.X once per
    column block: at H = 64, 32-column blocks move the gather twice."""
    geom = GEOMS["ideal-layer1"]
    wide = launch_cost(geom, FusedConfig(32, 64, 0))
    narrow = launch_cost(geom, FusedConfig(64, 32, 0))
    gather = 4.0 * geom.nd * geom.sample * geom.f_in
    assert narrow.hbm_bytes - wide.hbm_bytes > 0.99 * gather
    assert wide.precision == "tf32"


# ---- the launch plans, made on the host for every launch -----------------

def test_default_plans_are_the_launchers():
    """The default launch plans at the serving shapes, the launches the
    kernels make: pinned so that a change to a plan shows here."""
    # W resident at F = 496 takes 207.5 KiB with 32-row tiles
    assert lp.ideal_plan(496, 64) == lp.IdealPlan(32, 64, 496, 8)
    assert lp.ideal_plan(64, 16) == lp.IdealPlan(64, 32, 64, 2)
    deep = lp.ideal_plan(3703, 64)
    assert deep.kc < 3703 and deep.kc % 32 == 0
    assert lp.quant_plan(1, 1, 64, 512, 512) == lp.QuantPlan(64, 1, 512,
                                                             False)
    assert lp.quant_plan(1, 1, 16, 512, 64) == lp.QuantPlan(16, 4, 64, False)
    chunked = lp.quant_plan(1, 2, 64, 64, 3712)
    assert chunked.carry and chunked.kc < 3712 and chunked.kc % 64 == 0
    # a crossbar tile wider than the chunk: the carried variant, with a
    # chunk deeper than K (one chunk), which the launcher takes as given
    assert lp.quant_plan(2, 1, 64, 4096, 1440) == lp.QuantPlan(32, 1, 2336,
                                                               True)
    assert lp.crossbar_resolve(1, 1, 64, 512, 512, 1) == lp.CrossbarPlan(4,
                                                                         512)


@pytest.mark.parametrize("config,match", [
    (FusedConfig(48, 0, 0), "bm"), (FusedConfig(0, 16, 0), "bn"),
    (FusedConfig(0, 0, 40), "depth"), (FusedConfig(0, 0, 496), "depth"),
    (FusedConfig(64, 64, 0), "warps"), (FusedConfig(0, 0, 96), "depth")])
def test_illegal_ideal_choices_raise(config, match):
    with pytest.raises(ValueError, match=match):
        resolve_plan(GEOMS["ideal-layer1"], config)


# ---- resolution and the wrappers ------------------------------------------

def test_resolution_order():
    geom = AggregateGeometry(nd=4, n=4, f=8, sample=2)
    tuned = TunedKernels.of({geom.key(): AggregateConfig(16)})
    assert registry.resolve(geom) == AggregateConfig()
    registry.register(geom.key(), AggregateConfig(4))
    assert registry.resolve(geom) == AggregateConfig(4)
    assert registry.resolve(geom, tuned=tuned) == AggregateConfig(16)
    assert registry.resolve(geom, AggregateConfig(8), tuned) == \
        AggregateConfig(8)


def _case(n=40, s=6, f=24, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(0, n, size=(n, s)).astype(np.int32))
    wts = torch.from_numpy(np.abs(rng.normal(size=(n, s))).astype(
        np.float32))
    return x, nbr, wts


def test_wrappers_resolve_explicit_tuned_registry_default():
    """An illegal choice raises wherever it is taken from, so the order is
    visible on the CPU: the registry is read without a bundle, the bundle
    before the registry, an explicit choice before both."""
    x, nbr, wts = _case()
    geom = AggregateGeometry(nd=40, n=40, f=24, sample=6)
    ref = aggregate(x, nbr, wts, backend="pallas")
    registry.register(geom.key(), AggregateConfig(5))
    with pytest.raises(ValueError, match="warps"):
        aggregate(x, nbr, wts, backend="pallas")
    tuned = TunedKernels.of({geom.key(): AggregateConfig(16)})
    assert torch.equal(aggregate(x, nbr, wts, backend="pallas",
                                 tuned=tuned), ref)
    bad = TunedKernels.of({geom.key(): AggregateConfig(3)})
    assert torch.equal(aggregate(x, nbr, wts, backend="pallas", warps=4,
                                 tuned=bad), ref)
    assert torch.equal(aggregate(x, nbr, wts, backend="jnp", tuned=bad), ref)


@pytest.mark.parametrize("call,match", [
    (lambda x, n, w: csr_aggregate(x, n, w, config=AggregateConfig(12)),
     "warps"),
    (lambda x, n, w: fused_gnn_layer(x, n, w, torch.ones(24, 64),
                                     torch.zeros(64),
                                     config=FusedConfig(bm=48)), "bm"),
    (lambda x, n, w: fused_gnn_layer(x, n, w, torch.ones(24, 64),
                                     torch.zeros(64), CrossbarNumerics(),
                                     config=FusedConfig(bn=24)), "bn"),
    (lambda x, n, w: fused_gnn_layer(x, n, w, torch.ones(24, 64),
                                     torch.zeros(64), bf=0), "bf"),
    (lambda x, n, w: search(n[:, 0].contiguous(), n[:3, 1].contiguous(),
                            backend="pallas", be=100), "be"),
    (lambda x, n, w: search(n[:, 0].contiguous(), n[:3, 1].contiguous(),
                            backend="pallas", bq=32), "bq"),
    (lambda x, n, w: xb.crossbar_matmul_quantized(
        torch.ones((4, 24), dtype=torch.int32), torch.ones(24, 8),
        CrossbarNumerics(), bn=24), "bn")])
def test_illegal_explicit_choices_raise(call, match):
    x, nbr, wts = _case()
    with pytest.raises(ValueError, match=match):
        call(x, nbr, wts)


@pytest.mark.parametrize("name", ["ideal", "quant", "aggregate", "crossbar",
                                  "cam"])
def test_every_candidate_is_accepted_by_its_wrapper(name):
    """Every candidate passes the wrappers' checks and, on the CPU, gives
    the plain version's result (on the card, the kernels' bits are held
    equal by ``chip_smoke.py``)."""
    geom = GEOMS[name]
    rng = np.random.default_rng(1)
    if geom.kernel == "cam_match":
        ci = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
        qs = torch.from_numpy(rng.integers(-1, 50, 20).astype(np.int32))
        ref = search(ci, qs, backend="pallas")
        for c in candidates(geom):
            got = search(ci, qs, backend="pallas", bq=c.bq, be=c.be)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        return
    if geom.kernel == "crossbar_mvm":
        cfg = CrossbarNumerics(rows_per_xbar=geom.rows_per_xbar)
        x = torch.from_numpy(np.abs(rng.normal(size=(geom.m, geom.k))
                                    ).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(geom.k, geom.n)).astype(
            np.float32))
        ref = xb.crossbar_matmul(x, w, cfg)
        for c in candidates(geom):
            got = xb.crossbar_matmul(x, w, cfg, bn=c.bn or None,
                                     depth=c.depth or None)
            assert torch.equal(got, ref)
        return
    f = geom.f if geom.kernel == "csr_aggregate" else geom.f_in
    x, nbr, wts = _case(geom.nd, geom.sample, f)
    if geom.kernel == "csr_aggregate":
        ref = aggregate(x, nbr, wts, backend="pallas")
        for c in candidates(geom):
            assert torch.equal(aggregate(x, nbr, wts, backend="pallas",
                                         warps=c.warps), ref)
        return
    w = torch.from_numpy(rng.normal(size=(f, geom.f_out)).astype(
        np.float32) * 0.1)
    b = torch.zeros(geom.f_out)
    cfg = (CrossbarNumerics(ideal=True) if geom.ideal
           else CrossbarNumerics(rows_per_xbar=geom.rows_per_xbar))
    ref = fused_gnn_layer(x, nbr, wts, w, b, cfg, relu=True)
    for c in candidates(geom):
        assert torch.equal(fused_gnn_layer(x, nbr, wts, w, b, cfg, relu=True,
                                           config=c), ref)


# ---- tune(): determinism, caching, registry -------------------------------

def _fake_measure():
    """Deterministic measure_fn preferring large fields, counting calls."""
    calls = []

    def fn(geom, config):
        calls.append(config)
        return 1.0 / (1 + sum(config.as_dict().values()))
    return fn, calls


def test_tune_deterministic_cache_bytes():
    dumps = []
    for _ in range(2):
        cache = TuneCache()
        fn, _ = _fake_measure()
        winner, info = tune(XGEOM, cache=cache, seed=3, measure_fn=fn,
                            register_result=False, device="cpu")
        assert not info["cached"]
        dumps.append(cache.dumps())
    assert dumps[0] == dumps[1]
    assert '"cpu"' in dumps[0] and current_platform("cpu") == "cpu"


@pytest.mark.parametrize("name", ["ideal", "quant", "aggregate", "cam"])
def test_tune_winner_never_slower_than_default(name):
    fn, _ = _fake_measure()
    geom = GEOMS[name]
    winner, info = tune(geom, measure_fn=fn, register_result=False,
                        device="cpu")
    assert info["winner_s"] <= info["default_s"]
    assert any(c == default_config(geom).as_dict()
               for c, _ in info["measured"])


@pytest.mark.parametrize("t_d,t_w,kept", [
    ((1.0, 1.1, 1.0), (0.95, 0.95, 0.95), True),      # leads .05 .15 .05
    ((1.0, 1.0, 1.0), (0.95, 1.06, 0.95), True),      # one lead negative
    ((1.0, 1.02, 1.01), (0.95, 0.96, 0.955), False)])  # leads .05 .06 .055
def test_tune_keeps_default_within_spread(t_d, t_w, kept):
    """The fastest survivor replaces the default only where its lead,
    paired round by round over the sweep and two more rounds in turn, is
    on average larger than the lead's spread across the rounds."""
    geom = GEOMS["aggregate"]
    times = {AggregateConfig(8): t_d, AggregateConfig(16): t_w,
             AggregateConfig(4): (1.2,)}
    seen: dict = {}

    def fn(g, config):
        seen[config] = seen.get(config, -1) + 1
        return times[config][seen[config]]
    winner, info = tune(geom, measure_fn=fn, register_result=False,
                        device="cpu")
    assert (winner == default_config(geom)) == kept
    assert info["n_timed"] == info["n_candidates"] + 4
    leads = [d - w for d, w in zip(t_d, t_w)]
    assert info["spread_s"] == pytest.approx(max(leads) - min(leads))
    assert info["default_s"] == min(t_d)
    assert info["winner_s"] == (min(t_d) if kept else min(t_w))


def test_cache_hit_skips_measurement(tmp_path):
    path = str(tmp_path / "tuned.json")
    cache = TuneCache(path)
    fn, calls = _fake_measure()
    w1, info1 = tune(XGEOM, cache=cache, measure_fn=fn, device="cpu")
    n_measured = len(calls)
    # every survivor, then two rounds of the default and the winner
    assert n_measured == info1["n_timed"] == info1["n_candidates"] + 4 > 4
    w2, info2 = tune(XGEOM, cache=cache, measure_fn=fn, device="cpu")
    w3, info3 = tune(XGEOM, cache=TuneCache.load(path), measure_fn=fn,
                     device="cpu")
    assert info2["cached"] and info3["cached"]
    assert (w1, w1) == (w2, w3)
    assert len(calls) == n_measured
    _, info4 = tune(XGEOM, cache=cache, measure_fn=fn, force=True,
                    device="cpu")
    assert not info4["cached"] and len(calls) == 2 * n_measured


def test_tune_registers_winner_for_eager_resolution():
    fn, _ = _fake_measure()
    winner, _ = tune(FGEOM, measure_fn=fn, device="cpu")
    assert registry.lookup(FGEOM.key()) == winner
    assert registry.lookup(XGEOM.key()) is None


def test_registry_activate_from_cache(tmp_path):
    path = str(tmp_path / "tuned.json")
    cache = TuneCache(path)
    fn, _ = _fake_measure()
    winner, _ = tune(FGEOM, cache=cache, measure_fn=fn,
                     register_result=False, device="cpu")
    assert registry.lookup(FGEOM.key()) is None
    n = registry.activate(TuneCache.load(path), device="cpu")
    assert n == 1 and registry.lookup(FGEOM.key()) == winner
    assert registry.activate(TuneCache.load(path), platform="cuda:other") \
        == 0


def test_tuned_kernels_bundle_is_hashable_and_ordered():
    a = TunedKernels.of({FGEOM.key(): FusedConfig(32, 64, 0),
                         XGEOM.key(): CrossbarConfig(32, 2)})
    b = TunedKernels.of({XGEOM.key(): CrossbarConfig(32, 2),
                         FGEOM.key(): FusedConfig(32, 64, 0)})
    assert a == b and hash(a) == hash(b)
    assert a.lookup(FGEOM.key()) == FusedConfig(32, 64, 0)
    assert a.lookup(("nope",)) is None
    merged = a.merged(TunedKernels.of({FGEOM.key(): FusedConfig(128)}))
    assert merged.lookup(FGEOM.key()) == FusedConfig(128)
    assert len(merged) == 2
    hash(gnn.GNNConfig(in_dim=4, tuned=a))          # rides on the config


def test_real_measuring_on_the_cpu_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        measure(FGEOM, default_config(FGEOM), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        measurer(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune(FGEOM, device="cpu")


# ---- plan integration -----------------------------------------------------

def _plan_pair(setting, backend, buckets=None, n=40, e=200, f=6):
    kw = dict(backend=backend, sample=4, buckets=buckets,
              n_clusters=None if setting == "centralized" else 4,
              spokes_per_head=2)
    return (plan_execution(random_graph(n, e, f, seed=1).gcn_normalize(),
                           setting, **kw),
            jx_plan_execution(jx_random_graph(n, e, f, seed=1)
                              .gcn_normalize(), setting, **kw))


@pytest.mark.parametrize("buckets", [None, "auto"])
@pytest.mark.parametrize("backend", ["jnp", "pallas", "fused"])
@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
@pytest.mark.parametrize("ideal", [True, False])
def test_plan_geometries_keys_equal_reference(setting, backend, buckets,
                                              ideal):
    plan, jplan = _plan_pair(setting, backend, buckets)
    numerics = dict(ideal=True) if ideal else dict(rows_per_xbar=64)
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4,
                        numerics=CrossbarNumerics(**numerics))
    from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
    jcfg = jx_gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4,
                            numerics=JxNumerics(**numerics))
    keys = [g.key() for g in plan_geometries(plan, plan.gnn_config(cfg))]
    jkeys = [g.key() for g in jx_plan_geometries(jplan,
                                                 jplan.gnn_config(jcfg))]
    assert keys == jkeys
    assert (len(keys) == 0) == (backend == "jnp")


def test_plan_geometries_bucketed_one_shape_per_bucket():
    plan, _ = _plan_pair("decentralized", "fused", "auto")
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    geoms = plan_geometries(plan, plan.gnn_config(cfg))
    bp = plan.bucketed
    shapes = {(bp.n_caps[b], bp.n_caps[b] + bp.h_caps[b], bp.s_caps[b])
              for b in range(bp.n_buckets)}
    assert len(geoms) == len(shapes) * (len(cfg.dims) - 1)
    assert {(gm.nd, gm.n, gm.sample) for gm in geoms} == shapes


@pytest.mark.parametrize("setting,backend,buckets,ideal", [
    ("decentralized", "fused", None, True),
    ("decentralized", "fused", None, False),
    ("centralized", "pallas", None, True),
    ("semi", "fused", None, True),
    ("decentralized", "fused", "auto", True),
    ("decentralized", "pallas", "auto", False)])
def test_execution_plan_tune_kernels_end_to_end(tmp_path, setting, backend,
                                                buckets, ideal):
    plan, _ = _plan_pair(setting, backend, buckets, n=30, e=120, f=10)
    numerics = dict(ideal=True) if ideal else dict(rows_per_xbar=64)
    cfg = gnn.GNNConfig(in_dim=10, hidden_dims=(8,), out_dim=4, sample=4,
                        numerics=CrossbarNumerics(**numerics))
    params = gnn.init_params(cfg, seed=0, device="cpu")
    out_plain = plan.scatter(plan.make_forward(cfg, device="cpu")(params))
    fn, _ = _fake_measure()
    cache = TuneCache(str(tmp_path / "tuned.json"))
    tuned = plan.tune_kernels(cfg, cache=cache, measure_fn=fn, device="cpu")
    geoms = plan_geometries(plan, plan.gnn_config(cfg))
    assert len(tuned) == len({g.key() for g in geoms}) > 0
    assert plan.tuned is tuned and plan.gnn_config(cfg).tuned == tuned
    assert all(tuned.lookup(g.key()) != default_config(g) for g in geoms)
    out_tuned = plan.scatter(plan.make_forward(cfg, device="cpu")(params))
    assert np.array_equal(out_tuned, out_plain)
    again = plan.tune_kernels(cfg, cache=TuneCache.load(cache.path),
                              measure_fn=lambda g, c: 1 / 0, device="cpu")
    assert again == tuned


@pytest.mark.parametrize("setting,buckets", [
    ("centralized", None), ("decentralized", None), ("semi", None),
    ("decentralized", "auto")])
def test_tuner_times_the_plans_own_tables(setting, buckets):
    """``tune_plan`` times each gather geometry on the neighbour and weight
    tables the plan serves at that shape, padding slots included."""
    plan, _ = _plan_pair(setting, "fused", buckets)
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    tables = plan_tables(plan)
    geoms = plan_geometries(plan, plan.gnn_config(cfg))
    assert {(g.nd, g.n, g.sample) for g in geoms} == set(tables)
    for geom in geoms:
        nbr, wts = tables[(geom.nd, geom.n, geom.sample)]
        got = make_inputs(geom, seed=0, device="cpu", tables=(nbr, wts))
        assert np.array_equal(got["nbr"].numpy(), nbr)
        assert np.array_equal(got["wts"].numpy(), wts)
        assert got["x"].shape == (geom.n, geom.f_in)
    if buckets is None:
        nbr, wts = next(iter(tables.values()))
        assert np.array_equal(nbr, plan.neighbors.reshape(
            (-1,) + nbr.shape)[0])
    with pytest.raises(ValueError, match="tables"):
        make_inputs(geoms[0], device="cpu", tables=(nbr[:1], wts[:1]))
    seen = []
    real_tune = autotune.tune

    def spy(geom, **kw):
        seen.append((geom, kw["tables"]))
        return real_tune(geom, **kw)
    autotune.tune = spy
    try:
        fn, _ = _fake_measure()
        tune_plan(plan, plan.gnn_config(cfg), measure_fn=fn, device="cpu")
    finally:
        autotune.tune = real_tune
    assert [g for g, _ in seen] == list(dict.fromkeys(geoms))
    for g, (nbr, wts) in seen:
        want = tables[(g.nd, g.n, g.sample)]
        assert np.array_equal(nbr, want[0]) and np.array_equal(wts, want[1])


def test_jnp_tunes_nothing():
    plan, _ = _plan_pair("centralized", "jnp")
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    assert plan_geometries(plan, plan.gnn_config(cfg)) == []
    assert len(plan.tune_kernels(cfg, device="cpu")) == 0


# ---- calibration ----------------------------------------------------------

def test_calibration_roundtrip_and_staleness(tmp_path):
    path = str(tmp_path / "cal.json")
    cal = HostCalibration(platform=current_platform("cpu"), t_cam=1e-4,
                          t_agg=2e-3, t_fx=3e-4)
    save_calibration(cal, path)
    assert load_calibration(path, device="cpu") == cal
    stale = dataclasses.replace(cal, platform="cuda:NVIDIA H100 80GB HBM3")
    with open(path, "w") as f:
        json.dump(stale.as_dict(), f)
    with pytest.raises(CalibrationStaleError, match="H100"):
        load_calibration(path, device="cpu")
    assert load_calibration(path, strict=False, device="cpu") == stale


def test_calibration_validates_positive():
    with pytest.raises(ValueError, match="t_agg"):
        HostCalibration(platform="cpu", t_cam=1e-4, t_agg=0.0, t_fx=1e-4)


def test_calibration_reanchors_derived_primitives():
    dims = (216, 128)
    cal = HostCalibration(platform="cpu", t_cam=1e-4, t_agg=2e-3, t_fx=3e-4)
    jcal = JxCalibration(**cal.as_dict())
    base = compile_mapping(dims, TAXI_STATS)
    recal = compile_mapping(dims, TAXI_STATS, calibration=cal)
    assert dataclasses.asdict(recal) == dataclasses.asdict(
        jx_compile(dims, JX_TAXI, calibration=jcal))
    assert recal.t_compute > base.t_compute * 100
    sram = compile_mapping(dims, TAXI_STATS, calibration=cal,
                           technology="sram")
    assert sram.t_compute < recal.t_compute


def test_calibration_measuring_on_the_cpu_raises():
    from repro_torch.devices import calibrate
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(None, device="cpu")
