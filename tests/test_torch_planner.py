"""The port's planner (``repro_torch.planner``) against the reference's.

Every case of ``tests/test_planner.py`` and ``tests/test_replan_drift.py``
and the planner cases of ``tests/test_devices.py`` and
``tests/test_neighbors.py``, run on the port with ``device="cpu"``. Beside
them the port is held to ``repro.planner`` on the same statistics, graphs,
parameters and samples. Tolerances:

  * the planner is host arithmetic in the reference's order, so its
    outputs compare with ``==``: the scored candidates' order, each score
    and metric, the Pareto frontier, ``summary()``, ``as_record()``, the
    measured keys of the shortlist, the replan events and the audit
    events' fields;
  * embeddings served after a live swap agree with the reference's fresh
    forward of its live graph within rtol 1e-4, atol 1e-4 * max|ref| (the
    tolerance of ``test_torch_streaming.py``).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro import planner as jx
from repro import telemetry as jx_tel
from repro.core import gnn as jx_gnn
from repro.core.graph import GraphStats as JxStats
from repro.core.graph import TABLE2_DATASETS as JX_TABLE2
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.streaming import StreamingGNNServer as JxStreamingServer
from repro_torch import telemetry as tel
from repro_torch.core import gnn
from repro_torch.core.graph import TABLE2_DATASETS, TAXI_STATS, random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.devices import resolve_technology
from repro_torch.planner import (NEIGHBOR_MODES, Candidate, CommitSample,
                                 DriftLedger, PlanContext, ReplanMonitor,
                                 WorkloadProfile, candidate_space,
                                 neighbor_evaluator, pareto_frontier, plan,
                                 score_candidate, tick_costs,
                                 traffic_evaluator)
from repro_torch.streaming import StreamingGNNServer

MIXED = WorkloadProfile(churn=0.01, queries_per_tick=64)
TECHS = ("sot-mram", "reram", "sram", "fefet")
PAIR = ("reram", "sram")
OBJECTIVES = ("latency", "energy", "throughput")
STATS = {"taxi": TAXI_STATS, **TABLE2_DATASETS}
WORKLOADS = {"static": None,
             "mixed": dict(churn=0.01, queries_per_tick=64)}


def make_graph(n=40, e=200, f=12, seed=1):
    """The port's copy of the shared conftest graph factory."""
    return random_graph(n, e, f, seed=seed).gcn_normalize()


def jx_graph(n=40, e=200, f=12, seed=1):
    return jx_random_graph(n, e, f, seed=seed).gcn_normalize()


def jx_stats(s):
    return JxStats(*dataclasses.astuple(s))


def jx_workload(wl):
    return None if wl is None else jx.WorkloadProfile(
        **dataclasses.asdict(wl))


def keys(scored) -> list:
    return [sc.candidate.key for sc in scored]


def assert_results_equal(got, ref) -> None:
    """Two planner results equal with ``==``: scored order, every score
    and metric, the records, the frontier and the summary."""
    assert keys(got.scored) == keys(ref.scored)
    for a, b in zip(got.scored, ref.scored):
        assert a.score == b.score, a.candidate.key
        assert a.metrics == b.metrics, a.candidate.key
        assert a.as_record() == b.as_record()
    assert keys(got.frontier) == keys(ref.frontier)
    assert got.summary() == ref.summary()


def assert_close(got, ref) -> None:
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def _cfg(f=8):
    return gnn.GNNConfig(in_dim=f, hidden_dims=(8,), out_dim=4, sample=4)


# ------------------------------------------------------------- space

def test_candidate_validation():
    with pytest.raises(ValueError, match="setting"):
        Candidate("federated")
    with pytest.raises(ValueError, match="backend"):
        Candidate("semi", backend="tpu")
    with pytest.raises(ValueError, match="policy"):
        Candidate("semi", policy="never")
    with pytest.raises(ValueError, match="centralized"):
        Candidate("centralized", n_clusters=4)
    assert "k16" in Candidate("semi", n_clusters=16).key


def test_candidate_space_structure():
    cands = candidate_space(TAXI_STATS, workload=MIXED)
    ks = {c.key for c in cands}
    assert len(ks) == len(cands)                      # no duplicates
    assert {c.setting for c in cands} == \
        {"centralized", "decentralized", "semi"}
    assert all(c.n_clusters == 1 for c in cands
               if c.setting == "centralized")
    semi_ks = {c.n_clusters for c in cands if c.setting == "semi"}
    assert len(semi_ks) >= 2                          # head count is swept
    static = candidate_space(TAXI_STATS,
                             workload=WorkloadProfile(queries_per_tick=10))
    assert {c.policy for c in static} == {"eager"}
    tiny = dataclasses.replace(TAXI_STATS, n_nodes=3)
    assert max(c.n_clusters for c in candidate_space(tiny)) <= 3
    # the same grid, in the same order, as the reference's
    assert [c.key for c in cands] == [
        c.key for c in jx.candidate_space(jx_stats(TAXI_STATS),
                                          workload=jx_workload(MIXED))]


def test_workload_profile_model():
    wl = WorkloadProfile(churn=0.05, queries_per_tick=8, sample=4,
                         interval=6, max_staleness=20, max_dirty_frac=0.3)
    assert wl.commit_interval("eager") == 1
    assert wl.commit_interval("interval") == 6
    assert wl.commit_interval("bounded-staleness") == 6   # ceil(0.3/0.05)
    capped = dataclasses.replace(wl, churn=0.001)
    assert capped.commit_interval("bounded-staleness") == 20  # staleness cap
    fr1 = wl.recompute_fraction(TAXI_STATS, 1)
    fr4 = wl.recompute_fraction(TAXI_STATS, 4)
    assert 0 < fr1 <= fr4 <= 1.0
    assert WorkloadProfile().recompute_fraction(TAXI_STATS) == 0.0
    with pytest.raises(ValueError, match="churn"):
        WorkloadProfile(churn=1.5)
    ref = jx_workload(wl)
    assert (fr1, fr4) == (ref.recompute_fraction(jx_stats(TAXI_STATS), 1),
                          ref.recompute_fraction(jx_stats(TAXI_STATS), 4))


# --------------------------------------------------------- objectives

def test_objective_decisions_follow_the_workload():
    """Latency → centralized (taxi), mixed churn+query → semi beats both
    pures, churn-only → centralized again."""
    lat = plan(TAXI_STATS, "latency")
    assert lat.recommended.candidate.setting == "centralized"
    mixed = plan(TAXI_STATS, "throughput", workload=MIXED)
    rec = mixed.recommended
    assert rec.candidate.setting == "semi"
    for pure in ("centralized", "decentralized"):
        assert rec.score < mixed.best(pure).score
    q0 = plan(TAXI_STATS, "throughput",
              workload=dataclasses.replace(MIXED, queries_per_tick=0))
    assert q0.recommended.candidate.setting == "centralized"
    with pytest.raises(ValueError, match="objective"):
        plan(TAXI_STATS, "goodness")


def test_energy_objective_penalizes_the_radio():
    r = plan(TABLE2_DATASETS["cora"], "energy")
    dec = r.best("decentralized")
    assert dec.score > dec.metrics["energy_j"]    # comm energy strictly added
    assert r.recommended.score <= dec.score


def test_slo_marks_infeasible_candidates():
    tight = dataclasses.replace(MIXED, slo_s=1e-6)
    loose = dataclasses.replace(MIXED, slo_s=10.0)
    r_tight = plan(TAXI_STATS, "throughput", workload=tight)
    r_loose = plan(TAXI_STATS, "throughput", workload=loose)
    assert r_tight.recommended.score > r_loose.recommended.score * 100
    assert (r_loose.recommended.candidate
            == plan(TAXI_STATS, "throughput", workload=MIXED)
            .recommended.candidate)
    assert_results_equal(r_tight, jx.plan(jx_stats(TAXI_STATS), "throughput",
                                          workload=jx_workload(tight)))


# ----------------------------------------------------- frontier + plan

def test_pareto_frontier_nondomination():
    result = plan(TAXI_STATS, "throughput", workload=MIXED)
    axes = ("t_net", "energy_j", "t_tick")
    front = result.frontier
    assert front and any(sc.candidate == result.recommended.candidate
                         for sc in front)
    for a in front:
        for b in result.scored:
            if b.candidate == a.candidate:
                continue
            dominates = (all(b.metrics[x] <= a.metrics[x] for x in axes)
                         and any(b.metrics[x] < a.metrics[x] * (1 - 1e-9)
                                 for x in axes))
            assert not dominates, (b.candidate.key, a.candidate.key)
    assert len({sc.candidate.setting for sc in front}) >= 2
    assert pareto_frontier([]) == []


def test_recommendation_is_exhaustive_argmin():
    result = plan(TAXI_STATS, "throughput", workload=MIXED)
    ctx = PlanContext(TAXI_STATS, MIXED)
    best = min((score_candidate(c, ctx, "throughput")
                for c in candidate_space(TAXI_STATS, workload=MIXED)),
               key=lambda s: s.sort_key)
    assert result.recommended.score <= best.score * 1.0 + 1e-12
    assert result.recommended.candidate == best.candidate


def test_concrete_graph_refinement_and_build():
    """The shortlist is re-priced by the measured traffic evaluator and the
    recommendation materializes as a plan the port serves on the CPU."""
    g = make_graph(40, 200, 8, seed=0)
    wl = WorkloadProfile(churn=0.05, queries_per_tick=8, sample=4)
    result = plan(g, "throughput", workload=wl, shortlist=3)
    rec = result.recommended
    assert "bytes_full_refresh" in rec.metrics       # measured phase ran
    if rec.candidate.setting != "centralized":
        assert rec.metrics["bytes_per_tick"] <= \
            rec.metrics["bytes_full_refresh"] + 1e-9
    ep = result.build_plan(g)
    assert ep.setting == rec.candidate.setting
    cfg = _cfg()
    params = gnn.init_params(cfg, seed=0, device="cpu")
    out = ep.scatter(ep.make_forward(cfg, device="cpu")(params))
    assert out.shape == (g.n_nodes, 4) and np.isfinite(out).all()


def test_traffic_evaluator_requires_graph():
    ctx = PlanContext(TAXI_STATS, MIXED)
    assert traffic_evaluator(Candidate("semi", n_clusters=4), ctx) == {}


# ------------------------------------------------------ online re-plan

@pytest.fixture
def fixed_clock(monkeypatch):
    """Both streaming engines time their commits on a clock that advances
    1 ms a reading, so every incremental commit measures the same seconds.
    On a 40-node graph a commit takes about a millisecond of host time,
    and on a loaded test host the median of two such commits doubles by
    chance, which trips the latency signal during the quiet ticks; the
    traffic signal is what these tests drive (the latency signal is
    driven by the shadow-mode cases below)."""
    from repro.streaming import incremental as jx_incremental
    from repro_torch.streaming import incremental
    for mod in (incremental, jx_incremental):
        now = [0.0]

        def perf_counter(now=now):
            now[0] += 1e-3
            return now[0]
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=perf_counter))


def _tick_fn(srv, g, rng):
    def tick(frac):
        n = max(int(g.n_nodes * frac), 1)
        nodes = rng.choice(g.n_nodes, n, replace=False)
        srv.ingest(nodes=nodes,
                   rows=rng.normal(size=(n, 8)).astype(np.float32))
    return tick


def test_replan_monitor_swaps_plan_on_traffic_drift(fixed_clock):
    """A pinned decentralized plan, then a churn spike: the monitor
    re-plans with the measured workload and swaps the server, on the CPU,
    to the new recommendation; the swapped server keeps its parameter
    tensors and serves the live graph."""
    g = make_graph(40, 200, 8, seed=2)
    wl = WorkloadProfile(churn=0.05, queries_per_tick=0, sample=4)
    pinned = plan(g.stats("t"), "throughput", workload=wl,
                  space=[Candidate("decentralized", "jnp", 3)])
    assert pinned.recommended.candidate.setting == "decentralized"
    cfg = _cfg()
    srv = StreamingGNNServer(pinned.build_plan(g), cfg, policy="eager",
                             device="cpu")
    params = srv.params
    tensors = [t for layer in params for t in layer.values()]
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1,
                        shortlist=0).attach(srv)
    srv.refresh()
    tick = _tick_fn(srv, g, np.random.default_rng(0))
    for _ in range(4):
        tick(0.05)
    assert not mon.events
    for _ in range(4):
        tick(0.9)
    assert mon.events, "drift never detected"
    ev = mon.events[0]
    assert ev.reason in ("latency", "traffic")
    assert ev.old.setting == "decentralized"
    assert ev.new.setting == "centralized" and ev.swapped
    assert srv.plan.setting == "centralized"
    assert ev.measured > ev.reference * mon.tol
    assert ev.workload.churn > 4 * wl.churn
    # the swap keeps the parameter tensors, and the engine reads them
    assert srv.params is params and srv.engine.params is params
    assert [t for layer in srv.params for t in layer.values()] == tensors
    srv.flush()
    out = srv.query(np.arange(5))
    ref_plan = plan_execution(srv.engine.graph, "centralized", sample=4)
    ref = ref_plan.scatter(ref_plan.make_forward(cfg, device="cpu")(params))
    np.testing.assert_allclose(out, ref[:5], rtol=1e-4, atol=1e-4)


# ------------------------------------------------- neighbor-mode axis

def test_candidate_neighbor_mode_validation_and_key():
    with pytest.raises(ValueError, match="neighbor"):
        Candidate("semi", neighbor_mode="bloom")
    c = Candidate("semi", n_clusters=16, neighbor_mode="cam")
    assert c.key.endswith("/cam")
    assert Candidate("semi", n_clusters=16).neighbor_mode == "topk"


def test_candidate_space_neighbor_axis_follows_workload():
    mutating = candidate_space(TAXI_STATS, workload=MIXED)
    assert {c.neighbor_mode for c in mutating} == set(NEIGHBOR_MODES)
    static = candidate_space(TAXI_STATS,
                             workload=WorkloadProfile(queries_per_tick=10))
    assert {c.neighbor_mode for c in static} == {"topk"}


def test_neighbor_evaluator_prices_both_modes_positive():
    ctx = PlanContext(TAXI_STATS, MIXED)
    jx_ctx = jx.PlanContext(jx_stats(TAXI_STATS), jx_workload(MIXED))
    for nm in ("cam", "topk"):
        c = Candidate("semi", n_clusters=16, neighbor_mode=nm)
        m = neighbor_evaluator(c, ctx)
        assert m["t_neighbor_s"] > 0.0
        assert m["neighbor_rounds"] >= 1.0
        assert m["neighbor_queries"] >= 1.0
        assert m == jx.neighbor_evaluator(
            jx.Candidate("semi", n_clusters=16, neighbor_mode=nm), jx_ctx)


def test_neighbor_tradeoff_crosses_with_dirty_count():
    def costs(churn):
        wl = WorkloadProfile(churn=churn, queries_per_tick=64)
        ctx = PlanContext(TAXI_STATS, wl)
        return {nm: neighbor_evaluator(
            Candidate("semi", n_clusters=16, neighbor_mode=nm),
            ctx)["t_neighbor_s"] for nm in ("cam", "topk")}

    quiet = costs(1e-4)
    stormy = costs(0.9)
    assert quiet["cam"] < quiet["topk"]
    assert stormy["cam"] >= stormy["topk"]


def test_tick_costs_fold_neighbor_refresh_only_when_mutating():
    def refresh(wl):
        ctx = PlanContext(TAXI_STATS, wl)
        c = Candidate("semi", n_clusters=16, neighbor_mode="cam")
        sc = score_candidate(c, ctx, "throughput")
        assert tick_costs(c, ctx, sc.metrics)["refresh_neighbor_s"] == \
            sc.metrics["refresh_neighbor_s"]
        return sc.metrics.get("refresh_neighbor_s", 0.0)

    assert refresh(MIXED) > 0.0
    assert refresh(WorkloadProfile(queries_per_tick=10)) == 0.0


def test_neighbor_axis_never_breaks_self_consistency():
    result = plan(TAXI_STATS, "throughput", workload=MIXED)
    ctx = PlanContext(TAXI_STATS, MIXED)
    rescored = [score_candidate(c, ctx, "throughput")
                for c in candidate_space(TAXI_STATS, workload=MIXED)]
    best = min(rescored, key=lambda s: s.sort_key)
    assert result.recommended.candidate == best.candidate
    assert result.recommended.candidate.neighbor_mode in ("cam", "topk")


def test_modes_tuple_matches_planner_axis():
    """The port's neighbors and planner agree on the mode vocabulary, and
    with the reference's."""
    from repro.neighbors import NEIGHBOR_MODES as jx_modes
    from repro_torch.neighbors import NEIGHBOR_MODES as knn_modes
    assert tuple(NEIGHBOR_MODES) == tuple(knn_modes) == tuple(jx_modes)
    assert tuple(NEIGHBOR_MODES) == tuple(jx.NEIGHBOR_MODES)


# ---------------------------------------------- device-technology axis

MIXED8 = WorkloadProfile(churn=0.01, queries_per_tick=64, sample=8)


def test_planner_mixed_technology_on_frontier():
    result = plan(TAXI_STATS, "throughput", workload=MIXED8,
                  technologies=(*TECHS, PAIR))
    assert any("+" in sc.candidate.tech_key for sc in result.frontier)
    pair = next(sc.candidate for sc in result.scored
                if sc.candidate.tech_key == "reram+sram")
    assert pair.setting == "semi"
    assert (pair.spoke_technology, pair.head_technology) == PAIR


def test_noise_tolerance_rejects_noisy_heads():
    loose = plan(TAXI_STATS, "energy", workload=MIXED8, technologies=TECHS)
    tight = plan(TAXI_STATS, "energy",
                 workload=dataclasses.replace(MIXED8, noise_tolerance=1e-4),
                 technologies=TECHS)
    noisy = resolve_technology(loose.recommended.candidate.head_technology)
    quiet = resolve_technology(tight.recommended.candidate.head_technology)
    assert noisy.noise_sigma > 0.0
    assert quiet.noise_sigma == 0.0


# ------------------------------------------- drift (shadow mode, typed)

def _pinned(predicted_bytes=None, ref=False):
    """Model-only result on one pinned candidate, the port's or (``ref``)
    the reference's; ``bytes_per_tick`` only when injected."""
    if ref:
        result = jx.plan(jx_stats(TAXI_STATS), "throughput",
                         workload=jx.WorkloadProfile(churn=0.05,
                                                     queries_per_tick=8,
                                                     sample=4),
                         space=[jx.Candidate("decentralized", "jnp", 3)])
    else:
        result = plan(TAXI_STATS, "throughput",
                      workload=WorkloadProfile(churn=0.05, queries_per_tick=8,
                                               sample=4),
                      space=[Candidate("decentralized", "jnp", 3)])
    assert "bytes_per_tick" not in result.recommended.metrics
    if predicted_bytes is not None:
        result.recommended.metrics["bytes_per_tick"] = predicted_bytes
    return result


def _monitor(predicted_bytes=None, ref=False, **kw):
    kw.setdefault("window", 2)
    kw.setdefault("tol", 2.0)
    kw.setdefault("cooldown", 1)
    return (jx.ReplanMonitor if ref else ReplanMonitor)(
        _pinned(predicted_bytes, ref=ref), **kw)


def _sample(seconds=0.01, shipped=1000.0, churn=0.05, full=False,
            queries=8, ref=False):
    return (jx.CommitSample if ref else CommitSample)(
        seconds=seconds, shipped_bytes=shipped, churn_frac=churn, full=full,
        queries=queries, policy="eager")


def test_latency_drift_trips_in_shadow_mode():
    mon = _monitor()
    assert mon.observe(_sample(seconds=0.01)) is None
    assert mon.observe(_sample(seconds=0.01)) is None
    assert mon.ledger.baseline_s == pytest.approx(0.01)
    ev = None
    for _ in range(2):
        ev = ev or mon.observe(_sample(seconds=0.05))
    assert ev is not None and ev.reason == "latency"
    assert ev.measured == pytest.approx(0.05)
    assert ev.reference == pytest.approx(0.01)
    assert ev.measured > mon.tol * ev.reference
    assert not ev.swapped and ev.new is ev.old is mon.serving
    assert mon.events == [ev]


def test_latency_drift_replan_event_carries_measured_workload():
    mon = _monitor()
    for s in (0.01, 0.01, 0.08, 0.08):
        ev = mon.observe(_sample(seconds=s, churn=0.4, queries=40))
    assert ev.workload.churn == pytest.approx(0.4)
    assert ev.workload.queries_per_tick >= 10


def test_bytes_drift_trips_against_predicted_reference():
    mon = _monitor(predicted_bytes=1000.0)
    assert mon.observe(_sample(shipped=1000.0)) is None
    assert mon.observe(_sample(shipped=1000.0)) is None
    ev = None
    for _ in range(2):
        ev = ev or mon.observe(_sample(shipped=9000.0))
    assert ev is not None and ev.reason == "traffic"
    assert ev.measured == pytest.approx(9000.0)
    assert ev.reference == pytest.approx(1000.0)
    assert not ev.swapped


def test_bytes_drift_falls_back_to_early_median_without_prediction():
    mon = _monitor(predicted_bytes=None)
    for _ in range(2):
        assert mon.observe(_sample(shipped=500.0)) is None
    ev = None
    for _ in range(2):
        ev = ev or mon.observe(_sample(shipped=5000.0))
    assert ev is not None and ev.reason == "traffic"
    assert ev.reference == pytest.approx(500.0)


def test_bytes_within_band_does_not_trip():
    mon = _monitor(predicted_bytes=1000.0)
    for _ in range(8):
        assert mon.observe(_sample(shipped=1500.0)) is None
    assert not mon.events


def test_full_refresh_samples_are_skipped_not_folded():
    mon = _monitor()
    assert mon.observe(_sample(full=True, seconds=9.9)) is None
    assert mon.ledger.n == 0 and mon.ledger.full_skipped == 1
    assert mon.ledger.baseline_s is None
    for _ in range(4):
        assert mon.observe(_sample(seconds=0.01)) is None
    assert mon.ledger.baseline_s == pytest.approx(0.01)
    assert mon.ledger.full_skipped == 1
    assert not mon.events
    rep = mon.ledger.report()
    assert rep["commits"] == 4 and rep["full_skipped"] == 1


def test_steady_state_stays_quiet():
    mon = _monitor(predicted_bytes=1000.0)
    for _ in range(20):
        assert mon.observe(_sample()) is None
    assert not mon.events
    rep = mon.ledger.report()
    assert rep["commits"] == 20
    assert rep["recent_s"] == pytest.approx(0.01)
    assert rep["bytes_vs_predicted"] == pytest.approx(1.0)


@pytest.fixture
def audit():
    """Telemetry of both packages on and empty; off and empty after."""
    for t in (tel, jx_tel):
        t.reset()
        t.enable()
    yield
    for t in (tel, jx_tel):
        t.reset()
        t.disable()


def _events(t, name) -> list:
    return [e for e in t.get_registry().events if e["event"] == name]


def test_drift_event_mirrored_to_telemetry_audit_log(audit):
    mon = _monitor()
    for s in (0.01, 0.01, 0.05, 0.05):
        mon.observe(_sample(seconds=s))
    drift = _events(tel, "planner.drift")
    assert len(drift) == 1
    assert drift[0]["reason"] == "latency"
    assert drift[0]["shadow"] is True


def test_cooldown_suppresses_repeat_detections():
    mon = _monitor(cooldown=50)
    for s in (0.01, 0.01, 0.05, 0.05):
        mon.observe(_sample(seconds=s))
    assert len(mon.events) == 1
    for _ in range(10):
        assert mon.observe(_sample(seconds=0.05)) is None
    assert len(mon.events) == 1


def test_ledger_reset_restarts_accounting():
    led = DriftLedger(window=2, predicted_bytes=100.0)
    for _ in range(4):
        led.record(CommitSample(0.01, 100.0, 0.1))
    assert led.n == 4 and led.baseline_s is not None
    led.reset()
    assert led.n == 0 and led.baseline_s is None
    assert led.latency_drift(2.0) is None and led.bytes_drift(2.0) is None
    assert led.predicted_bytes == 100.0


# ------------------------------------------- parity with the reference

@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("name", sorted(STATS))
def test_plan_equals_reference(name, objective, workload):
    """Model-only plans on the paper's statistics: equal with ``==``."""
    kw = WORKLOADS[workload]
    wl = None if kw is None else WorkloadProfile(**kw)
    got = plan(STATS[name], objective, workload=wl)
    ref = jx.plan(jx_stats(STATS[name]), objective, workload=jx_workload(wl))
    assert_results_equal(got, ref)
    if name != "taxi":
        assert dataclasses.astuple(STATS[name]) == dataclasses.astuple(
            JX_TABLE2[name])


@pytest.mark.parametrize("tolerance", [None, 1e-4])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_plan_with_technologies_equals_reference(objective, tolerance):
    """The technology axis (four technologies and the ReRAM-spoke /
    SRAM-head pair), with and without the noise gate."""
    wl = dataclasses.replace(MIXED8, noise_tolerance=tolerance)
    got = plan(TAXI_STATS, objective, workload=wl,
               technologies=(*TECHS, PAIR))
    ref = jx.plan(jx_stats(TAXI_STATS), objective, workload=jx_workload(wl),
                  technologies=(*TECHS, PAIR))
    assert_results_equal(got, ref)


MEASURED_KEYS = ("bytes_full_refresh", "bytes_per_tick", "padding_ratio",
                 "peak_device_bytes")


@pytest.mark.parametrize("objective,kw", [
    ("throughput", dict(churn=0.05, queries_per_tick=8, sample=4)),
    ("throughput", dict(churn=0.05, queries_per_tick=0, sample=4)),
    ("latency", dict(queries_per_tick=8, sample=4)),
    ("energy", dict(churn=0.2, edge_churn=3, queries_per_tick=8, sample=4)),
])
def test_measured_phase_equals_reference(objective, kw):
    """The shortlist's measured keys on a concrete graph: equal."""
    g, jg = make_graph(40, 200, 8, seed=0), jx_graph(40, 200, 8, seed=0)
    got = plan(g, objective, workload=WorkloadProfile(**kw), shortlist=3)
    ref = jx.plan(jg, objective, workload=jx.WorkloadProfile(**kw),
                  shortlist=3)
    assert_results_equal(got, ref)
    measured = [sc for sc in got.scored if "bytes_full_refresh" in sc.metrics]
    assert len(measured) == 3
    for a, b in zip(got.scored[:3], ref.scored[:3]):
        # a mutating workload on a centralized plan ships nothing a tick
        # and prices no bytes_per_tick, as the reference's
        assert set(MEASURED_KEYS[:1] + MEASURED_KEYS[2:]) <= set(a.metrics)
        for k in MEASURED_KEYS:
            assert a.metrics.get(k) == b.metrics.get(k), (a.candidate.key, k)


def _event_fields(ev) -> tuple:
    return (ev.tick, ev.reason, ev.measured, ev.reference, ev.old.key,
            ev.new.key, ev.swapped, dataclasses.asdict(ev.workload))


@pytest.mark.parametrize("predicted", [None, 1000.0])
def test_shadow_events_equal_reference(predicted):
    """One synthetic sample stream (cold start, quiet, latency spike,
    traffic spike, full refreshes, quiet again) through both monitors in
    shadow mode: the same events, field for field."""
    stream = ([dict(full=True, seconds=9.9)]
              + [dict(seconds=0.01, shipped=1000.0)] * 3
              + [dict(seconds=0.05, churn=0.3, queries=40)] * 3
              + [dict(full=True)]
              + [dict(shipped=9000.0, churn=0.6)] * 4
              + [dict(seconds=0.01, shipped=1000.0)] * 6
              + [dict(seconds=0.2, shipped=20000.0, queries=0)] * 4)
    mons = [_monitor(predicted, ref=r, cooldown=2) for r in (False, True)]
    for kw in stream:
        for r, mon in zip((False, True), mons):
            mon.observe(_sample(**kw, ref=r))
    got, ref = mons
    assert len(got.events) >= 2
    assert [_event_fields(e) for e in got.events] == \
        [_event_fields(e) for e in ref.events]
    assert got.ledger.report() == ref.ledger.report()


def _served_pair(kind):
    """The port's and the reference's streaming servers on the same graph,
    parameters and pinned candidate (the drift set-up of
    ``test_planner.py``); the port's on the CPU."""
    g, jg = make_graph(40, 200, 8, seed=2), jx_graph(40, 200, 8, seed=2)
    if kind == "traffic":
        wl = dict(churn=0.05, queries_per_tick=0, sample=4)
        cand = dict(setting="decentralized", backend="jnp", n_clusters=3)
    else:
        wl = dict(churn=0.01, queries_per_tick=64, sample=4)
        cand = dict(setting="centralized", backend="jnp", n_clusters=1)
    pinned = plan(g.stats("t"), "throughput", workload=WorkloadProfile(**wl),
                  space=[Candidate(**cand)])
    jx_pinned = jx.plan(jg.stats("t"), "throughput",
                        workload=jx.WorkloadProfile(**wl),
                        space=[jx.Candidate(**cand)])
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=4)
    params_jx = jx_gnn.init_params(jax.random.key(0), cfg_jx)
    params = gnn.params_from_numpy(params_jx, device="cpu")
    srv = StreamingGNNServer(pinned.build_plan(g), _cfg(), params=params,
                             policy="eager", device="cpu")
    jx_srv = JxStreamingServer(jx_pinned.build_plan(jg), cfg_jx,
                               params=params_jx, policy="eager")
    return (pinned, srv, g), (jx_pinned, jx_srv, jg), cfg_jx, params_jx


def _jx_fresh(graph, cfg_jx, params_jx) -> np.ndarray:
    p = jx_plan_execution(graph, "centralized", sample=4)
    return p.scatter(np.asarray(p.make_forward(cfg_jx)(params_jx)))


def test_live_swap_equals_reference(fixed_clock):
    """The traffic-drift swap on both packages: the same event field for
    field (tick, reason, measured and reference bytes, old and new
    candidate, the measured workload), the same live graph; the port's
    served embeddings within 1e-4 of the reference's fresh forward."""
    (pinned, srv, g), (jx_pinned, jx_srv, jg), cfg_jx, params_jx = \
        _served_pair("traffic")
    mons = [ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1,
                          shortlist=0).attach(srv),
            jx.ReplanMonitor(jx_pinned, window=2, tol=2.0, cooldown=1,
                             shortlist=0).attach(jx_srv)]
    ticks = []
    for s, graph in ((srv, g), (jx_srv, jg)):
        s.refresh()
        ticks.append(_tick_fn(s, graph, np.random.default_rng(0)))
    for frac in [0.05] * 4 + [0.9] * 4:
        for tick in ticks:
            tick(frac)
    got, ref = (m.events[0] for m in mons)
    assert _event_fields(got) == _event_fields(ref)
    assert got.reason == "traffic"
    assert got.swapped and srv.plan.setting == got.new.setting
    for s in (srv, jx_srv):
        s.flush()
    live, jx_live = srv.engine.graph, jx_srv.engine.graph
    for k in ("indptr", "indices", "edge_weight", "features"):
        np.testing.assert_array_equal(getattr(live, k), getattr(jx_live, k))
    ref_emb = _jx_fresh(jx_live, cfg_jx, params_jx)
    assert_close(srv.query(np.arange(live.n_nodes)), ref_emb)
    assert_close(jx_srv.query(np.arange(live.n_nodes)), ref_emb)


def test_swap_to_bucketed_plan_equals_reference():
    """A drift injected through ``observe`` with samples of a mixed
    churn+query workload swaps a pinned centralized server to the
    planner's semi recommendation on the bucketed layout: the same
    candidate as the reference's; the parameter tensors kept; the first
    commit after the swap a full refresh the ledger skips; the bucketed
    runtime's embeddings within 1e-4 of the reference's fresh forward."""
    (pinned, srv, g), (jx_pinned, jx_srv, jg), cfg_jx, params_jx = \
        _served_pair("mixed")
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    jx_mon = jx.ReplanMonitor(jx_pinned, window=2, tol=2.0, cooldown=1,
                              shortlist=0)
    for s in (srv, jx_srv):
        s.refresh()
    params = srv.params
    tensors = [t for layer in params for t in layer.values()]
    evs = []
    for seconds in (0.01, 0.01, 0.05, 0.05):
        kw = dict(seconds=seconds, churn=0.01, queries=64)
        evs.append((mon.observe(_sample(**kw), server=srv),
                    jx_mon.observe(_sample(**kw, ref=True), server=jx_srv)))
    got, ref = evs[-1]
    assert got is not None and ref is not None
    assert _event_fields(got) == _event_fields(ref)
    assert got.swapped and got.new.layout == "bucketed"
    assert srv.plan.setting == got.new.setting
    assert srv.plan.bucketed is not None and srv.engine.plan is srv.plan
    assert srv.policy == got.new.policy
    assert srv.params is params and srv.engine.params is params
    assert [t for layer in srv.params for t in layer.values()] == tensors
    skipped = mon.ledger.full_skipped
    srv.add_observer(mon)
    jx_srv.add_observer(jx_mon)
    firsts = []
    for s, graph in ((srv, g), (jx_srv, jg)):
        _tick_fn(s, graph, np.random.default_rng(5))(0.05)
        firsts.append(s.flush())
    assert firsts[0] is not None and firsts[0].full and firsts[1].full
    assert mon.ledger.full_skipped == skipped + 1 and mon.ledger.n == 0
    live, jx_live = srv.engine.graph, jx_srv.engine.graph
    for k in ("indptr", "indices", "edge_weight", "features"):
        np.testing.assert_array_equal(getattr(live, k), getattr(jx_live, k))
    assert_close(srv.query(np.arange(live.n_nodes)),
                 _jx_fresh(jx_live, cfg_jx, params_jx))


def test_plan_audit_event_equals_reference(audit):
    g, jg = make_graph(40, 200, 8, seed=0), jx_graph(40, 200, 8, seed=0)
    wl = dict(churn=0.05, queries_per_tick=8, sample=4)
    plan(g, "throughput", workload=WorkloadProfile(**wl), shortlist=2)
    jx.plan(jg, "throughput", workload=jx.WorkloadProfile(**wl),
            shortlist=2)
    plan(TAXI_STATS, "latency")
    jx.plan(jx_stats(TAXI_STATS), "latency")
    got, ref = _events(tel, "planner.plan"), _events(jx_tel, "planner.plan")
    assert len(got) == 2 and got == ref


def test_replan_audit_event_equals_reference(audit):
    (pinned, srv, _), (jx_pinned, jx_srv, _), _, _ = _served_pair("mixed")
    for s in (srv, jx_srv):
        s.refresh()
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    jx_mon = jx.ReplanMonitor(jx_pinned, window=2, tol=2.0, cooldown=1,
                              shortlist=0)
    for seconds in (0.01, 0.01, 0.05, 0.05):
        kw = dict(seconds=seconds, churn=0.01, queries=64)
        mon.observe(_sample(**kw), server=srv)
        jx_mon.observe(_sample(**kw, ref=True), server=jx_srv)
    got = _events(tel, "planner.replan")
    assert len(got) == 1 and got == _events(jx_tel, "planner.replan")
    assert got[0]["swapped"] is True


@pytest.mark.parametrize("argv,objective,churn", [
    ([], "latency", 0.0),
    (["--stream", "4"], "throughput", 0.05),
])
def test_cli_plan_auto_summary(capsys, argv, objective, churn):
    """``--plan auto --device cpu``: the summary the CLI prints is the
    in-process ``plan(...)``'s, and the reference's on its graph."""
    from repro.core.graph import dataset_like as jx_dataset_like
    from repro_torch.core import dataset_like
    from repro_torch.launch.gnn import main
    main(["--plan", "auto", "--device", "cpu", "--scale", "0.0005",
          "--requests", "2", "--batch", "4", "--hidden", "8", *argv])
    out = capsys.readouterr().out.splitlines()
    wl = dict(churn=churn, queries_per_tick=4.0, sample=8)
    want = plan(dataset_like("collab", scale=0.0005, seed=0).gcn_normalize(),
                objective, workload=WorkloadProfile(**wl),
                shortlist=2).summary().splitlines()
    assert out[:len(want)] == want
    ref = jx.plan(jx_dataset_like("collab", scale=0.0005,
                                  seed=0).gcn_normalize(),
                  objective, workload=jx.WorkloadProfile(**wl), shortlist=2)
    assert ref.summary().splitlines() == want
    rec = want[1].split()[1].split("/")
    assert f"plan: {rec[0]}/{rec[1]}" in "\n".join(out)
