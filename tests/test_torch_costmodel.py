"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's, on every case of ``tests/test_costmodel.py``.

Both are plain Python floats computed by the same expressions, so they
must agree with ``==``, field for field: any difference is a
transcription error. Each case also keeps the reference test's own
assertions on the paper's published numbers, applied to the port.
"""
import dataclasses
import math

import pytest
from _hyp import given, settings, st

from repro.core import costmodel as jx
from repro.core.graph import GraphStats as JxStats
from repro_torch.core import costmodel as pt
from repro_torch.core.graph import GraphStats, TABLE2_DATASETS, TAXI_STATS


def jx_stats(s: GraphStats) -> JxStats:
    return JxStats(*dataclasses.astuple(s))


def same(a, b) -> None:
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.t_net, a.p_net) == (b.t_net, b.p_net)


def test_table1_centralized():
    t = pt.table1()["centralized"]
    assert t == jx.table1()["centralized"]
    assert t["traversal_s"] == pytest.approx(38.43e-9, rel=1e-3)
    assert t["aggregation_s"] == pytest.approx(142.77e-6, rel=1e-3)
    assert t["feature_extraction_s"] == pytest.approx(14.53e-6, rel=1e-3)
    assert t["computation_s"] == pytest.approx(157.34e-6, rel=2e-3)
    assert t["communication_s"] == pytest.approx(3.30e-3, rel=1e-3)
    assert t["p_compute_w"] == pytest.approx(823.11e-3, rel=1e-3)


def test_table1_decentralized():
    t = pt.table1()["decentralized"]
    assert t == jx.table1()["decentralized"]
    assert t["traversal_s"] == pytest.approx(7.68e-9, rel=2e-3)
    assert t["aggregation_s"] == pytest.approx(14.27e-6, rel=2e-3)
    assert t["feature_extraction_s"] == pytest.approx(0.37e-6, rel=6e-3)
    assert t["computation_s"] == pytest.approx(14.6e-6, rel=5e-3)
    assert t["communication_s"] == pytest.approx(406e-3, rel=1e-3)
    assert t["p_compute_w"] == pytest.approx(45.49e-3, rel=1e-3)


def test_headline_averages():
    comp, comm = pt.headline_averages()
    assert (comp, comm) == jx.headline_averages()
    assert comp == pytest.approx(1400, rel=0.05)   # "~1400x faster compute"
    assert comm == pytest.approx(790, rel=0.05)    # "~790x comm speed-up"


def test_hardware_params_equal():
    assert dataclasses.asdict(pt.DEFAULT_HW) == dataclasses.asdict(
        jx.DEFAULT_HW)


def test_power_ratio_18x():
    c = pt.predict("centralized", TAXI_STATS)
    d = pt.predict("decentralized", TAXI_STATS)
    same(c, jx.predict("centralized", jx_stats(TAXI_STATS)))
    same(d, jx.predict("decentralized", jx_stats(TAXI_STATS)))
    assert c.p_compute / d.p_compute == pytest.approx(18.1, rel=0.02)


def test_fig8_trends():
    cent = {n: pt.predict("centralized", s)
            for n, s in TABLE2_DATASETS.items()}
    dec = {n: pt.predict("decentralized", s)
           for n, s in TABLE2_DATASETS.items()}
    for n, s in TABLE2_DATASETS.items():
        same(cent[n], jx.predict("centralized", jx_stats(s)))
        same(dec[n], jx.predict("decentralized", jx_stats(s)))
        assert dec[n].t_compute < cent[n].t_compute
        assert cent[n].t_communicate < dec[n].t_communicate
    assert max(cent, key=lambda n: cent[n].t_compute) == "livejournal"
    assert max(dec, key=lambda n: dec[n].t_communicate) == "collab"
    vals = [dec[n].t_compute for n in TABLE2_DATASETS]
    assert max(vals) == pytest.approx(min(vals))


@pytest.mark.parametrize("n_clusters", [1, 4, 16, 1000])
def test_semi_balances_tradeoff(n_clusters):
    s = TABLE2_DATASETS["livejournal"]
    semi = pt.predict("semi", s, n_clusters=n_clusters)
    same(semi, jx.predict("semi", jx_stats(s), n_clusters=n_clusters))
    if n_clusters == 1000:
        assert semi.t_compute < pt.predict("centralized", s).t_compute
        assert semi.t_communicate < pt.predict("decentralized",
                                               s).t_communicate


@pytest.mark.parametrize("n_clusters", [4, 16])
def test_pick_setting_guideline(n_clusters):
    best, metrics = pt.pick_setting(TAXI_STATS, n_clusters=n_clusters)
    jbest, jmetrics = jx.pick_setting(jx_stats(TAXI_STATS),
                                      n_clusters=n_clusters)
    assert best == jbest and set(metrics) == set(jmetrics)
    for k in metrics:
        same(metrics[k], jmetrics[k])
    assert best == min(metrics, key=lambda s: metrics[s].t_net)
    assert best in ("centralized", "semi")


@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
@pytest.mark.parametrize("name", ["taxi", *TABLE2_DATASETS])
def test_predict_both_modes_match_reference(setting, name):
    s = TAXI_STATS if name == "taxi" else TABLE2_DATASETS[name]
    for kw in (dict(), dict(workload_scaled=True),
               dict(workload_scaled=True, sample=8),
               dict(mode="derived"), dict(mode="derived", sample=8),
               dict(mode="derived", technology="reram"),
               dict(mode="derived", layer_dims=(max(s.feature_len, 1), 64,
                                                16))):
        same(pt.predict(setting, s, n_clusters=16, **kw),
             jx.predict(setting, jx_stats(s), n_clusters=16, **kw))


@pytest.mark.parametrize("frac", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_link_and_power_terms_match_reference(setting, frac):
    s = TABLE2_DATASETS["collab"]
    js = jx_stats(s)
    assert pt.refresh_communicate_latency(setting, s, n_clusters=8,
                                          dirty_frac=frac) == \
        jx.refresh_communicate_latency(setting, js, n_clusters=8,
                                       dirty_frac=frac)
    assert pt.communicate_latency(setting, s, n_clusters=8) == \
        jx.communicate_latency(setting, js, n_clusters=8)
    assert pt.power(setting, s, gnn_layers=3) == jx.power(setting, js,
                                                          gnn_layers=3)


def test_calibrated_mode_rejects_derived_knobs():
    for kw in (dict(technology="reram"), dict(calibration=object())):
        with pytest.raises(ValueError, match="derived"):
            pt.predict("centralized", TAXI_STATS, **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        pt.predict("centralized", TAXI_STATS, mode="tabulated")


@settings(max_examples=25, deadline=None)
@given(n=st.integers(10, 10**7), e_per=st.floats(1, 500),
       f=st.integers(1, 4096))
def test_property_monotonicity(n, e_per, f):
    s1 = GraphStats("a", n, int(n * e_per), f, e_per)
    s2 = GraphStats("b", 2 * n, int(2 * n * e_per), f, e_per)
    c1, c2 = pt.predict("centralized", s1), pt.predict("centralized", s2)
    same(c1, jx.predict("centralized", jx_stats(s1)))
    same(c2, jx.predict("centralized", jx_stats(s2)))
    assert c2.t_compute > c1.t_compute
    s3 = GraphStats("c", n, int(n * e_per * 2), f, e_per * 2)
    d1 = pt.predict("decentralized", s1)
    d2 = pt.predict("decentralized", s3)
    same(d2, jx.predict("decentralized", jx_stats(s3)))
    assert d2.t_communicate > d1.t_communicate
    for m in (c1, c2, d1, d2):
        assert m.t_net > 0 and m.p_net > 0 and math.isfinite(m.t_net)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(100, 10**6), cs=st.floats(2, 300))
def test_property_workload_scaled_sane(n, cs):
    s = GraphStats("w", n, int(n * cs), 512, cs)
    base = pt.predict("decentralized", s, workload_scaled=False)
    scaled = pt.predict("decentralized", s, workload_scaled=True)
    same(scaled, jx.predict("decentralized", jx_stats(s),
                            workload_scaled=True))
    assert scaled.t_compute >= base.t_compute * 0.99


def test_workload_sample_threads_through_predict():
    s = GraphStats("w", 10_000, 10_000 * 600, 512, 600.0)
    small = pt.predict("decentralized", s, workload_scaled=True, sample=512)
    big = pt.predict("decentralized", s, workload_scaled=True, sample=2048)
    same(big, jx.predict("decentralized", jx_stats(s), workload_scaled=True,
                         sample=2048))
    assert big.compute.aggregation > small.compute.aggregation
    default = pt.predict("decentralized", s, workload_scaled=True)
    assert default.compute.aggregation == small.compute.aggregation
