"""The port's telemetry: the cases of ``tests/test_telemetry.py`` on
``repro_torch.telemetry`` (span trees, the disabled fast path, histogram
percentiles, exporters, the span-bytes == measured-traffic contract,
observer isolation, streaming counters, the server's query span), run
with ``device="cpu"``, and the translations of the reference's JAX
specifics: ``device_sync`` walks tensors, lists, tuples and dicts and
passes CPU tensors through, and a span's times line up with a
``torch.profiler`` trace's. The port's own: a stack per thread, intervals
recorded from hooks, the anchor, spans made while a profiler records, and
the aggregates under threads that race. The span bytes are also held
equal to the reference's ``measured_traffic`` on the same graph.
The port's singletons are reset around each test.
"""
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro_torch import telemetry as tel
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.telemetry import (NULL_SPAN, MetricsRegistry, SpanTracer,
                                   default_buckets)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Process-wide singletons: every test starts and ends disabled+empty."""
    tel.reset()
    tel.disable()
    yield
    tel.reset()
    tel.disable()


def _graph(n, e, f, seed):
    return random_graph(n, e, f, seed=seed).gcn_normalize()


# ---- span trees ---------------------------------------------------------

def test_span_nesting_builds_tree():
    tr = SpanTracer(enabled=True)
    with tr.span("tick", n=1):
        with tr.span("halo.gather", bucket=0) as g:
            g.add_bytes(100)
        with tr.span("halo.mvm"):
            with tr.span("halo.mvm.inner") as inner:
                inner.add_bytes(28)
    assert len(tr.roots) == 1
    root = tr.roots[0]
    assert root.name == "tick" and root.attrs == {"n": 1}
    assert [c.name for c in root.children] == ["halo.gather", "halo.mvm"]
    assert root.children[1].children[0].name == "halo.mvm.inner"
    assert root.total_bytes() == 128
    assert root.children[0].total_bytes() == 100
    assert root.duration_s >= root.children[0].duration_s >= 0.0
    assert [s.name for s in root.walk()] == [
        "tick", "halo.gather", "halo.mvm", "halo.mvm.inner"]
    d = root.to_dict()
    assert d["name"] == "tick" and len(d["children"]) == 2
    assert tr.summary()["halo.gather"]["count"] == 1


def test_root_ring_is_bounded_but_aggregates_are_not():
    tr = SpanTracer(enabled=True, max_roots=4)
    for i in range(10):
        with tr.span("t"):
            pass
    assert len(tr.roots) == 4
    assert tr.summary()["t"]["count"] == 10


# ---- the disabled fast path ---------------------------------------------

def test_disabled_tracer_returns_shared_null_span():
    tr = SpanTracer(enabled=False)
    s = tr.span("anything", k=1)
    assert s is NULL_SPAN and tr.span("other") is s
    with s as inner:                       # all no-ops, no allocation
        inner.set(a=1).add_bytes(5)
    assert not tr.roots and tr.summary() == {}


def test_disabled_device_sync_is_identity():
    tr = SpanTracer(enabled=False)
    x = object()
    assert tr.device_sync(x) is x
    assert not tr.roots


def test_enabled_device_sync_walks_containers_and_passes_cpu_through():
    """The translation of ``jax.block_until_ready``: tensors, nested lists,
    tuples and dicts come back as they went in, inside one span; no CUDA
    device is touched for CPU tensors."""
    tr = SpanTracer(enabled=True)
    t = torch.ones(3)
    x = {"a": [t, (t, 1)], "b": t}
    assert tr.device_sync(x, name="plan.forward.sync") is x
    assert tr.device_sync(t) is t
    assert tr.device_sync(None) is None
    assert [r.name for r in tr.roots] == ["plan.forward.sync",
                                          "device_sync", "device_sync"]
    found = set()
    from repro_torch.telemetry.spans import _cuda_devices
    _cuda_devices(x, found)
    assert found == set()


def test_profiler_annotations_mirror_spans_into_record_function():
    """The join of spans and a ``torch.profiler`` trace: a span's start on
    the wall clock (``Span.wall_ns``) lies within 1 ms of the ``ts`` of a
    ``record_function`` opened just inside it, read on the trace's clock
    (``ts`` after ``baseTimeNanoseconds``)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function
    tel.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with tel.span(f"server.refresh{i}"):
                with record_function(f"refresh{i}"):
                    torch.ones(4).sum()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    base = trace["baseTimeNanoseconds"]
    ts = {e["name"]: e["ts"] for e in trace["traceEvents"]
          if e.get("name", "").startswith("refresh")}
    roots = list(tel.get_tracer().roots)
    assert [r.name for r in roots] == [f"server.refresh{i}"
                                       for i in range(3)]
    for i, root in enumerate(roots):
        start_us = (root.wall_ns(root.t_start) - base) / 1e3
        assert abs(ts[f"refresh{i}"] - start_us) < 1e3, (i, start_us)


def _on_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_spans_of_another_thread_do_not_nest_under_the_main_threads():
    tr = SpanTracer(enabled=True)
    seen = {}

    def work():
        with tr.span("worker") as w:
            seen["tid"] = threading.get_native_id()
            with tr.span("worker.inner"):
                pass
        seen["span"] = w

    with tr.span("main") as m:
        _on_thread(work)
        with tr.span("main.inner"):
            pass
    assert [c.name for c in m.children] == ["main.inner"]
    assert [r.name for r in tr.roots] == ["worker", "main"]
    w = seen["span"]
    assert w.parent is None and w.tid == seen["tid"] != m.tid
    assert w.children[0].parent is w and w.children[0].tid == w.tid
    assert m.tid == threading.get_native_id()
    assert m.ident == threading.get_ident()


def test_intervals_and_the_anchor():
    """``record`` takes a closed interval under what the thread holds,
    else under the anchor; spans opened on a thread with nothing open
    nest under the anchor too; every span carries its root's step."""
    tr = SpanTracer(enabled=True)
    with tr.span("train.step", step=7) as root:
        with tr.span("train.backward").anchor() as bwd:
            assert tr.anchor is bwd
            t0 = time.perf_counter()

            def hooks():
                tr.record("model.mixer.backward", t0, time.perf_counter(),
                          kind="attn")
                with tr.span("model.mixer"):
                    pass

            _on_thread(hooks)
            tr.record("here", t0, time.perf_counter())
        assert tr.anchor is None
    assert [r.name for r in tr.roots] == ["train.step"]
    names = [c.name for c in bwd.children]
    assert names == ["model.mixer.backward", "model.mixer", "here"]
    iv = bwd.children[0]
    assert iv.attrs == {"kind": "attn"} and iv.parent is bwd
    assert iv.tid != root.tid == bwd.children[2].tid
    assert bwd.t_start <= iv.t_start <= iv.t_end <= bwd.t_end
    assert {s.step for s in root.walk()} == {7}
    assert tr.summary()["model.mixer.backward"]["count"] == 1
    # with nothing open and no anchor, an interval is a root of its own
    tr.record("lone", 1.0, 2.0)
    assert tr.roots[-1].name == "lone" and tr.roots[-1].duration_s == 1.0
    d = root.to_dict()
    assert d["step"] == 7 and d["tid"] == root.tid
    assert d["wall_ns"] == root.wall_ns(root.t_start)
    assert abs(d["wall_ns"] - time.time_ns()) < 60e9


def test_spans_follow_the_profiler_and_nothing_else_does():
    """While a profiler records, the process tracer makes spans with
    telemetry off, and neither syncs nor counts; a tracer that does not
    follow the profiler makes none."""
    from torch.profiler import ProfilerActivity, profile
    quiet = SpanTracer(enabled=False)
    quiet.follow_profiler = False
    assert not tel.recording() and tel.span("x") is NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert tel.recording() and not tel.enabled()
        with tel.span("profiled"):
            tel.device_sync(torch.ones(2))
        tel.record("interval", 0.0, 1.0)
        tel.counter("c").inc()
        assert quiet.span("y") is NULL_SPAN
    assert not tel.recording()
    assert [r.name for r in tel.get_tracer().roots] == ["profiled",
                                                        "interval"]
    assert tel.get_tracer().roots[0].children == []
    assert tel.snapshot()["counters"] == {}
    tel.record("after", 0.0, 1.0)
    assert len(tel.get_tracer().roots) == 2


def test_span_aggregates_hold_under_racing_threads():
    """Eight threads close spans of one name while the interpreter
    switches threads every microsecond: no count or total is lost."""
    tr = SpanTracer(enabled=True)
    n, per = 8, 2000

    def work():
        for _ in range(per):
            tr.record("race", 0.0, 1.0)
            with tr.span("race"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    agg = tr.summary()["race"]
    assert agg["count"] == 2 * n * per
    assert agg["total_s"] >= n * per


def test_disabled_registry_mutations_do_not_register():
    reg = MetricsRegistry(enabled=False)
    reg.counter("c").inc(5)
    reg.gauge("g").set(1.0)
    reg.histogram("h").observe(0.5)
    reg.event("e", k=1)
    snap = reg.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["n_events"] == 0
    reg.enabled = True
    reg.counter("c").inc(2)
    assert reg.snapshot()["counters"] == {"c": 2.0}


def test_enable_disable_roundtrip_on_module_singletons():
    assert not tel.enabled()
    tel.enable()
    assert tel.enabled()
    with tel.span("x"):
        tel.counter("hits").inc()
    tel.disable()
    assert tel.span("y") is NULL_SPAN
    snap = tel.snapshot()                  # data survives disable
    assert snap["counters"]["hits"] == 1.0 and "x" in snap["spans"]


# ---- histograms ---------------------------------------------------------

def test_histogram_percentiles_monotone_and_bounded():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("lat")
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-6.0, sigma=1.5, size=500)
    for v in vals:
        h.observe(float(v))
    q = h.quantiles()
    assert q["p50"] <= q["p95"] <= q["p99"]
    assert vals.min() <= q["p50"] and q["p99"] <= vals.max() * (1 + 1e-9)
    assert h.count == 500
    assert h.percentile(0.0) == pytest.approx(h.vmin)
    assert h.percentile(1.0) == pytest.approx(h.vmax)


def test_histogram_empty_and_buckets():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("empty")
    assert h.percentile(0.5) == 0.0 and h.quantiles()["p99"] == 0.0
    b = default_buckets(1e-3, 1.0, per_decade=2)
    assert all(x < y for x, y in zip(b, b[1:]))
    assert b[0] == pytest.approx(1e-3) and b[-1] >= 1.0 - 1e-12


# ---- exporters ----------------------------------------------------------

def test_exporters_parse(tmp_path):
    tel.enable()
    with tel.span("tick"):
        with tel.span("halo.gather") as s:
            s.add_bytes(64)
    tel.counter("reqs", setting="semi").inc(3)
    tel.gauge("frac").set(0.25)
    tel.histogram("lat").observe(1e-3)
    tel.event("planner.plan", recommended="c1k4", score=1.0)

    mpath, tpath = tmp_path / "m.jsonl", tmp_path / "t.jsonl"
    n_m = tel.export_metrics(str(mpath))
    n_t = tel.export_trace(str(tpath))
    mlines = [json.loads(line) for line in mpath.read_text().splitlines()]
    assert len(mlines) == n_m and n_m >= 4
    kinds = {m["type"] for m in mlines}
    assert {"counter", "gauge", "histogram", "event"} <= kinds
    tlines = [json.loads(line) for line in tpath.read_text().splitlines()]
    assert len(tlines) == n_t == 1
    assert tlines[0]["name"] == "tick"
    assert tlines[0]["children"][0]["attrs"]["bytes"] == 64

    text = tel.prometheus_text()
    assert 'reqs{setting="semi"} 3' in text
    assert "lat_bucket{" in text and 'le="+Inf"' in text


# ---- span bytes == measured traffic (the exactness contract) ------------

@pytest.mark.parametrize("setting,buckets", [
    ("centralized", None), ("decentralized", None), ("semi", None),
    ("decentralized", "auto")])
def test_span_bytes_equal_measured_traffic(setting, buckets):
    """The forward's span tree bills wire bytes from the same executed
    send/recv tables ``measured_traffic`` counts — totals must be equal,
    exactly, and equal to the reference's on the same graph."""
    g = _graph(40, 200, 8, seed=0)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=4)
    kw = dict(backend="jnp", sample=4,
              n_clusters=None if setting == "centralized" else 3,
              buckets=buckets)
    plan = plan_execution(g, setting, **kw)
    params = gnn.init_params(plan.gnn_config(cfg), seed=0, device="cpu")
    tel.enable()
    plan.make_forward(cfg, device="cpu")(params)
    span_bytes = sum(r.total_bytes() for r in tel.get_tracer().roots
                     if r.name == "plan.forward")
    measured = int(plan.measured_traffic(plan.gnn_config(cfg)).total_bytes())
    assert span_bytes == measured
    p_jx = jx_plan_execution(jx_random_graph(40, 200, 8, seed=0)
                             .gcn_normalize(), setting, **kw)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=4)
    assert measured == int(p_jx.measured_traffic(
        p_jx.gnn_config(cfg_jx)).total_bytes())
    if setting == "centralized":
        assert measured == 0               # no exchange to bill
    else:
        assert measured > 0
        key = f'halo.shipped_bytes{{setting="{setting}"}}'
        assert tel.snapshot()["counters"][key] == measured
    assert "plan.forward.sync" in tel.snapshot()["spans"]


def test_disabled_forward_is_undecorated():
    """With telemetry off the wrapped forward must produce no spans and
    bit-identical outputs to the enabled run."""
    g = _graph(30, 120, 8, seed=1)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=4)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=4,
                          n_clusters=3)
    params = gnn.init_params(plan.gnn_config(cfg), seed=1, device="cpu")
    fwd = plan.make_forward(cfg, device="cpu")
    off = fwd(params)
    assert not tel.get_tracer().roots
    tel.enable()
    on = fwd(params)
    assert tel.get_tracer().roots
    assert torch.equal(off, on)


@pytest.mark.parametrize("overlap", ["overlap", "serial"])
@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_bucketed_forward_spans_and_layer_syncs(setting, overlap):
    """The bucketed runtimes open a ``halo.gather`` and a ``halo.mvm`` span
    per layer and bucket, a ``halo.layer_sync`` per layer (and semi a
    ``halo.tier0_gather``) inside ``plan.forward`` — and give the same
    values with telemetry on and off."""
    g = _graph(60, 300, 8, seed=2)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=4)
    plan = plan_execution(g, setting, backend="fused", sample=4,
                          n_clusters=4, spokes_per_head=2, buckets="auto")
    params = gnn.init_params(plan.gnn_config(cfg), seed=0, device="cpu")
    fwd = plan.make_forward(cfg, overlap=overlap, device="cpu")
    off = fwd(params)
    tel.enable()
    on = fwd(params)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    spans = tel.snapshot()["spans"]
    nb, n_layers = plan.bucketed.n_buckets, len(params)
    assert spans["halo.gather"]["count"] == nb * n_layers
    assert spans["halo.mvm"]["count"] == nb * n_layers
    assert spans["halo.layer_sync"]["count"] == n_layers
    assert ("halo.tier0_gather" in spans) == (setting == "semi")
    root = tel.get_tracer().roots[-1]
    assert root.name == "plan.forward"
    assert {"halo.gather", "halo.mvm"} <= {s.name for s in root.walk()}


# ---- streaming server: observer isolation + counters --------------------

def _tiny_server(policy="eager"):
    from repro_torch.streaming import StreamingGNNServer
    g = _graph(30, 120, 8, seed=2)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=4,
                          n_clusters=3)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=4)
    srv = StreamingGNNServer(plan, cfg, policy=policy, device="cpu")
    srv.refresh()
    return g, srv


def _mutate(g, srv, rng, frac=0.2):
    n = max(int(g.n_nodes * frac), 1)
    nodes = rng.choice(g.n_nodes, n, replace=False)
    return srv.ingest(nodes=nodes,
                      rows=rng.normal(size=(n, 8)).astype(np.float32))


def test_observer_exception_is_isolated(caplog):
    """A raising observer is logged and skipped — later observers still
    run and the commit itself succeeds."""
    g, srv = _tiny_server()
    calls = []

    def bad(server, update):
        raise RuntimeError("observer boom")

    def good(server, update):
        calls.append(update)

    srv.add_observer(bad)
    srv.add_observer(good)
    rng = np.random.default_rng(0)
    with caplog.at_level(logging.ERROR, logger="repro_torch.streaming.server"):
        upd = _mutate(g, srv, rng)
    assert upd is not None
    assert calls == [upd]
    assert any("observer" in r.message for r in caplog.records)

    assert srv.remove_observer(bad) is True
    assert srv.remove_observer(bad) is False
    caplog.clear()
    with caplog.at_level(logging.ERROR, logger="repro_torch.streaming.server"):
        _mutate(g, srv, rng)
    assert not caplog.records
    assert len(calls) == 2


def test_streaming_counters_and_spans():
    tel.enable()
    g, srv = _tiny_server()
    rng = np.random.default_rng(1)
    for _ in range(3):
        _mutate(g, srv, rng)
    snap = tel.snapshot()
    c = snap["counters"]
    assert c["server.commits"] == srv.commits == 4    # cold full + 3 ticks
    assert c["server.full_refreshes"] == srv.full_refreshes == 1
    assert c["streaming.rows_recomputed"] > 0
    assert c["streaming.rows_cached"] >= 0
    assert c["streaming.recompile_estimate"] >= 1
    shipped = sum(u.traffic.total_bytes() for u in srv.updates)
    assert c['streaming.shipped_bytes{setting="decentralized"}'] == shipped
    assert 0.0 <= snap["gauges"]["streaming.dirty_fraction"] <= 1.0
    for name in ("server.commit", "server.ingest", "engine.full_refresh",
                 "engine.apply_deltas", "engine.frontier",
                 "engine.dirty_rows", "halo.mvm", "cache.scatter"):
        assert name in snap["spans"], name
    assert snap["spans"]["engine.dirty_rows"]["count"] == 3
    assert 'span_seconds{span="server.commit"}' in snap["histograms"]


def test_query_histogram_via_gnn_server():
    from repro_torch.launch.gnn import GNNServer
    tel.enable()
    g = _graph(30, 120, 8, seed=3)
    plan = plan_execution(g, "centralized", backend="jnp", sample=4)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=4)
    srv = GNNServer(plan, cfg, device="cpu")
    srv.refresh()
    srv.query(np.arange(6))
    srv.query(np.arange(3))
    snap = tel.snapshot()
    assert snap["counters"]["server.queries"] == 9
    assert snap["spans"]["server.query"]["count"] == 2
    assert snap["spans"]["server.refresh"]["count"] == 1
    h = snap["histograms"]['span_seconds{span="server.query"}']
    assert h["count"] == 2 and h["p50"] <= h["p99"]
    root = [r for r in tel.get_tracer().roots
            if r.name == "server.refresh"][0]
    assert [c.name for c in root.children] == ["plan.forward"]
