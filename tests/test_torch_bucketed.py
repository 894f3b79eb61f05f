"""The port's capacity-bucketed layout against the JAX package's.

The cases of ``tests/test_bucketed.py`` (all but the streaming one, whose
engine is not ported), run on the port with ``device="cpu"``, and beside
them the port held to the reference on the same graphs:

  * the host tables (bucket groups, caps, ``bucket_of``/``index_in``, the
    per-bucket neighbor/weight/feature tables, the flat halo gather plan)
    are copies of the reference's numpy code, so they must be equal;
  * the bucketed forward on 3 settings x 3 backends x {ideal,
    bit-accurate} x both overlap schedules matches the reference's at
    rtol 1e-4, atol 1e-4 * max|ref| (as ``test_torch_gnn.py``);
  * bucketing is a layout change, never a numerics change: in the port a
    bucketed plan's forward equals the dense plan's bit for bit, and the
    overlapped schedule equals the serial one;
  * ``layout_stats``, ``like=`` re-bucketing and ``rebalance`` equal the
    reference's.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from _hyp import given, settings, st
from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.core import partition as jx_partition
from repro.distributed import halo as jx_halo
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import (PARTITION_METHODS, bucket_partition,
                                        build_local_subgraphs,
                                        hier_partition, partition,
                                        plan_execution, rebalance)
from repro_torch.distributed import halo

QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
NUMERICS = {"ideal": dict(ideal=True), "bit-accurate": QUANT}


def _graphs(n, e, f, seed):
    return (jx_random_graph(n, e, f, seed=seed).gcn_normalize(),
            random_graph(n, e, f, seed=seed).gcn_normalize())


def _forward_scattered(g, cfg, params, setting, backend, buckets,
                       overlap="overlap", **plan_kw):
    plan = plan_execution(g, setting, backend=backend, sample=cfg.sample,
                          n_clusters=None if setting == "centralized"
                          else 4, seed=2, buckets=buckets, **plan_kw)
    out = plan.make_forward(cfg, overlap=overlap, device="cpu")(params)
    return plan, plan.scatter(out)


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("method", PARTITION_METHODS)
@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_host_tables_equal_reference(setting, method):
    g_jx, g_pt = _graphs(120, 600, 6, seed=1)
    kw = dict(sample=5, n_clusters=5, seed=3, buckets="auto",
              spokes_per_head=3)
    if setting == "decentralized":
        kw["partition_method"] = method
    p_jx = jx_partition.plan_execution(g_jx, setting, **kw)
    p_pt = plan_execution(g_pt, setting, **kw)
    b_jx, b_pt = p_jx.bucketed, p_pt.bucketed
    assert b_pt.n_buckets == b_jx.n_buckets
    for name in ("n_caps", "h_caps", "s_caps"):
        assert getattr(b_pt, name) == getattr(b_jx, name), name
    for a, b in zip(b_pt.clusters, b_jx.clusters):
        np.testing.assert_array_equal(a, b)
    for name in ("bucket_of", "index_in"):
        np.testing.assert_array_equal(getattr(b_pt, name),
                                      getattr(b_jx, name))
    for name in ("neighbors", "weights"):
        for a, b in zip(getattr(p_pt, name), getattr(p_jx, name)):
            np.testing.assert_array_equal(a, b)
    if setting == "semi":
        np.testing.assert_array_equal(p_pt.feats, p_jx.feats)
    else:
        for a, b in zip(p_pt.feats, p_jx.feats):
            np.testing.assert_array_equal(a, b)
    h_jx = jx_halo.build_bucketed_halo_plan(b_jx)
    h_pt = halo.build_bucketed_halo_plan(b_pt)
    assert h_pt.flat_rows == h_jx.flat_rows
    for name in ("flat_src", "halo_mask"):
        for a, b in zip(getattr(h_pt, name), getattr(h_jx, name)):
            np.testing.assert_array_equal(a, b)
    assert (b_pt.real_rows(), b_pt.padded_rows(), b_pt.dense_padded_rows()) \
        == (b_jx.real_rows(), b_jx.padded_rows(), b_jx.dense_padded_rows())


_REFS = {}


def _reference(setting, backend, numerics):
    """The reference's scattered bucketed forward (computed once per
    case: its two overlap schedules give the same values)."""
    key = (setting, backend, numerics)
    if key not in _REFS:
        g_jx, _ = _graphs(50, 260, 8, seed=3)
        cfg = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(10,), out_dim=4,
                               sample=5,
                               numerics=JxNumerics(**NUMERICS[numerics]))
        params = jx_gnn.init_params(jax.random.key(1), cfg)
        plan = jx_partition.plan_execution(
            g_jx, setting, backend=backend, sample=5,
            n_clusters=None if setting == "centralized" else 4, seed=2,
            buckets="auto")
        out = plan.make_forward(cfg)(params)
        _REFS[key] = (plan.scatter([np.asarray(o) for o in out]), params)
    return _REFS[key]


@pytest.mark.parametrize("overlap", ["overlap", "serial"])
@pytest.mark.parametrize("numerics", sorted(NUMERICS))
def test_bucketed_forward_matches_reference(setting_backend, numerics,
                                            overlap):
    setting, backend = setting_backend
    ref, params = _reference(setting, backend, numerics)
    _, g = _graphs(50, 260, 8, seed=3)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(10,), out_dim=4, sample=5,
                        numerics=gnn.CrossbarNumerics(**NUMERICS[numerics]))
    plan, got = _forward_scattered(g, cfg, gnn.params_from_numpy(
        params, device="cpu"), setting, backend, "auto", overlap=overlap)
    assert plan.bucketed is not None and plan.bucketed.covers()
    assert got.shape == ref.shape == (50, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_layout_stats_equal_reference(setting):
    g_jx, g_pt = _graphs(4000, 16000, 8, seed=0)
    kw = dict(sample=6, n_clusters=16, seed=0, buckets="auto")
    if setting == "decentralized":
        kw["partition_method"] = "edge"
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4,
                              sample=6)
    cfg_pt = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=6)
    for buckets in ("auto", None, 3):
        kw["buckets"] = buckets
        p_jx = jx_partition.plan_execution(g_jx, setting, **kw)
        p_pt = plan_execution(g_pt, setting, **kw)
        assert p_pt.layout_stats(cfg_pt) == p_jx.layout_stats(cfg_jx)
        assert p_pt.layout_stats() == p_jx.layout_stats()
    cent = dict(sample=6)
    assert plan_execution(g_pt, "centralized", **cent).layout_stats() == \
        jx_partition.plan_execution(g_jx, "centralized", **cent) \
        .layout_stats()


def test_rebucket_like_equals_reference():
    g_jx, g_pt = _graphs(60, 300, 8, seed=6)
    part_jx = jx_partition.partition(g_jx, 4, seed=0, sample=5,
                                     method="edge")
    part_pt = partition(g_pt, 4, seed=0, sample=5, method="edge")
    like_jx = jx_partition.bucket_partition(part_jx, g_jx, sample=5,
                                            max_buckets=1)
    like_pt = bucket_partition(part_pt, g_pt, sample=5, max_buckets=1)
    # a rebuilt partition (other seed, other method) re-bucketed like before
    moved_jx = jx_partition.partition(g_jx, 4, seed=3, sample=5,
                                      method="chunk")
    moved_pt = partition(g_pt, 4, seed=3, sample=5, method="chunk")
    a = jx_partition.bucket_partition(moved_jx, g_jx, sample=5,
                                      like=like_jx)
    b = bucket_partition(moved_pt, g_pt, sample=5, like=like_pt)
    assert (b.n_caps, b.h_caps, b.s_caps) == (a.n_caps, a.h_caps, a.s_caps)
    for x, y in zip(b.clusters, a.clusters):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_rebalance_equals_reference(frac):
    g_jx, g_pt = _graphs(200, 900, 4, seed=4)
    part_jx = jx_partition.partition(g_jx, 5, seed=1, sample=6)
    part_pt = partition(g_pt, 5, seed=1, sample=6)
    latency = np.array([1.0, 4.0, 0.5, 2.5, 0.8])
    a = jx_partition.rebalance(g_jx, part_jx, latency, frac=frac)
    b = rebalance(g_pt, part_pt, latency, frac=frac)
    assert not np.array_equal(b.assignment, part_pt.assignment)
    for name in ("assignment", "local_nodes", "local_mask", "halo_nodes",
                 "halo_src", "comm_volume"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert b.sample == a.sample == 6


def test_buckets_knob_parses_as_the_reference():
    _, g = _graphs(40, 200, 4, seed=0)
    for knob in (None, 0, "off", "dense", False):
        assert plan_execution(g, "decentralized", sample=4, n_clusters=3,
                              buckets=knob).bucketed is None
    for knob, most in (("auto", 99), (-1, 99), (True, 99), (2, 2), ("1", 1)):
        plan = plan_execution(g, "decentralized", sample=4, n_clusters=3,
                              buckets=knob)
        assert plan.bucketed is not None and plan.bucketed.n_buckets <= most
    with pytest.raises(ValueError, match="buckets"):
        plan_execution(g, "decentralized", sample=4, buckets=-3)
    with pytest.raises(ValueError, match="overlap"):
        plan_execution(g, "decentralized", sample=4, n_clusters=3,
                       buckets="auto").make_forward(
            gnn.GNNConfig(in_dim=4), overlap="eager", device="cpu")


# ------------------------------------- the reference's own cases, ported


@pytest.mark.parametrize("numerics", sorted(NUMERICS))
def test_bucketed_equals_dense_exactly(setting_backend, numerics):
    """Bit for bit: dense [K, n_max] padding vs per-bucket [K_b, n_cap]
    ragged layout, full 3-setting x 3-backend grid, both numerics."""
    setting, backend = setting_backend
    _, g = _graphs(50, 260, 8, seed=3)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(10,), out_dim=4, sample=5,
                        backend=backend,
                        numerics=gnn.CrossbarNumerics(**NUMERICS[numerics]))
    params = gnn.init_params(cfg, seed=1, device="cpu")
    _, ref = _forward_scattered(g, cfg, params, setting, backend, None)
    plan, out = _forward_scattered(g, cfg, params, setting, backend, "auto")
    assert plan.bucketed is not None and plan.bucketed.covers()
    assert np.array_equal(ref, out), \
        f"{setting}/{backend}: maxdiff {np.abs(ref - out).max()}"


def test_overlap_and_serial_schedules_identical():
    """The double-buffered (overlap) and serialized halo schedules are the
    same dataflow in a different order: identical outputs."""
    _, g = _graphs(60, 320, 8, seed=4)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(12,), out_dim=4, sample=6)
    params = gnn.init_params(cfg, seed=0, device="cpu")
    for setting in ("decentralized", "semi"):
        plan = plan_execution(g, setting, backend="jnp", sample=6,
                              n_clusters=4, seed=1, buckets="auto")
        a = plan.make_forward(cfg, overlap="overlap", device="cpu")(params)
        b = plan.make_forward(cfg, overlap="serial", device="cpu")(params)
        assert isinstance(a, tuple) and len(a) == plan.bucketed.n_buckets
        for x, y in zip(a, b):
            assert torch.equal(x, y), setting


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.sampled_from([30, 70, 120]),
       k=st.integers(2, 8), method=st.sampled_from(PARTITION_METHODS),
       max_buckets=st.sampled_from([0, 1, 2, 3]))
def test_property_buckets_cover_every_skewed_cluster(seed, n, k, method,
                                                     max_buckets):
    """Power-law graphs through every partition heuristic: each cluster
    lands in exactly one bucket whose capacities cover its rows, halo and
    sampled slots, also under a forced bucket-count cap (merging never
    drops a cluster)."""
    g = random_graph(n, 5 * n, 6, seed=seed % 9973).gcn_normalize()
    part = partition(g, min(k, n), seed=seed % 17, sample=4, method=method)
    bp = bucket_partition(part, g, sample=4, max_buckets=max_buckets)
    assert bp.covers()
    if max_buckets:
        assert bp.n_buckets <= max_buckets
    sizes = part.local_mask.sum(axis=1)
    seen = np.zeros(part.n_clusters, int)
    for b, cl in enumerate(bp.clusters):
        seen[cl] += 1
        assert bp.n_caps[b] >= int(sizes[cl].max())
        assert bp.s_caps[b] >= 1
        for c in cl.tolist():
            assert bp.bucket_of[c] == b
    assert (seen == 1).all()                    # a partition of the clusters
    assert bp.padded_rows() >= int(sizes.sum())
    assert bp.padded_rows() <= 2 * bp.dense_padded_rows() \
        + 8 * part.n_clusters


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.sampled_from([40, 90]),
       method=st.sampled_from(PARTITION_METHODS))
def test_property_bucketed_forward_equals_dense_on_skew(seed, n, method):
    """Numerical identity holds for arbitrary skewed partitions, not just
    the well-balanced BFS default of the parity grid."""
    g = random_graph(n, 6 * n, 6, seed=seed % 7919).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=3, sample=4)
    params = gnn.init_params(cfg, seed=seed % 13, device="cpu")
    _, ref = _forward_scattered(g, cfg, params, "decentralized", "jnp",
                                None, partition_method=method)
    plan, out = _forward_scattered(g, cfg, params, "decentralized", "jnp",
                                   "auto", partition_method=method)
    assert plan.bucketed is not None
    assert np.array_equal(ref, out), f"method={method}"


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), heads=st.integers(2, 6))
def test_property_hier_partition_buckets_cover_heads(seed, heads):
    """Semi's tier-1 head partition buckets the same way: the head-level
    clusters of a skewed two-tier hierarchy are covered, and the dense
    tables built from the same partition stay consistent with them."""
    g = random_graph(80, 400, 6, seed=seed % 4999).gcn_normalize()
    hier = hier_partition(g, heads, seed=seed % 23, sample=4)
    bp = bucket_partition(hier.region, g, sample=4)
    assert bp.covers()
    sub = build_local_subgraphs(g, hier.region, 4)
    sizes = hier.region.local_mask.sum(axis=1)
    for b, cl in enumerate(bp.clusters):
        assert bp.n_caps[b] >= int(sizes[cl].max())
        assert bp.s_caps[b] <= sub.neighbors.shape[-1]


def test_rebucket_like_keeps_groups_and_never_shrinks():
    """Re-bucketing with ``like=``: same cluster grouping, capacities only
    ever grow (stable tensor shapes across rebuilds)."""
    _, g = _graphs(60, 300, 8, seed=6)
    part = partition(g, 4, seed=0, sample=5, method="edge")
    bp0 = bucket_partition(part, g, sample=5)
    bp1 = bucket_partition(part, g, sample=5, like=bp0)
    assert [c.tolist() for c in bp1.clusters] == \
        [c.tolist() for c in bp0.clusters]
    for b in range(bp0.n_buckets):
        assert bp1.n_caps[b] >= bp0.n_caps[b]
        assert bp1.h_caps[b] >= bp0.h_caps[b]
        assert bp1.s_caps[b] >= bp0.s_caps[b]


def test_partition_method_dispatch():
    _, g = _graphs(40, 200, 6, seed=2)
    for method in PARTITION_METHODS:
        part = partition(g, 4, seed=0, sample=4, method=method)
        assert part.n_clusters == 4
        owned = np.sort(part.local_nodes[part.local_mask])
        assert np.array_equal(owned, np.arange(g.n_nodes))
    with pytest.raises(ValueError, match="method"):
        partition(g, 4, method="metis")


def test_layout_stats_report_bucketing_win_on_skew():
    """On a power-law graph with an edge-balanced partition the bucketed
    layout wastes strictly less padding than dense (at most half of it),
    and the stats price both from the same partition."""
    g = random_graph(4000, 16000, 8, seed=0).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(8,), out_dim=4, sample=6)
    plan = plan_execution(g, "decentralized", backend="jnp", sample=6,
                          n_clusters=16, seed=0, buckets="auto",
                          partition_method="edge")
    ls = plan.layout_stats(cfg)
    assert ls["layout"] == "bucketed"
    assert ls["real_rows"] == g.n_nodes
    assert ls["padded_rows"] < ls["dense_padded_rows"]
    assert ls["padding_ratio"] < ls["dense_padding_ratio"]
    assert ls["peak_device_bytes"] > 0
    waste = ls["padding_ratio"] - 1.0
    dense_waste = ls["dense_padding_ratio"] - 1.0
    assert waste <= 0.5 * dense_waste


def test_bucketed_plan_is_a_dataclass_copy_with_its_backend():
    """``dataclasses.replace(plan, backend=...)`` keeps the bucketed
    layout, as the servers and ``chip_smoke.py`` use it."""
    _, g = _graphs(50, 260, 8, seed=3)
    plan = plan_execution(g, "decentralized", sample=5, n_clusters=4,
                          buckets="auto")
    other = dataclasses.replace(plan, backend="fused")
    assert other.bucketed is plan.bucketed and other.backend == "fused"
