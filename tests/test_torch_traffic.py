"""The port's exchange-traffic accounting against the JAX package's.

``repro_torch.distributed.traffic`` is a copy of the reference's numpy
code, run on the port's own plans and halo tables, so its reports must be
equal to the reference's field for field, exactly — on the same seeded
graphs, for decentralized and semi, both exchange modes, dense and
``buckets="auto"``: ``measure_execution`` / ``ExecutionPlan.
measured_traffic``, ``measure_incremental`` with and without ``new_send``
slots, and ``modeled_frontier``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.distributed import halo as jx_halo
from repro.distributed import traffic as jx_traffic
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.distributed import halo, traffic

DIMS = dict(in_dim=8, hidden_dims=(8, 6), out_dim=4, sample=4)


def _plans(setting, buckets, n=60, e=400, seed=4):
    kw = dict(backend="jnp", sample=4, n_clusters=3, spokes_per_head=2,
              buckets=buckets)
    g_jx = jx_random_graph(n, e, 8, seed=seed).gcn_normalize()
    g_pt = random_graph(n, e, 8, seed=seed).gcn_normalize()
    return (jx_plan_execution(g_jx, setting, **kw),
            plan_execution(g_pt, setting, **kw))


def assert_reports_equal(got, ref) -> None:
    """Field for field, exactly; the derived byte counts too."""
    assert type(got).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(got.tier0_bytes(), ref.tier0_bytes())
    np.testing.assert_array_equal(got.tier1_bytes(), ref.tier1_bytes())
    assert got.total_bytes() == ref.total_bytes()
    assert got.summary() == ref.summary()


@pytest.mark.parametrize("buckets", [None, "auto"])
@pytest.mark.parametrize("mode", ["allgather", "alltoall"])
@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_measured_traffic_equals_reference(setting, mode, buckets):
    p_jx, p_pt = _plans(setting, buckets)
    cfg_jx = jx_gnn.GNNConfig(**DIMS)
    cfg_pt = gnn.GNNConfig(**DIMS)
    for cfgs in ((None, None), (cfg_jx, cfg_pt)):
        ref = p_jx.measured_traffic(cfgs[0], mode=mode)
        got = p_pt.measured_traffic(cfgs[1], mode=mode)
        assert_reports_equal(got, ref)
        assert_reports_equal(
            traffic.measure_execution(p_pt, cfg=cfgs[1], mode=mode), ref)
    if setting != "centralized":
        assert got.total_bytes() > 0


@pytest.mark.parametrize("mode", ["allgather", "alltoall"])
@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_exchange_rows_equal_reference(setting, mode):
    p_jx, p_pt = _plans(setting, None)
    h_jx = jx_halo.build_halo_plan(p_jx.part)
    h_pt = halo.build_halo_plan(p_pt.part)
    ref = jx_traffic.exchange_rows(h_jx, mode, p_jx.part.n_max)
    got = traffic.exchange_rows(h_pt, mode, p_pt.part.n_max)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if mode == "alltoall":   # the pruned comm_volume e_ij, by construction
        np.testing.assert_array_equal(got, p_pt.part.comm_volume)


@pytest.mark.parametrize("with_new_send", [False, True])
@pytest.mark.parametrize("mode", ["allgather", "alltoall"])
@pytest.mark.parametrize("setting", ["decentralized", "semi"])
def test_measure_incremental_equals_reference(setting, mode, with_new_send):
    p_jx, p_pt = _plans(setting, None)
    h_jx = jx_halo.build_halo_plan(p_jx.part)
    h_pt = halo.build_halo_plan(p_pt.part)
    rng = np.random.default_rng(7)
    n_layers = 3
    dirty = (rng.random((n_layers + 1,) + p_pt.part.local_mask.shape) < 0.3
             ) & p_pt.part.local_mask
    new_send = (rng.random(h_pt.send_mask.shape) < 0.2) & h_pt.send_mask \
        if with_new_send else None
    ref = jx_traffic.measure_incremental(
        p_jx, h_jx, dirty, jx_gnn.GNNConfig(**DIMS), mode=mode,
        new_send=new_send)
    got = traffic.measure_incremental(
        p_pt, h_pt, dirty, gnn.GNNConfig(**DIMS), mode=mode,
        new_send=new_send)
    assert_reports_equal(got, ref)
    # the incremental exchange never ships more than the full one
    full = p_pt.measured_traffic(gnn.GNNConfig(**DIMS), mode=mode)
    assert (got.tier1_rows <= full.tier1_rows[None]).all()
    if mode == "alltoall" and with_new_send:
        bare = traffic.measure_incremental(
            p_pt, h_pt, dirty, gnn.GNNConfig(**DIMS), mode=mode)
        assert got.total_bytes() >= bare.total_bytes()


@pytest.mark.parametrize("seed_frac,frac", [(0.0, 0.0), (0.05, 0.3),
                                            (0.2, 1.0), (1.5, -1.0)])
def test_modeled_frontier_equals_reference(seed_frac, frac):
    p_jx, p_pt = _plans("decentralized", None)
    ref = jx_traffic.modeled_frontier(p_jx.part, seed_frac, frac, 2)
    got = traffic.modeled_frontier(p_pt.part, seed_frac, frac, 2)
    assert got.dtype == ref.dtype == bool
    np.testing.assert_array_equal(got, ref)
    h_jx = jx_halo.build_halo_plan(p_jx.part)
    h_pt = halo.build_halo_plan(p_pt.part)
    assert_reports_equal(
        traffic.measure_incremental(p_pt, h_pt, got),
        jx_traffic.measure_incremental(p_jx, h_jx, ref))
