"""The port's crossbar mapper (``repro_torch.mapper``) against the
reference's, on the cases of ``tests/test_mapper.py`` and
``tests/test_mapper_edges.py``.

The mapper is plain Python and numpy in both packages: every
``CompiledMapping`` field and every ``mapping_report()`` must be equal,
and so must ``ExecutionPlan.predicted_metrics``, ``compile_mapping`` and
``mapping_report`` on dense, bucketed and semi plans. The end-to-end
cases run the port's forward on CPU tensors against the reference's, at
the tolerance of the reference's own tests (rtol 1e-4).
"""
import dataclasses

import jax
import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import costmodel as jx_cost
from repro.core import gnn as jx_gnn
from repro.core.graph import GraphStats as JxStats
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro.mapper import XbarInventory as JxInventory
from repro.mapper import execute_tiled as jx_execute_tiled
from repro.mapper import padded_grid as jx_padded_grid
from repro.mapper import tile_layer as jx_tile_layer
from repro.mapper.allocate import allocate as jx_allocate
from repro.mapper.compile import compile_mapping as jx_compile
from repro_torch.core import costmodel, gnn
from repro_torch.core.graph import (Graph, GraphStats, TABLE2_DATASETS,
                                    TAXI_STATS, random_graph)
from repro_torch.core.partition import plan_execution
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics
from repro_torch.mapper import (XbarInventory, execute_tiled, padded_grid,
                                tile_layer)
from repro_torch.mapper.allocate import allocate
from repro_torch.mapper.compile import compile_mapping, items_per_device

SETTINGS = ("centralized", "decentralized", "semi")


def jx_stats(s: GraphStats) -> JxStats:
    return JxStats(*dataclasses.astuple(s))


def jx_inv(inv: XbarInventory) -> JxInventory:
    return JxInventory(**dataclasses.asdict(inv))


def same_mapping(a, b) -> None:
    """Field for field, the derived rollups and the report text."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("t_traversal", "t_aggregation", "t_fx", "t_compute",
                 "t_compute_pipelined", "energy_j", "weight_arrays",
                 "weight_utilization", "array_utilization"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.mapping_report() == b.mapping_report()


def both(dims, stats, inventory=None, **kw):
    pt = compile_mapping(dims, stats, inventory=inventory, **kw)
    jx = jx_compile(dims, jx_stats(stats),
                    inventory=None if inventory is None else jx_inv(inventory),
                    **kw)
    same_mapping(pt, jx)
    return pt


# ---------------------------------------------------------------- tiling

@settings(max_examples=30, deadline=None)
@given(f_in=st.integers(1, 400), f_out=st.integers(1, 200),
       rows=st.integers(1, 96), cols=st.integers(1, 96),
       seed=st.integers(0, 2**31 - 1))
def test_property_tiled_execution_equals_dense(f_in, f_out, rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, size=(5, f_in)).astype(np.float64)
    w = rng.integers(-8, 9, size=(f_in, f_out)).astype(np.float64)
    t = tile_layer(f_in, f_out, rows, cols)
    assert dataclasses.asdict(t) == dataclasses.asdict(
        jx_tile_layer(f_in, f_out, rows, cols))
    out = execute_tiled(x, w, t)
    np.testing.assert_array_equal(out, x @ w)
    np.testing.assert_array_equal(out, jx_execute_tiled(
        x, w, jx_tile_layer(f_in, f_out, rows, cols)))


def test_padded_grid_divisibility_and_minimality():
    g = padded_grid(33, 216, 100, rows_per_xbar=128, bm=8, bn=16)
    jg = jx_padded_grid(33, 216, 100, rows_per_xbar=128, bm=8, bn=16)
    assert (g.m_pad, g.k_pad, g.n_pad, g.grid, g.k_tiles) == (
        jg.m_pad, jg.k_pad, jg.n_pad, jg.grid, jg.k_tiles)
    assert g.m_pad % g.bm == 0 and g.k_pad % g.bk == 0 and g.n_pad % g.bn == 0
    assert g.grid == (g.m_pad // 8, g.n_pad // 16, g.k_pad // 128)
    with pytest.raises(ValueError):
        padded_grid(0, 216, 100, 128)
    with pytest.raises(ValueError):
        padded_grid(1, 1, 1, 0)


@pytest.mark.parametrize("cell_bits", [1, 2, 4, 8])
def test_bit_slicing_plan(cell_bits):
    t = tile_layer(216, 128, rows=128, cols=128, w_bits=8,
                   cell_bits=cell_bits)
    j = jx_tile_layer(216, 128, rows=128, cols=128, w_bits=8,
                      cell_bits=cell_bits)
    for name in ("bit_slices", "logical_cols", "k_tiles", "n_tiles",
                 "n_arrays", "pad_k", "pad_n", "utilization"):
        assert getattr(t, name) == getattr(j, name), name
    base = tile_layer(216, 128, rows=128, cols=128)
    assert t.n_arrays == t.bit_slices * base.n_arrays
    assert t.utilization == pytest.approx(base.utilization)
    with pytest.raises(ValueError):
        tile_layer(8, 8, rows=8, cols=2, w_bits=8, cell_bits=1)


def test_tiling_matches_calibration_workload():
    t = tile_layer(216, 128, rows=128, cols=128)
    assert t.n_arrays == 2 and t.k_tiles == 2 and t.n_tiles == 1
    assert t.pad_k == 40 and t.pad_n == 0
    assert 0.8 < t.utilization < 0.9


# ------------------------------------------------------------ allocation

@pytest.mark.parametrize("tiles,items,arrays", [
    (10, 4, 3), (2, 1000, 256), (2, 1000, 512), (1, 500, 1), (3, 500, 8),
    (7, 500, 64), (7, 500, 1024), (4, 0, 16)])
def test_allocation_matches_reference(tiles, items, arrays):
    a = allocate("fx", tiles, items, arrays)
    j = jx_allocate("fx", tiles, items, arrays)
    for name in ("groups", "copies", "rounds", "tile_passes", "arrays_used",
                 "occupancy", "resident"):
        assert getattr(a, name) == getattr(j, name), name


def test_allocation_scarce_serializes():
    a = allocate("fx", tiles_per_item=10, n_items=4, arrays=3)
    assert a.groups == 4 and a.copies == 1 and not a.resident
    assert a.rounds == 4 * 4 and a.tile_passes == 40 and a.arrays_used == 3


def test_allocation_plentiful_duplicates():
    a = allocate("fx", tiles_per_item=2, n_items=1000, arrays=256)
    assert a.copies == 128 and a.groups == 1 and a.resident
    assert a.rounds == -(-1000 // 128)
    b = allocate("fx", tiles_per_item=2, n_items=1000, arrays=512)
    assert b.rounds <= a.rounds


def test_allocation_monotone_in_arrays():
    for tiles in (1, 3, 7):
        rounds = [allocate("agg", tiles, 500, arrays).rounds
                  for arrays in (1, 2, 8, 64, 1024)]
        assert rounds == sorted(rounds, reverse=True)
        assert rounds[-1] >= 1


# ------------------------------------- derived vs calibrated cross-check

@pytest.mark.parametrize("setting", ["centralized", "decentralized"])
def test_derived_matches_calibrated_at_paper_geometry(setting):
    cal = costmodel.predict(setting, TAXI_STATS)
    der = costmodel.predict(setting, TAXI_STATS, mode="derived")
    assert dataclasses.asdict(der) == dataclasses.asdict(jx_cost.predict(
        setting, jx_stats(TAXI_STATS), mode="derived"))
    assert der.t_compute == pytest.approx(cal.t_compute, rel=0.10)
    for core in ("traversal", "aggregation", "feature_extraction"):
        assert getattr(der.compute, core) == pytest.approx(
            getattr(cal.compute, core), rel=0.10)


def test_derived_diverges_beyond_calibration():
    stats = TABLE2_DATASETS["cora"]
    cal = costmodel.predict("centralized", stats)
    der = costmodel.predict("centralized", stats, mode="derived")
    assert der.t_compute > cal.t_compute * 1.5


@pytest.mark.parametrize("size", [None, 64, 256, 1024])
@pytest.mark.parametrize("iso", [False, True])
def test_derived_sees_geometry(size, iso):
    inv = XbarInventory.from_hardware(costmodel.DEFAULT_HW, "centralized")
    if size is not None:
        inv = inv.with_xbar_size(size, iso_cells=iso)
    der = costmodel.predict("centralized", TAXI_STATS, mode="derived",
                            inventory=inv)
    jder = jx_cost.predict("centralized", jx_stats(TAXI_STATS),
                           mode="derived", inventory=jx_inv(inv))
    assert dataclasses.asdict(der) == dataclasses.asdict(jder)
    if size == 64:
        paper = costmodel.predict("centralized", TAXI_STATS, mode="derived")
        assert der.t_compute != pytest.approx(paper.t_compute, rel=1e-3)


@pytest.mark.parametrize("tech", ["sot-mram", "reram", "sram", "fefet"])
@pytest.mark.parametrize("setting", SETTINGS)
def test_compile_mapping_matches_reference(setting, tech):
    m = both((216, 128, 16), TAXI_STATS, setting=setting, n_clusters=16,
             technology=tech)
    for needle in (f"CompiledMapping[{setting}]", "inventory:", "layer 0",
                   "allocation:", "T_compute", tech):
        assert needle in m.mapping_report(), needle


def test_compile_mapping_report_and_energy():
    m = both((216, 128), TAXI_STATS, setting="centralized")
    assert m.energy_j > 0
    assert 0 < m.weight_utilization <= 1
    assert m.t_compute_pipelined <= m.t_compute
    assert items_per_device("centralized", 10_000) == 9999
    assert items_per_device("decentralized", 10_000) == 1
    assert items_per_device("semi", 10_000, 16) == 624


def test_compile_mapping_bit_slices_on_low_precision_cells():
    base = both((216, 128), TAXI_STATS, setting="centralized")
    inv2 = dataclasses.replace(base.inventory, cell_bits=2)
    sliced = both((216, 128), TAXI_STATS, setting="centralized",
                  inventory=inv2)
    assert sliced.layers[0].tiling.bit_slices == 4
    assert sliced.weight_arrays == 4 * base.weight_arrays
    assert sliced.energy_j > base.energy_j


def test_compile_mapping_validates_inputs():
    with pytest.raises(ValueError):
        compile_mapping((216,), TAXI_STATS)
    with pytest.raises(ValueError):
        compile_mapping((216, 128), TAXI_STATS, setting="federated")
    with pytest.raises(ValueError):
        XbarInventory(fx_arrays=0)
    from repro_torch.devices import UnknownTechnologyError
    with pytest.raises(UnknownTechnologyError):
        compile_mapping((216, 128), TAXI_STATS, technology="memristor-x")


# --------------------------------------------- end-to-end through the plan

def _plans(setting, backend="fused", buckets=None, f=216, n=64, e=400):
    kw = dict(backend=backend, sample=4, buckets=buckets,
              n_clusters=None if setting == "centralized" else 4,
              spokes_per_head=2)
    g = random_graph(n, e, f, seed=0).gcn_normalize()
    jg = jx_random_graph(n, e, f, seed=0).gcn_normalize()
    return (plan_execution(g, setting, **kw),
            jx_plan_execution(jg, setting, **kw))


@pytest.mark.parametrize("buckets", [None, "auto"])
@pytest.mark.parametrize("setting", SETTINGS)
def test_plan_methods_match_reference(setting, buckets):
    """``predicted_metrics`` (both modes), ``compile_mapping`` and
    ``mapping_report`` on dense, bucketed and semi plans."""
    plan, jplan = _plans(setting, buckets=buckets)
    cfg = gnn.GNNConfig(in_dim=216, hidden_dims=(40,), out_dim=8, sample=4)
    jcfg = jx_gnn.GNNConfig(in_dim=216, hidden_dims=(40,), out_dim=8,
                            sample=4)
    for kw in (dict(), dict(workload_scaled=True), dict(mode="derived"),
               dict(mode="derived", technology="sram")):
        assert dataclasses.asdict(plan.predicted_metrics(**kw)) == \
            dataclasses.asdict(jplan.predicted_metrics(**kw))
    same_mapping(plan.compile_mapping(cfg), jplan.compile_mapping(jcfg))
    assert plan.mapping_report() == jplan.mapping_report()
    assert plan.mapping_report(technology="fefet") == \
        jplan.mapping_report(technology="fefet")


def test_plan_carries_mapping():
    plan, _ = _plans("decentralized")
    plan = dataclasses.replace(plan, mapping=None)
    cfg = gnn.GNNConfig(in_dim=216, hidden_dims=(40,), out_dim=8, sample=4)
    rep = plan.mapping_report(cfg)
    assert "216x40" in rep and plan.mapping is not None
    assert plan.mapping.setting == "decentralized"
    assert plan.mapping_report() == rep
    slow = dataclasses.replace(costmodel.DEFAULT_HW,
                               t2=costmodel.DEFAULT_HW.t2 * 100)
    assert plan.mapping_report(hw=slow) != rep


def test_unmappable_shape_executes_via_mapper_padding():
    """F_in = 216 on 128-row crossbars runs end to end through the plan on
    ``fused`` with bit-accurate numerics, as the reference's does."""
    quant = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=128)
    g = random_graph(48, 300, 216, seed=1).gcn_normalize()
    jg = jx_random_graph(48, 300, 216, seed=1).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=216, hidden_dims=(40,), out_dim=8, sample=4,
                        numerics=CrossbarNumerics(**quant), backend="fused")
    jcfg = jx_gnn.GNNConfig(in_dim=216, hidden_dims=(40,), out_dim=8,
                            sample=4, numerics=JxNumerics(**quant),
                            backend="fused")
    jparams = jx_gnn.init_params(jax.random.key(0), jcfg)
    params = gnn.params_from_numpy(jparams, device="cpu")
    plan = plan_execution(g, "centralized", backend="fused", sample=4)
    out = plan.scatter(plan.make_forward(cfg, device="cpu")(params))
    jplan = jx_plan_execution(jg, "centralized", backend="jnp", sample=4)
    ref = jplan.scatter(np.asarray(jplan.make_forward(jcfg)(jparams)))
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)
    grid = padded_grid(48, 216, 40, 128)
    assert grid.k_pad == 256 and grid.k_tiles == 2


# ------------------------------------------------------------ edge cases

def _zero_edge_graph(n: int = 9, f: int = 6) -> Graph:
    rng = np.random.default_rng(0)
    return Graph(np.zeros(n + 1, np.int64), np.zeros(0, np.int32), None,
                 rng.normal(size=(n, f)).astype(np.float32))


@pytest.mark.parametrize("setting", SETTINGS)
def test_zero_edge_stats_compile(setting):
    stats = GraphStats("empty", 32, 0, 8, 0.0)
    m = both((8, 16), stats, setting=setting, n_clusters=4)
    assert m.cam.rounds >= 1 and m.agg.rounds >= 1 and m.fx.rounds >= 1
    assert m.t_compute > 0 and m.energy_j > 0
    assert all(0 < occ <= 1.0 for occ in m.array_utilization)


def test_zero_edge_graph_serves_end_to_end():
    g = _zero_edge_graph().gcn_normalize()
    np.testing.assert_allclose(g.self_loop, 1.0)
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    params = gnn.init_params(cfg, seed=0, device="cpu")
    cent = plan_execution(g, "centralized", sample=4)
    ref = cent.scatter(cent.make_forward(cfg, device="cpu")(params))
    dec = plan_execution(g, "decentralized", sample=4, n_clusters=3)
    out = dec.scatter(dec.make_forward(cfg, device="cpu")(params))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert dec.part.comm_volume.sum() == 0
    assert dataclasses.asdict(dec.predicted_metrics()) == \
        dataclasses.asdict(jx_cost.predict(
            "decentralized", jx_stats(g.stats("plan")), n_clusters=3,
            sample=4))


def test_single_node_clusters_compile_and_run():
    assert items_per_device("semi", 8, 8) == 1
    assert items_per_device("semi", 8, 100) == 1
    stats = GraphStats("tiny", 8, 24, 6, 3.0)
    m = both((6, 16), stats, setting="semi", n_clusters=8)
    assert m.items_per_device == 1 and m.t_compute > 0
    g = random_graph(8, 24, 6, seed=3).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=6, hidden_dims=(8,), out_dim=4, sample=4)
    params = gnn.init_params(cfg, seed=0, device="cpu")
    cent = plan_execution(g, "centralized", sample=4)
    ref = cent.scatter(cent.make_forward(cfg, device="cpu")(params))
    plan = plan_execution(g, "decentralized", sample=4, n_clusters=8)
    assert plan.part.n_max == 1
    out = plan.scatter(plan.make_forward(cfg, device="cpu")(params))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_scarce_inventory_serializes_never_duplicates():
    inv = XbarInventory(cam_arrays=1, agg_arrays=1, fx_arrays=1)
    stats = GraphStats("wide", 100, 1000, 1433, 10.0)
    m = both((1433, 128), stats, setting="centralized", inventory=inv)
    t = m.layers[0].tiling
    assert t.k_tiles == 12 and t.n_tiles == 1
    assert m.fx.copies == 1 and m.fx.groups == 12 and not m.fx.resident
    assert m.fx.rounds == m.fx.n_items * 12
    rich = both((1433, 128), stats, setting="centralized")
    assert m.t_compute > rich.t_compute
    assert m.energy_j == pytest.approx(rich.energy_j)


def test_with_xbar_size_overflows_both_axes():
    inv = XbarInventory().with_xbar_size(64)
    stats = GraphStats("g", 500, 5000, 216, 10.0)
    m = both((216, 300, 16), stats, setting="centralized", inventory=inv)
    t0 = m.layers[0].tiling
    assert (t0.rows, t0.cols, t0.k_tiles, t0.n_tiles, t0.n_arrays) == (
        64, 64, 4, 5, 20)
    assert m.weight_arrays == sum(lm.tiling.n_arrays for lm in m.layers)
    iso = XbarInventory().with_xbar_size(64, iso_cells=True)
    assert dataclasses.asdict(iso) == dataclasses.asdict(
        JxInventory().with_xbar_size(64, iso_cells=True))
    assert iso.fx_arrays * 64 * 64 <= XbarInventory().total_cells[2]


def test_documented_value_errors_not_silent_misschedules():
    stats = GraphStats("g", 100, 1000, 16, 4.0)
    with pytest.raises(ValueError, match="cannot hold"):
        tile_layer(8, 8, rows=8, cols=4, w_bits=8, cell_bits=1)
    with pytest.raises(ValueError, match="cannot hold"):
        compile_mapping(
            (16, 8), stats,
            inventory=dataclasses.replace(XbarInventory().with_xbar_size(4),
                                          cell_bits=1))
    with pytest.raises(ValueError, match="positive layer dims"):
        compile_mapping((16, 0), stats)
    with pytest.raises(ValueError, match=">= 1"):
        XbarInventory(agg_arrays=0)
    with pytest.raises(ValueError, match="centralized"):
        compile_mapping((16, 8), stats, setting="federated")


@pytest.mark.parametrize("setting", SETTINGS)
def test_planner_sweep_space_compiles_everywhere(setting):
    hostile = (GraphStats("empty", 16, 0, 4, 0.0),
               GraphStats("one", 1, 0, 4, 0.0),
               GraphStats("wide", 64, 600, 3703, 2.0))
    for stats in hostile:
        for k in (1, 4, 64):
            for size in (None, 64, 512):
                inv = XbarInventory.from_hardware(costmodel.DEFAULT_HW,
                                                  setting)
                if size is not None:
                    inv = inv.with_xbar_size(size)
                m = both((max(stats.feature_len, 1), 32), stats,
                         inventory=inv, setting=setting, n_clusters=k)
                assert m.t_compute > 0
                assert m.cam.rounds >= 1 and m.fx.rounds >= 1
