"""The port's plan forward against the JAX package's, and its host tables.

One graph and one set of parameters (the reference's ``init_params``,
carried over by ``params_from_numpy``) go through
``repro.core.partition.plan_execution(...).make_forward`` and through
``repro_torch``'s on CPU tensors, on 3 settings x 3 backends x {ideal,
bit-accurate} x {allgather, alltoall}. Tolerance rtol 1e-4, atol
1e-4 * max|ref|, as the reference's own grid (``test_semi_runtime.py``,
``test_kernels_fused_layer.py``). The host tables are copies of the
reference's numpy code, so they must be equal, not close.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from repro.core import gnn as jx_gnn
from repro.core.graph import dataset_like as jx_dataset_like
from repro.core.graph import random_graph as jx_random_graph
from repro.core.partition import plan_execution as jx_plan_execution
from repro.distributed import halo as jx_halo
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro_torch.core import gnn
from repro_torch.core.graph import dataset_like, random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.distributed import halo
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics

QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
NUMERICS = {"ideal": dict(ideal=True), "bit-accurate": QUANT}


@pytest.fixture(scope="module")
def case():
    g_jx = jx_random_graph(40, 200, 8, seed=0).gcn_normalize()
    g_pt = random_graph(40, 200, 8, seed=0).gcn_normalize()
    return g_jx, g_pt


@pytest.mark.parametrize("numerics", sorted(NUMERICS))
@pytest.mark.parametrize("setting,mode", [
    ("centralized", "alltoall"),
    ("decentralized", "allgather"), ("decentralized", "alltoall"),
    ("semi", "allgather"), ("semi", "alltoall")])
def test_plan_forward_matches_reference(case, setting, mode, backend,
                                        numerics):
    g_jx, g_pt = case
    kw = dict(sample=8, n_clusters=3, spokes_per_head=2)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4,
                              sample=8,
                              numerics=JxNumerics(**NUMERICS[numerics]))
    params = jx_gnn.init_params(jax.random.key(0), cfg_jx)
    plan_jx = jx_plan_execution(g_jx, setting, backend=backend, **kw)
    ref = plan_jx.scatter(np.asarray(
        plan_jx.make_forward(cfg_jx, mode=mode)(params)))

    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4, sample=8,
                        numerics=CrossbarNumerics(**NUMERICS[numerics]))
    plan = plan_execution(g_pt, setting, backend=backend, **kw)
    out = plan.make_forward(cfg, mode=mode, device="cpu")(
        gnn.params_from_numpy(params, device="cpu"))
    got = plan.scatter(out)
    assert got.shape == ref.shape == (40, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_host_tables_equal_reference(setting):
    g_jx = jx_dataset_like("taxi", scale=0.01, seed=2).gcn_normalize()
    g_pt = dataset_like("taxi", scale=0.01, seed=2).gcn_normalize()
    for name in ("indptr", "indices", "edge_weight", "features",
                 "self_loop"):
        np.testing.assert_array_equal(getattr(g_pt, name),
                                      getattr(g_jx, name))
    kw = dict(sample=4, n_clusters=4, spokes_per_head=3)
    p_jx = jx_plan_execution(g_jx, setting, **kw)
    p_pt = plan_execution(g_pt, setting, **kw)
    assert p_pt.n_clusters == p_jx.n_clusters
    for name in ("neighbors", "weights", "feats"):
        np.testing.assert_array_equal(getattr(p_pt, name),
                                      getattr(p_jx, name))
    if setting == "centralized":
        return
    for name in ("assignment", "local_nodes", "local_mask", "halo_nodes",
                 "halo_src", "comm_volume"):
        np.testing.assert_array_equal(getattr(p_pt.part, name),
                                      getattr(p_jx.part, name))
    if setting == "semi":
        t_jx = jx_halo.build_two_tier_plan(p_jx.hier)
        t_pt = halo.build_two_tier_plan(p_pt.hier)
        for name in ("gather_spoke", "gather_slot", "gather_mask"):
            np.testing.assert_array_equal(getattr(t_pt, name),
                                          getattr(t_jx, name))
        assert t_pt.n_max == t_jx.n_max
        h_jx, h_pt = t_jx.region, t_pt.region
    else:
        h_jx = jx_halo.build_halo_plan(p_jx.part)
        h_pt = halo.build_halo_plan(p_pt.part)
    for f in dataclasses.fields(h_jx):
        np.testing.assert_array_equal(getattr(h_pt, f.name),
                                      getattr(h_jx, f.name))


def test_exchange_modes_give_identical_halos(case):
    """allgather and alltoall fill the same halo table, exactly."""
    _, g = case
    plan = plan_execution(g, "decentralized", sample=8, n_clusters=3)
    hp = halo.build_halo_plan(plan.part)
    t = halo._plan_consts(hp, "cpu")
    x = torch.from_numpy(plan.feats)
    ag = halo._emulated_exchange(x, t, "allgather", hp.src_cluster.shape[1])
    aa = halo._emulated_exchange(x, t, "alltoall", hp.src_cluster.shape[1])
    assert torch.equal(ag, aa)


def test_untranslated_plan_options_raise(case):
    """The plan options that once raised are ported: the bucketed layout
    computes what the dense layout does, and the cost-model prediction,
    the crossbar mapping and kernel tuning (nothing to tune on ``jnp``)
    answer as the reference's (``measured_traffic``: see the next
    test)."""
    g_jx, g = case
    cfg = gnn.GNNConfig(in_dim=8, sample=8)
    params = gnn.init_params(cfg, seed=0, device="cpu")
    bucketed = plan_execution(g, "decentralized", sample=8, n_clusters=3,
                              buckets="auto")
    plan = plan_execution(g, "decentralized", sample=8, n_clusters=3)
    assert bucketed.bucketed is not None and plan.bucketed is None
    np.testing.assert_array_equal(
        bucketed.scatter(bucketed.make_forward(cfg, device="cpu")(params)),
        plan.scatter(plan.make_forward(cfg, device="cpu")(params)))
    plan_jx = jx_plan_execution(g_jx, "decentralized", sample=8,
                                n_clusters=3)
    assert dataclasses.asdict(plan.predicted_metrics()) == \
        dataclasses.asdict(plan_jx.predicted_metrics())
    assert plan.mapping_report() == plan_jx.mapping_report()
    tuned = plan.tune_kernels(cfg, device="cpu")
    assert len(tuned) == 0 and plan.gnn_config(cfg).tuned is tuned


@pytest.mark.parametrize("mode", ["allgather", "alltoall"])
def test_measured_traffic_equals_reference(case, mode):
    """``measured_traffic`` is ported: on the plan of the case above it
    equals the reference's report field for field."""
    g_jx, g = case
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4, sample=8)
    cfg_jx = jx_gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4,
                              sample=8)
    plan = plan_execution(g, "decentralized", sample=8, n_clusters=3)
    plan_jx = jx_plan_execution(g_jx, "decentralized", sample=8,
                                n_clusters=3)
    got = plan.measured_traffic(cfg, mode=mode)
    ref = plan_jx.measured_traffic(cfg_jx, mode=mode)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.total_bytes() == ref.total_bytes() > 0


def test_init_params_is_seeded_and_glorot_scaled():
    cfg = gnn.GNNConfig(in_dim=300, hidden_dims=(200,), out_dim=16)
    a = gnn.init_params(cfg, seed=3, device="cpu")
    b = gnn.init_params(cfg, seed=3, device="cpu")
    assert [tuple(p["w"].shape) for p in a] == [(300, 200), (200, 16)]
    assert all(np.array_equal(p["w"], q["w"]) for p, q in zip(a, b))
    std = float(a[0]["w"].std())
    assert abs(std - np.sqrt(2.0 / 500)) < 0.05 * np.sqrt(2.0 / 500)
    assert all(float(p["b"].abs().sum()) == 0.0 for p in a)


@pytest.mark.parametrize("numerics", [QUANT, dict()])
@pytest.mark.parametrize("setting", ["centralized", "semi"])
def test_bit_accurate_fused_equals_composed_exactly(setting, numerics):
    """The fused bit-accurate layer rounds as the composed oracle does, so
    a two-layer forward is equal on both, not just close: one ulp in a
    layer's output could move a DAC code of the next layer by an ADC
    step."""
    g = random_graph(60, 400, 40, seed=3).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=40, hidden_dims=(24,), out_dim=6, sample=6,
                        numerics=CrossbarNumerics(**numerics))
    params = gnn.init_params(cfg, seed=1, device="cpu")
    outs = [plan_execution(g, setting, backend=b, sample=6,
                           n_clusters=3).make_forward(cfg, device="cpu")(
                               params) for b in ("jnp", "fused")]
    assert torch.equal(outs[0], outs[1])


def test_multilayer_fused_drivers_match_reference():
    """``fused_gnn_forward`` / ``fused_gnn_forward_batched`` on the case
    of ``tests/test_kernels_fused_layer.py``'s multi-layer driver test,
    against the reference's drivers and ``core.gnn.forward``, rtol/atol
    1e-5."""
    import jax.numpy as jnp
    from repro.kernels.fused_layer import (
        fused_gnn_forward as jx_forward,
        fused_gnn_forward_batched as jx_batched)
    from repro_torch.kernels.fused_layer import (fused_gnn_forward,
                                                 fused_gnn_forward_batched)
    g = random_graph(40, 200, 24, seed=5).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(32, 16), out_dim=6,
                        sample=8)
    jparams = jx_gnn.init_params(jax.random.key(0), jx_gnn.GNNConfig(
        in_dim=24, hidden_dims=(32, 16), out_dim=6, sample=8))
    params = gnn.params_from_numpy(
        [{k: np.asarray(v) for k, v in l.items()} for l in jparams],
        device="cpu")
    nbr, wts = g.neighbor_sample(8)
    args = (torch.from_numpy(g.features), torch.from_numpy(nbr),
            torch.from_numpy(wts))
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    for kw in NUMERICS.values():
        numerics, jnum = CrossbarNumerics(**kw), JxNumerics(**kw)
        ref = np.asarray(jx_forward(jparams, *jargs, jnum))
        out = fused_gnn_forward(params, *args, numerics)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(out, gnn.forward(params, *args, dataclasses.replace(
            cfg, numerics=numerics, backend="fused")))
        jb = np.asarray(jx_batched(jparams, *(jnp.stack([a, a])
                                              for a in jargs), jnum))
        batched = fused_gnn_forward_batched(
            params, *(torch.stack([a, a]) for a in args), numerics)
        for k in range(2):
            np.testing.assert_allclose(batched[k].numpy(), jb[k],
                                       rtol=1e-5, atol=1e-5)
            assert torch.equal(batched[k], out)


def test_quickstart_runs_on_cpu_and_matches_reference_guideline(capsys):
    """``repro_torch.examples.quickstart --device cpu``: its lines, and
    the same guideline pick as the reference's cost model."""
    from repro.core import costmodel as jx_costmodel
    from repro_torch.examples import quickstart
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "argmax agreement" in out and "guideline picks:" in out
    assert 0.0 <= res["agree"] <= 1.0 and np.isfinite(res["err"])
    g = jx_dataset_like("cora", scale=0.25, seed=0).gcn_normalize()
    assert res["best"] == jx_costmodel.pick_setting(g.stats("cora-like"))[0]
