"""The port's GNNServer contracts, its CLI, and the port's guards.

The server contracts are those of ``tests/test_gnn_server.py`` for the
JAX package, run on the port with ``device="cpu"``; one more case holds
the served embeddings to the reference server's at rtol/atol 1e-4.
The guards: no file of ``src/repro_torch/`` or ``chip_smoke.py`` imports
JAX or the JAX package, and an entry point asked for CUDA on a host
without it raises instead of running on the CPU.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import devices, neighbors
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.distributed import halo
from repro_torch.launch.gnn import GNNServer, main

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _server(seed=0, **plan_kw):
    g = random_graph(40, 200, 24, seed=seed).gcn_normalize()
    plan = plan_execution(g, plan_kw.pop("setting", "centralized"),
                          sample=4, **plan_kw)
    cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(16,), out_dim=8, sample=4)
    return GNNServer(plan, cfg, seed=seed, device="cpu"), cfg, g


def test_query_refreshes_on_param_update():
    srv, cfg, _ = _server()
    ids = np.arange(5)
    first = srv.query(ids).copy()
    assert srv.refreshes == 1
    srv.query(ids)
    assert srv.refreshes == 1 and not srv.stale
    srv.update_params(gnn.init_params(srv.cfg, seed=123, device="cpu"))
    assert srv.stale
    second = srv.query(ids)
    assert srv.refreshes == 2
    assert not np.allclose(first, second)


def test_query_refreshes_on_plan_update():
    srv, cfg, _ = _server()
    srv.query(np.arange(3))
    assert srv.refreshes == 1
    g2 = random_graph(40, 200, 24, seed=7).gcn_normalize()
    srv.update_plan(plan_execution(g2, "centralized", sample=4), cfg)
    assert srv.stale
    srv.query(np.arange(3))
    assert srv.refreshes == 2 and not srv.stale


def test_explicit_refresh_clears_staleness():
    srv, _, _ = _server()
    srv.update_params(srv.params)
    srv.refresh()
    assert not srv.stale
    srv.query(np.arange(2))
    assert srv.refreshes == 1


def test_batched_query_handles_duplicates_and_shape():
    srv, _, _ = _server()
    ids = np.array([3, 7, 3, 0, 7, 7])
    out = srv.query(ids)
    assert out.shape == (6, srv.cfg.out_dim)
    np.testing.assert_array_equal(out[0], out[2])
    np.testing.assert_array_equal(out[1], out[4])
    np.testing.assert_array_equal(out, srv.embeddings[ids])
    out2 = srv.query(ids.reshape(2, 3))
    assert out2.shape == (2, 3, srv.cfg.out_dim)
    np.testing.assert_array_equal(out2.reshape(6, -1), out)


def test_query_rejects_out_of_range_ids():
    srv, _, g = _server()
    with pytest.raises(IndexError):
        srv.query([0, g.n_nodes])
    with pytest.raises(IndexError):
        srv.query([-1])
    assert srv.query(np.zeros(0, np.int64)).shape == (0, srv.cfg.out_dim)


def test_update_plan_to_different_node_count_swaps_staleness_domain():
    srv, cfg, g = _server()
    srv.query([g.n_nodes - 1])
    g2 = random_graph(24, 120, 24, seed=11).gcn_normalize()
    srv.update_plan(plan_execution(g2, "centralized", sample=4), cfg)
    assert srv.stale
    out = srv.query(np.arange(24))
    assert out.shape == (24, cfg.out_dim) and srv.refreshes == 2
    with pytest.raises(IndexError):
        srv.query([g.n_nodes - 1])


@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_served_embeddings_match_reference_server(setting):
    """The port's server and the reference's serve the same embeddings
    from the same graph and parameters (fused backend)."""
    import jax
    from repro.core import gnn as jx_gnn
    from repro.core.graph import random_graph as jx_random_graph
    from repro.core.partition import plan_execution as jx_plan_execution
    from repro.launch.gnn import GNNServer as JxServer
    kw = dict(sample=4, backend="fused", n_clusters=3)
    cfg_jx = jx_gnn.GNNConfig(in_dim=24, hidden_dims=(16,), out_dim=8,
                              sample=4)
    params = jx_gnn.init_params(jax.random.key(4), cfg_jx)
    g_jx = jx_random_graph(40, 200, 24, seed=1).gcn_normalize()
    ref = JxServer(jx_plan_execution(g_jx, setting, **kw), cfg_jx,
                   params=params).query(np.arange(40))
    g = random_graph(40, 200, 24, seed=1).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(16,), out_dim=8, sample=4)
    srv = GNNServer(plan_execution(g, setting, **kw), cfg,
                    params=gnn.params_from_numpy(params, device="cpu"),
                    device="cpu")
    got = srv.query(np.arange(40))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("setting", ["centralized", "decentralized", "semi"])
def test_served_bucketed_embeddings_match_reference_server(setting):
    """A bucketed plan's server (the forward's tuple of per-bucket outputs
    scattered at refresh) serves the reference server's embeddings."""
    import jax
    from repro.core import gnn as jx_gnn
    from repro.core.graph import random_graph as jx_random_graph
    from repro.core.partition import plan_execution as jx_plan_execution
    from repro.launch.gnn import GNNServer as JxServer
    kw = dict(sample=4, backend="fused", n_clusters=4, buckets="auto")
    cfg_jx = jx_gnn.GNNConfig(in_dim=24, hidden_dims=(16,), out_dim=8,
                              sample=4)
    params = jx_gnn.init_params(jax.random.key(5), cfg_jx)
    g_jx = jx_random_graph(60, 300, 24, seed=2).gcn_normalize()
    ref = JxServer(jx_plan_execution(g_jx, setting, **kw), cfg_jx,
                   params=params).query(np.arange(60))
    g = random_graph(60, 300, 24, seed=2).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(16,), out_dim=8, sample=4)
    plan = plan_execution(g, setting, **kw)
    assert plan.bucketed is not None
    srv = GNNServer(plan, cfg, params=gnn.params_from_numpy(
        params, device="cpu"), device="cpu")
    got = srv.query(np.arange(60))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_cli_serves_a_bucketed_skewed_graph_on_cpu(capsys):
    """``--buckets auto`` serves a bucketed plan and prints its layout line
    (the reference CLI's), with the padding against the dense layout's."""
    main(["--device", "cpu", "--scale", "0.002", "--clusters", "12",
          "--buckets", "auto", "--requests", "3", "--batch", "4",
          "--hidden", "8"])
    out = capsys.readouterr().out
    assert "bucketed layout: " in out and "padding ratio" in out
    assert "vs dense" in out and "served 12 lookups" in out
    main(["--device", "cpu", "--scale", "0.002", "--clusters", "12",
          "--buckets", "2", "--setting", "semi", "--requests", "1",
          "--batch", "2", "--hidden", "8"])
    out = capsys.readouterr().out
    assert "bucketed layout: " in out and "semi/fused" in out


def test_cli_serves_on_cpu(capsys):
    main(["--device", "cpu", "--scale", "0.0002", "--clusters", "2",
          "--requests", "3", "--batch", "4", "--hidden", "8"])
    out = capsys.readouterr().out
    assert "decentralized/fused" in out and "served 12 lookups" in out


def test_cli_serves_a_cam_built_scenario_on_cpu(capsys):
    main(["--dataset", "recsys", "--neighbor-mode", "cam-pallas",
          "--device", "cpu", "--setting", "centralized", "--scale",
          "0.0005", "--requests", "2", "--batch", "4", "--hidden", "8"])
    out = capsys.readouterr().out
    assert "recsys: built k-NN graph on the cam-pallas path — 100 nodes" \
        in out
    assert "centralized/fused" in out and "served 8 lookups" in out


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden_imports(source: str) -> list:
    """Every import of ``jax``, ``jaxlib`` or ``repro`` anywhere in
    ``source``: the walk covers the whole tree, so an import inside a
    function body (the planner's lazy ones) counts as one at the top."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return found


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    planner = {p.name for p in files if p.parent.name == "planner"}
    assert planner == {"__init__.py", "space.py", "evaluate.py",
                       "objective.py", "plan.py", "replan.py"}
    lazy = "def f():\n    from repro.core import costmodel\n" \
        "    import jax.numpy as jnp\n"
    assert _forbidden_imports(lazy) == ["repro.core", "jax.numpy"]
    for path in files:
        assert _forbidden_imports(path.read_text()) == [], path


@pytest.mark.parametrize("call", [
    "init_params", "params_from_numpy", "server", "make_forward", "cli",
    "knn_graph", "scenario_graph", "mvm_error_bounds", "accuracy_bounds",
    "bucketed_make_forward", "bucketed_cli", "bucketed_halo_forward",
    "plan_auto_cli"])
def test_entry_points_raise_without_cuda(call, monkeypatch):
    """Asked for the default device on a host without CUDA, an entry point
    raises; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv, cfg, g = _server()
    plan = plan_execution(g, "centralized", sample=4)
    calls = {
        "init_params": lambda: gnn.init_params(cfg),
        "params_from_numpy": lambda: gnn.params_from_numpy(
            [{"w": np.ones((2, 2)), "b": np.zeros(2)}]),
        "server": lambda: GNNServer(plan, cfg),
        "make_forward": lambda: plan.make_forward(cfg),
        "cli": lambda: main(["--scale", "0.0002"]),
        "knn_graph": lambda: neighbors.knn_graph(g.features, k=2),
        "scenario_graph": lambda: neighbors.scenario_graph(
            "anomaly", n_nodes=16, neighbor_mode="cam", backend="pallas"),
        "mvm_error_bounds": lambda: devices.mvm_error_bounds(
            "reram", backend="pallas"),
        "accuracy_bounds": lambda: devices.accuracy_bounds("reram"),
        "bucketed_make_forward": lambda: plan_execution(
            g, "decentralized", sample=4, n_clusters=3,
            buckets="auto").make_forward(cfg, overlap="serial"),
        "bucketed_cli": lambda: main(["--scale", "0.0002",
                                      "--buckets", "auto"]),
        "plan_auto_cli": lambda: main(["--scale", "0.0002",
                                       "--plan", "auto"]),
        "bucketed_halo_forward": lambda: halo.make_emulated_bucketed_forward(
            cfg, halo.build_bucketed_halo_plan(plan_execution(
                g, "decentralized", sample=4, n_clusters=3,
                buckets="auto").bucketed)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()
