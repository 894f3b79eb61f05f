"""Rank functions of ``tests/test_torch_spmd.py``.

Each runs in one of the processes ``repro_torch.launch.mesh.spawn``
starts, joins a gloo mesh on the CPU through a file rendezvous, and
returns host objects. This module imports neither JAX nor the JAX
package, so the ranks start fast.
"""
import contextlib
import dataclasses
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import (build_local_subgraphs,
                                        gather_features, partition,
                                        plan_execution)
from repro_torch.distributed import halo
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.launch.mesh import make_mesh

MODES = ("allgather", "alltoall")
BACKENDS = ("jnp", "pallas", "fused")


def _mesh(rank, world, rdv):
    return make_mesh((world,), ("data",), backend="gloo", device="cpu",
                     init_method=f"file://{rdv}", rank=rank, timeout=60)


def _params(arrays, n_layers):
    return gnn.params_from_numpy(
        [{"w": arrays[f"w{i}"], "b": arrays[f"b{i}"]}
         for i in range(n_layers)], device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ 8 ranks


def decentralized_8(rank, world, rdv, arrays):
    """The reference's 8-device case (tests/test_partition_distributed.py)
    with its parameters, both modes, against the emulated forward; the
    exchange alone on rank-tagged tables."""
    mesh = _mesh(rank, world, rdv)
    g = random_graph(80, 400, 24, seed=7).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(16, 16), out_dim=6,
                        sample=96)
    params = _params(arrays, 3)
    part = partition(g, 8)
    sub = build_local_subgraphs(g, part, sample=96)
    feats = gather_features(g, part)
    plan = halo.build_halo_plan(part)
    res = dict(feats_equal=bool(np.array_equal(feats, arrays["feats"])))
    for mode in MODES:
        fwd = halo.make_decentralized_forward(mesh, cfg, plan, part.n_max,
                                              mode=mode)
        out = fwd(params, _t(feats[rank]), _t(sub.neighbors[rank]),
                  _t(sub.weights[rank]))
        emu = halo.make_emulated_forward(cfg, plan, mode=mode,
                                         device="cpu")(
            params, _t(feats), _t(sub.neighbors), _t(sub.weights))
        res[mode] = out.numpy()
        res[f"{mode}_equal"] = bool(torch.equal(out, emu))
    res.update(_exchange_alone(mesh, plan, part.n_max))
    dist.destroy_process_group()
    return res


def _exchange_alone(mesh, plan, n_max):
    """``all_to_all_single`` gives recv[j] = peer j's send[me]; each
    exchange equals ``_emulated_exchange`` on tables tagged by rank."""
    k, r = mesh.size, mesh.rank
    send = torch.stack([torch.full((2, 3), 100.0 * r + j) for j in range(k)])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=mesh.group)
    want = torch.stack([torch.full((2, 3), 100.0 * j + r) for j in range(k)])
    out = dict(alltoall_semantics=bool(torch.equal(recv, want)))
    f = 3
    tagged = (torch.arange(k, dtype=torch.float32)[:, None, None] * 1e4
              + torch.arange(n_max * f, dtype=torch.float32)
              .reshape(1, n_max, f) + 1.0)
    h_max = plan.src_cluster.shape[1]
    t = halo._plan_consts(plan, "cpu", r)
    emu = halo._emulated_exchange(tagged, halo._plan_consts(plan, "cpu"),
                                  "allgather", h_max)[r]
    got = {"allgather": halo._exchange_allgather(
               tagged[r], t["src_c"], t["src_s"], t["hmask"], mesh),
           "alltoall": halo._exchange_alltoall(
               tagged[r], t["send_slot"], t["send_mask"], t["recv_to_halo"],
               t["recv_mask"], h_max, mesh)}
    for mode in MODES:
        ref = halo._emulated_exchange(
            tagged, halo._plan_consts(plan, "cpu"), mode, h_max)[r]
        out[f"exchange_{mode}"] = bool(torch.equal(got[mode], ref)
                                       and torch.equal(ref, emu))
    out["halo_rows"] = int(plan.halo_mask[r].sum())
    return out


# ------------------------------------------------------------ 4 ranks


def four_ranks(rank, world, rdv, arrays, ckpt_dir):
    """The reference's semi case (tests/test_semi_runtime.py) with its
    parameters; SPMD against emulated on the oracle grid; compressed_psum
    on gradients that differ per rank; restore onto the mesh; the
    servers against their emulated twins."""
    mesh = _mesh(rank, world, rdv)
    res = {}
    g = random_graph(60, 300, 12, seed=7).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=12, hidden_dims=(16,), out_dim=6, sample=8)
    params = _params(arrays, 2)
    plan = plan_execution(g, "semi", sample=8, n_clusters=4)
    for mode in MODES:
        spmd = plan.make_forward(cfg, mesh=mesh, mode=mode,
                                 device="cpu")(params)
        emu = plan.make_forward(cfg, mode=mode, device="cpu")(params)
        res[f"semi_{mode}"] = spmd.numpy()
        res[f"semi_{mode}_equal"] = bool(torch.equal(spmd, emu))
    res["grid"] = _oracle_grid(mesh)
    from repro_torch.optim import compressed_psum
    mean, resid = compressed_psum(_t(arrays["psum_g"][rank]),
                                  torch.zeros(arrays["psum_g"].shape[1:]),
                                  mesh)
    res["psum_mean"], res["psum_res"] = mean.numpy(), resid.numpy()
    from repro_torch.checkpoint import CheckpointManager
    like = {"a": torch.zeros(8, 3), "b": torch.zeros(5),
            "c": torch.zeros(2, 12)}
    tree, step = CheckpointManager(ckpt_dir).restore(
        like, mesh=mesh, shardings={"a": P("data"), "b": P(),
                                    "c": P(None, "data")})
    res["restored"] = (step, {k: v.numpy() for k, v in tree.items()})
    res["servers"] = _servers(mesh)
    dist.destroy_process_group()
    return res


def _oracle_grid(mesh):
    """{(setting, backend, ideal, mode): SPMD equal to emulated} on the
    shared oracle case (40 nodes, F 8, hidden 16)."""
    g = random_graph(40, 200, 8, seed=0).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4, sample=8)
    out = {}
    for setting in ("decentralized", "semi"):
        base = plan_execution(g, setting, sample=8, n_clusters=mesh.size)
        for backend in BACKENDS:
            plan = dataclasses.replace(base, backend=backend)
            for ideal in (True, False):
                c = dataclasses.replace(
                    cfg, numerics=CrossbarNumerics(ideal=ideal))
                params = gnn.init_params(c, seed=1, device="cpu")
                for mode in MODES:
                    a = plan.make_forward(c, mesh=mesh, mode=mode,
                                          device="cpu")(params)
                    b = plan.make_forward(c, mode=mode, device="cpu")(params)
                    out[(setting, backend, ideal, mode)] = bool(
                        torch.equal(a, b))
    return out


def _servers(mesh):
    """GNNServer and StreamingGNNServer with the mesh against their
    emulated twins: after a refresh, and after one commit (ideal: an
    incremental one; bit-accurate: a full one)."""
    from repro_torch.launch.gnn import GNNServer
    from repro_torch.streaming import StreamingGNNServer
    g = random_graph(48, 240, 8, seed=3).gcn_normalize()
    out = {}
    for setting in ("decentralized", "semi"):
        for ideal in (True, False):
            cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4,
                                sample=8,
                                numerics=CrossbarNumerics(ideal=ideal))
            twins = [plan_execution(g, setting, backend="fused", sample=8,
                                    n_clusters=mesh.size) for _ in range(4)]
            srv = GNNServer(twins[0], cfg, mesh=mesh, device="cpu")
            ref = GNNServer(twins[1], cfg, device="cpu")
            srv.refresh()
            ref.refresh()
            ok = np.array_equal(srv.embeddings, ref.embeddings)
            s_srv = StreamingGNNServer(twins[2], cfg, mesh=mesh,
                                       device="cpu")
            s_ref = StreamingGNNServer(twins[3], cfg, device="cpu")
            s_srv.refresh()
            s_ref.refresh()
            ok_stream = np.array_equal(s_srv.embeddings, s_ref.embeddings)
            rng = np.random.default_rng(5)
            nodes = rng.choice(g.n_nodes, 5, replace=False)
            rows = rng.normal(size=(5, 8)).astype(np.float32)
            u = s_srv.ingest(nodes=nodes, rows=rows)
            u_ref = s_ref.ingest(nodes=nodes, rows=rows)
            ok_commit = (np.array_equal(s_srv.embeddings, s_ref.embeddings)
                         and u.full == u_ref.full and (ideal or u.full))
            out[(setting, ideal)] = (bool(ok), bool(ok_stream),
                                     bool(ok_commit))
    return out


# ------------------------------------------------------------ 1 and 2 ranks


def one_rank(rank, world, rdv, g):
    """The demo as a world of one, then compressed_psum on one rank."""
    from repro_torch.examples import gnn_serve
    from repro_torch.optim import compressed_psum
    with contextlib.redirect_stdout(io.StringIO()) as text:
        errs = gnn_serve.main(["--device", "cpu", "--dist-backend", "gloo"])
    mesh = _mesh(rank, world, rdv)
    mean, _ = compressed_psum(_t(g), torch.zeros(g.shape), mesh)
    dist.destroy_process_group()
    return dict(demo=(errs, text.getvalue()), psum_mean=mean.numpy())


def two_ranks(rank, world, rdv):
    """The demo and the CLI under two ranks of one gloo group (as under
    ``torchrun``); returns what each rank printed."""
    from repro_torch.examples import gnn_serve
    from repro_torch.launch import gnn as cli
    _mesh(rank, world, rdv)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    with contextlib.redirect_stdout(io.StringIO()) as demo:
        errs = gnn_serve.main(["--device", "cpu", "--dist-backend", "gloo"])
    with contextlib.redirect_stdout(io.StringIO()) as text:
        cli.main(["--setting", "decentralized", "--clusters", "2",
                  "--dist-backend", "gloo", "--device", "cpu",
                  "--scale", "0.0005", "--requests", "2"])
    dist.destroy_process_group()
    return dict(demo=(errs, demo.getvalue()), cli=text.getvalue())


def dying_rank(rank, world, rdv):
    """Rank 1 raises before the collective rank 0 waits in."""
    _mesh(rank, world, rdv)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"
