"""The port's SPMD runtime on gloo ranks on the CPU.

The reference's multi-device cases (``tests/test_partition_distributed.py``
on 8 forced host devices, ``tests/test_semi_runtime.py`` on 4, and
``compressed_psum`` inside shard_map) run once in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as the reference's
own tests run them, and save their parameters and outputs to an npz. The
port runs the same cases on 8 and 4 gloo ranks that the tests spawn
(``repro_torch.launch.mesh.spawn``, file rendezvous under ``tmp_path``,
a 60 s collective timeout and a deadline per spawn), and is held to the
reference at rtol/atol 1e-4, the reference tests' tolerance, and to its
own emulated runtime with ``torch.equal``. The rank functions live in
``tests/_spmd_ranks.py``.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _spmd_ranks as ranks
from repro_torch.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.core.partition import plan_execution
from repro_torch.launch.mesh import Mesh, make_mesh, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150.0
MODES = ranks.MODES

_REFERENCE_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import gnn, random_graph
from repro.core.partition import (build_local_subgraphs, gather_features,
                                  partition, plan_execution)
from repro.distributed.halo import build_halo_plan, make_decentralized_forward
from repro.optim import compressed_psum

out = {}
# tests/test_partition_distributed.py: decentralized on 8 devices
g = random_graph(80, 400, 24, seed=7).gcn_normalize()
cfg = gnn.GNNConfig(in_dim=24, hidden_dims=(16, 16), out_dim=6, sample=96)
params = gnn.init_params(jax.random.key(0), cfg)
for i, l in enumerate(params):
    out[f"dec_w{i}"] = np.asarray(l["w"])
    out[f"dec_b{i}"] = np.asarray(l["b"])
part = partition(g, 8)
sub = build_local_subgraphs(g, part, sample=96)
feats = gather_features(g, part)
out["dec_feats"] = feats
mesh8 = jax.make_mesh((8,), ("data",))
for mode in ("allgather", "alltoall"):
    fwd = make_decentralized_forward(mesh8, cfg, build_halo_plan(part),
                                     part.n_max, mode=mode)
    out[f"dec_{mode}"] = np.asarray(fwd(params, jnp.asarray(feats),
                                        jnp.asarray(sub.neighbors),
                                        jnp.asarray(sub.weights)))
# tests/test_semi_runtime.py: semi on 4 devices
mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
g = random_graph(60, 300, 12, seed=7).gcn_normalize()
cfg = gnn.GNNConfig(in_dim=12, hidden_dims=(16,), out_dim=6, sample=8)
params = gnn.init_params(jax.random.key(0), cfg)
for i, l in enumerate(params):
    out[f"semi_w{i}"] = np.asarray(l["w"])
    out[f"semi_b{i}"] = np.asarray(l["b"])
plan = plan_execution(g, "semi", sample=8, n_clusters=4)
for mode in ("allgather", "alltoall"):
    out[f"semi_{mode}"] = np.asarray(
        plan.make_forward(cfg, mesh=mesh4, mode=mode)(params))
# compressed_psum on 4 devices, a different gradient on each
rng = np.random.default_rng(3)
grads = (rng.normal(size=(4, 16, 8))
         * np.array([0.5, 1.0, 2.0, 4.0])[:, None, None]).astype(np.float32)
fn = shard_map(lambda g, r: tuple(x[None] for x in
                                  compressed_psum(g[0], r[0], "data")),
               mesh=mesh4, in_specs=(P("data"), P("data")),
               out_specs=(P("data"), P("data")), check_rep=False)
mean, res = fn(jnp.asarray(grads), jnp.zeros_like(grads))
out["psum_g"], out["psum_mean"], out["psum_res"] = (
    grads, np.asarray(mean), np.asarray(res))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, path],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as f:
        return dict(f)


def _arrays(reference, prefix, n_layers):
    out = {}
    for i in range(n_layers):
        out[f"w{i}"] = reference[f"{prefix}_w{i}"]
        out[f"b{i}"] = reference[f"{prefix}_b{i}"]
    return out


def _rdv(tmp_path_factory, name):
    return str(tmp_path_factory.mktemp(name) / "rendezvous")


@pytest.fixture(scope="module")
def dec8(reference, tmp_path_factory):
    arrays = dict(_arrays(reference, "dec", 3), feats=reference["dec_feats"])
    return spawn(ranks.decentralized_8, 8,
                 (_rdv(tmp_path_factory, "dec8"), arrays), deadline=DEADLINE)


CKPT_TREE = {"a": np.arange(24, dtype=np.float32).reshape(8, 3),
             "b": np.arange(5, dtype=np.float32) - 2.0,
             "c": np.arange(24, dtype=np.float32).reshape(2, 12) * 0.5}


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(ckpt), 7, {k: torch.from_numpy(v)
                                   for k, v in CKPT_TREE.items()})
    arrays = dict(_arrays(reference, "semi", 2),
                  psum_g=reference["psum_g"])
    return spawn(ranks.four_ranks, 4,
                 (_rdv(tmp_path_factory, "four"), arrays, str(ckpt)),
                 deadline=DEADLINE)


# ------------------------------------------------------------ decentralized 8


def test_decentralized_8_ranks_reads_the_reference_tables(dec8):
    assert all(r["feats_equal"] for r in dec8)


@pytest.mark.parametrize("mode", MODES)
def test_decentralized_8_ranks_matches_reference(dec8, reference, mode):
    ref = reference[f"dec_{mode}"]
    for r in dec8:
        assert r[mode].shape == ref.shape
        np.testing.assert_allclose(r[mode], ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_decentralized_8_ranks_equals_emulated(dec8, mode):
    assert all(r[f"{mode}_equal"] for r in dec8)
    # every rank holds the same gathered output
    for r in dec8[1:]:
        assert np.array_equal(r[mode], dec8[0][mode])


def test_all_to_all_single_is_jax_all_to_all(dec8):
    """recv[j] = peer j's send[me], checked on rank-tagged blocks."""
    assert all(r["alltoall_semantics"] for r in dec8)


@pytest.mark.parametrize("mode", MODES)
def test_exchange_alone_matches_emulated(dec8, mode):
    assert all(r[f"exchange_{mode}"] for r in dec8)
    assert sum(r["halo_rows"] for r in dec8) > 0     # a real exchange


# ------------------------------------------------------------ semi 4


@pytest.mark.parametrize("mode", MODES)
def test_semi_4_ranks_matches_reference(four, reference, mode):
    ref = reference[f"semi_{mode}"]
    for r in four:
        assert r[f"semi_{mode}_equal"]
        np.testing.assert_allclose(r[f"semi_{mode}"], ref, rtol=1e-4,
                                   atol=1e-4)


GRID = [(s, b, i, m) for s in ("decentralized", "semi")
        for b in ranks.BACKENDS for i in (True, False) for m in MODES]


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(
    [c[0], c[1], "ideal" if c[2] else "bit-accurate", c[3]]))
def test_spmd_equals_emulated_on_the_oracle_case(four, case):
    """Every backend x numerics x mode, both settings, on 4 ranks: the
    same kernels on the same per-cluster tables, so equal bit for bit."""
    assert all(r["grid"][case] for r in four)


# ------------------------------------------------------------ optim, ckpt


def test_compressed_psum_4_ranks_matches_reference(four, reference):
    for rank, r in enumerate(four):
        np.testing.assert_allclose(r["psum_mean"],
                                   reference["psum_mean"][rank],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["psum_res"],
                                   reference["psum_res"][rank],
                                   rtol=1e-4, atol=1e-4)
    # one all-reduced value on every rank
    for r in four[1:]:
        assert np.array_equal(r["psum_mean"], four[0]["psum_mean"])


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    g = np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)
    return g, spawn(ranks.one_rank, 1, (_rdv(tmp_path_factory, "one"), g),
                    deadline=DEADLINE)[0]


def test_compressed_psum_one_rank_matches_reference(one):
    """tests/test_optim_data.py's 1-device case, on a world of one."""
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh as jx_make_mesh
    from repro.optim import compressed_psum as jx_compressed_psum
    g, r = one
    fn = shard_map(lambda g, r: jx_compressed_psum(g, r, "data"),
                   mesh=jx_make_mesh((1,), ("data",)),
                   in_specs=(P(), P()), out_specs=(P(), P()),
                   check_rep=False)
    ref, _ = fn(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    np.testing.assert_allclose(r["psum_mean"], np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(r["psum_mean"], g, atol=0.02)


def test_restore_places_this_ranks_blocks(four):
    """Both mesh and shardings: P("data") keeps this rank's block of
    dimension 0, P() the whole leaf, P(None, "data") a block of
    dimension 1."""
    for rank, r in enumerate(four):
        step, tree = r["restored"]
        assert step == 7
        np.testing.assert_array_equal(tree["a"],
                                      CKPT_TREE["a"][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(tree["b"], CKPT_TREE["b"])
        np.testing.assert_array_equal(tree["c"],
                                      CKPT_TREE["c"][:, 3 * rank:3 * rank + 3])


@pytest.mark.parametrize("given", ["mesh", "shardings"])
def test_restore_with_mesh_or_shardings_alone_restores_plainly(tmp_path,
                                                               given):
    """F5: as the reference, either alone restores plainly."""
    tree = {k: torch.from_numpy(v) for k, v in CKPT_TREE.items()}
    save_checkpoint(str(tmp_path), 3, tree)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, step = CheckpointManager(str(tmp_path)).restore(
        like, **{given: object()})
    assert step == 3
    for k in tree:
        assert torch.equal(got[k], tree[k])


# ------------------------------------------------------------ servers


@pytest.mark.parametrize("setting", ["decentralized", "semi"])
@pytest.mark.parametrize("ideal", [True, False],
                         ids=["ideal", "bit-accurate"])
def test_servers_with_a_mesh_equal_their_emulated_twins(four, setting,
                                                        ideal):
    """GNNServer after a refresh; StreamingGNNServer after a refresh and
    after one commit, on every rank."""
    for r in four:
        assert r["servers"][(setting, ideal)] == (True, True, True)


# ------------------------------------------------------------ examples, CLI


def test_gnn_serve_demo_as_a_world_of_one(one):
    _, r = one
    errs, text = r["demo"]
    assert set(errs) == set(MODES) and max(errs.values()) < 1e-5, text
    assert "max|err| vs centralized oracle" in text


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn(ranks.two_ranks, 2, (_rdv(tmp_path_factory, "two"),),
                 deadline=DEADLINE)


def test_gnn_serve_demo_under_two_ranks(two):
    for rank, r in enumerate(two):
        errs, text = r["demo"]
        assert max(errs.values()) < 1e-5
        assert ("max|err|" in text) == (rank == 0)   # rank 0 prints


def test_cli_under_two_ranks_serves_spmd_and_prints_from_rank_0(two):
    out0, out1 = two[0]["cli"], two[1]["cli"]
    assert out1 == ""
    assert out0.count("embedding refresh") == 1
    assert "2 clusters on 2 gloo ranks" in out0


# ------------------------------------------------------------ failures


def test_a_dead_rank_fails_the_spawn_within_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(ranks.dying_rank, 2, (str(tmp_path / "rdv"),), deadline=60)
    assert time.monotonic() - t0 < 60


def test_make_mesh_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="gloo"):
        make_mesh((2,), ("data",), backend="nccl")
    with pytest.raises(ValueError, match="one-axis"):
        make_mesh((2, 2), ("data", "model"), backend="gloo", device="cpu")


def test_make_forward_refuses_a_device_off_the_mesh():
    """On the SPMD path the forward runs on the mesh's device; another
    device raises (no collective runs before the check)."""
    g = random_graph(40, 200, 8, seed=0).gcn_normalize()
    plan = plan_execution(g, "decentralized", sample=8, n_clusters=2)
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4, sample=8)
    mesh = Mesh(None, "data", 2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        plan.make_forward(cfg, mesh=mesh, device="meta")
