"""``train()`` over a (data, model) mesh of two gloo CPU ranks, and the
elastic reshard.

The ranks (spawned by ``launch.mesh.spawn``; rank code in
``tests/_lm_mesh_ranks.py``) train smoke internlm2 at f32 with
``train(TrainConfig(mesh="2x1"))``, saving at step 3; the checkpoint is
resharded (``launch.elastic.reshard``) onto 1x2 and restored onto one
card (no mesh), and each continues to step 6 on the losses of the
uninterrupted run (the token stream is indexed by step). A checkpoint
restored onto 2-D meshes leaves each rank the block ``jax.device_put``
onto a ``NamedSharding`` would leave addressable on it (the case of
``tests/test_checkpoint.py::test_elastic_restore_onto_mesh``), in storage
of its own, and ``preferred_mesh`` takes the reference's TP degree. A 2x1
run that fails at step 4 resumes on every rank from its step-3 checkpoint
(saved every 3 steps) and ends on the uninterrupted run's losses.
"""
import numpy as np
import pytest

import _lm_mesh_ranks as ranks
from _lm_mesh_cases import spawn_ranks
from repro.configs import get_config as jx_get_config
from repro.launch.mesh import preferred_tp as jx_preferred_tp


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    return spawn_ranks(ranks.run_elastic, 2, tmp_path_factory, "elastic",
                       root)


def test_reshard_continues_on_the_uninterrupted_losses(elastic):
    r = elastic[0]
    full = dict(r["full"])
    assert [s for s, _ in r["first"]] == [0, 1, 2, 3]
    for name in ("grown", "single"):
        got = dict(r[name])
        assert sorted(got) == [4, 5], name          # resumed after step 3
        for s in got:
            np.testing.assert_allclose(got[s], full[s], rtol=1e-5, atol=0)
    for s, v in r["first"]:
        np.testing.assert_allclose(v, full[s], rtol=1e-5, atol=0)
    b = r["resharded"]
    assert b["step"] == 3
    # tok [256, 64] on 1x2: the vocab split over 'model'
    assert b["tok"] == (128, 64) and "Shard(dim=0)" in b["placements"]


def test_restore_onto_2d_mesh_leaves_each_rank_its_block(elastic):
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    bb = np.arange(8, dtype=np.float32).reshape(2, 4)
    c = np.arange(6, dtype=np.float32)
    for rank, r in enumerate(elastic):
        step, got = r["restore"]["2x1"]          # data 2, model 1
        assert step == 3
        np.testing.assert_array_equal(got["a"][0], a[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(got["b"][0], bb)
        np.testing.assert_array_equal(got["c"][0], c)
        step, got = r["restore"]["1x2"]          # data 1, model 2
        np.testing.assert_array_equal(got["a"][0],
                                      a[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["b"][0],
                                      bb[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["c"][0], c)
        assert "Replicate" in got["c"][1]


def test_preferred_mesh_matches_reference_tp(elastic):
    cfg = jx_get_config("internlm2-1.8b", smoke=True)
    tp = jx_preferred_tp(cfg, 2)
    assert elastic[0]["preferred"] == (2 // tp, tp)




def test_fault_on_a_mesh_resumes_every_rank_at_the_same_step(elastic):
    for rank, r in enumerate(elastic):
        full = dict(r["full"])
        steps = [s for s, _ in r["faulted"]]
        assert steps == [0, 1, 2, 3, 4, 5], (rank, steps)
        for s, v in r["faulted"]:
            np.testing.assert_allclose(v, full[s], rtol=1e-5, atol=0)


def test_restored_blocks_own_their_storage(elastic):
    """A block cut from the full tensor is copied out of it, so the full
    tensor can be freed (a dim-0 block would otherwise be a view)."""
    b = elastic[0]["resharded"]
    assert b["tok_storage"] == 128 * 64 * 4
    for r in elastic:
        for mesh in ("2x1", "1x2"):
            for name, (block, _, storage) in r["restore"][mesh][1].items():
                assert storage == block.nbytes, (mesh, name)
