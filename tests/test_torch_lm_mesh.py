"""LM training over a real (data, model) mesh: gloo CPU ranks.

The port's smoke internlm2, grok-1 (3 experts on a model axis of 2:
expert-inner TP) and deepseek-v3 (EP) train 3 AdamW steps at f32 on DTensor
parameters placed by ``distributed/sharding.py``, over 1x2 (TP) and 2x1
(DP, ZeRO-1 moments) meshes of two ranks that ``launch.mesh.spawn``
starts (file rendezvous under ``tmp_path``). Each run starts from the
reference's initial parameters and is fed the reference's token batches
(the port's stream draws other bits; ROADMAP §3). It is held to the port's
unsharded run of the same steps and to the reference's one-device
``train_step``: losses within 1e-5 relative, every parameter within
1e-4 * max|ref| of its leaf. ``tests/test_torch_lm_mesh4.py`` runs 2x2.

Also here: ``shard()`` as a no-op with no rules installed, and the mesh
entry point raising without CUDA. ``tests/test_torch_lm_elastic.py``
covers ``train()`` over a mesh and the elastic reshard.
"""
import numpy as np
import pytest
import torch

import _lm_mesh_ranks as ranks
from _lm_mesh_cases import reference_runs, spawn_ranks
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import common

MESHES = ("1x2", "2x1")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return reference_runs(tmp_path_factory.mktemp("lm_mesh"))


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    res = spawn_ranks(ranks.run_meshes, 2, tmp_path_factory, "meshes",
                      cases["path"], [(1, 2), (2, 1)])
    return res[0]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_run_matches_port_unsharded(cases, sharded, arch, mesh):
    losses, params = sharded[(arch, mesh)]
    want_l, want_p = cases[arch]["port"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5, atol=0)
    for g, r in zip(params, want_p):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_run_matches_reference(cases, sharded, arch, mesh):
    losses, params = sharded[(arch, mesh)]
    want_l, want_p = cases[arch]["ref"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5, atol=0)
    for g, r in zip(params, want_p):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_shard_is_a_noop_without_rules():
    x = torch.randn(2, 3, 4)
    assert common.shard(x, "residual") is x
    with common.activation_sharding({"heads": None}):
        assert common.shard(x, "residual") is x
    with common.activation_sharding({}):
        assert common.shard(x, "residual") is x


def test_shard_refuses_a_plain_tensor_under_rules():
    with common.activation_sharding({"residual": ("data", None, None)}):
        with pytest.raises(TypeError, match="plain tensor"):
            common.shard(torch.randn(2, 3, 4), "residual")


def test_lm_mesh_raises_without_cuda(monkeypatch):
    """Asked for the default device on a host without CUDA, the mesh
    raises before any process group starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_mesh((1, 1), backend="gloo")
    assert not torch.distributed.is_initialized()
