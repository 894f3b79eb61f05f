"""The port's sharding rules against the reference's, spec for spec.

``repro_torch.distributed.sharding`` is a copy of
``repro.distributed.sharding`` over the port's trees. Every architecture
at its full published size: the reference's parameters come from
``jax.eval_shape(model.init)``, the port's from the meta device (nothing
is allocated), and both rule sets read a stand-in mesh with ``.shape``
and ``.axis_names``. The specs must be equal entry for entry, on every
mesh, with FSDP defaulted and forced; so must the optimizer, activation,
batch and cache rules and ``preferred_tp``. ``placements`` turns a spec
into DTensor placements. rwkv6-3b is held in the JAX package's form
(``_lm_cases.jax_form``): its full config is the published Finch block,
whose leaves the reference does not have.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from _lm_cases import jax_form
from repro.configs import ARCHS, SHAPES, get_config as jx_get_config
from repro.distributed import sharding as R
from repro.launch.mesh import preferred_tp as jx_preferred_tp
from repro.launch.steps import batch_struct as jx_batch_struct
from repro.models import build as jx_build
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import PartitionSpec, preferred_tp
from repro_torch.launch.steps import batch_struct
from repro_torch.models import build
from repro_torch.models.common import InitKey


class StandIn:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = {
    "16x16": StandIn((16, 16), ("data", "model")),
    "2x16x16": StandIn((2, 16, 16), ("pod", "data", "model")),
    "32x8": StandIn((32, 8), ("data", "model")),
    "8x4": StandIn((8, 4), ("data", "model")),
    "4x2": StandIn((4, 2), ("data", "model")),
    "1x1": StandIn((1, 1), ("data", "model")),
}


@functools.lru_cache(maxsize=None)
def _params(arch):
    ref = jax.eval_shape(jx_build(jx_get_config(arch)).init,
                         jax.random.key(0))
    port = build(jax_form(get_config(arch))).init(InitKey.abstract())
    return ref, port


@functools.lru_cache(maxsize=None)
def _caches(arch):
    spec = SHAPES["decode_32k"]
    b, s = spec.global_batch, spec.seq_len
    ref = jax.eval_shape(functools.partial(
        jx_build(jx_get_config(arch)).init_caches, b, s))
    port = build(jax_form(get_config(arch))).init_caches(b, s,
                                                         device="meta")
    return ref, port


def _ref_specs(tree) -> list:
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree) -> list:
    out = S.spec_leaves(tree)
    assert all(isinstance(p, PartitionSpec) for p in out)
    return [tuple(p) for p in out]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_reference(arch, mesh):
    ref, port = _params(arch)
    m = MESHES[mesh]
    for fsdp in (None, True):
        r = R.param_shardings(ref, jx_get_config(arch), m, fsdp=fsdp)
        p = S.param_shardings(port, jax_form(get_config(arch)), m,
                              fsdp=fsdp)
        assert _port_specs(p) == _ref_specs(r), (arch, mesh, fsdp)
        ro = R.optimizer_shardings(r, ref, m)
        po = S.optimizer_shardings(p, port, m)
        assert _port_specs(po) == _ref_specs(ro), (arch, mesh, fsdp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_batch_and_cache_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    jc, pc = jx_get_config(arch), jax_form(get_config(arch))
    for sp in (False, True):
        r = R.activation_rules(jc, m, seq_parallel=sp)
        p = S.activation_rules(pc, m, seq_parallel=sp)
        assert set(r) == set(p)
        assert all(tuple(p[k]) == tuple(r[k]) for k in r), (arch, mesh, sp)
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                       ("decode", 128, 1), ("decode", 1, 1)):
        r = R.batch_shardings(m, kind, jx_batch_struct(jc, b, s))
        p = S.batch_shardings(m, kind, batch_struct(pc, b, s))
        assert {k: tuple(v) for k, v in p.items()} == \
            {k: tuple(v) for k, v in r.items()}, (arch, mesh, kind, b)
    ref, port = _caches(arch)
    r = R.cache_shardings(ref, jc, m)
    p = S.cache_shardings(port, pc, m)
    assert _port_specs(p) == _ref_specs(r), (arch, mesh)


def test_abstract_params_and_caches_have_the_reference_shapes():
    for arch in ARCHS:
        ref, port = _params(arch)
        got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for x in _tree.leaves(port)]
        want = [(tuple(x.shape), str(x.dtype)) for x in
                jax.tree.leaves(ref)]
        assert got == want, arch
        assert all(x.device.type == "meta" for x in _tree.leaves(port))
        rc, pc = _caches(arch)
        got = [tuple(x.shape) for x in _tree.leaves(pc)]
        assert got == [tuple(x.shape) for x in jax.tree.leaves(rc)], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_preferred_tp_matches_reference(arch):
    cfg, jc = jax_form(get_config(arch)), jx_get_config(arch)
    for n in (1, 2, 4, 8, 16, 32, 64, 256, 512):
        for max_tp in (16, 8):
            assert preferred_tp(cfg, n, max_tp) == \
                jx_preferred_tp(jc, n, max_tp), (arch, n, max_tp)


class _Names:
    def __init__(self, *names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec, names, want", [
    (PartitionSpec(), ("data", "model"), (Replicate(), Replicate())),
    (PartitionSpec("data", None), ("data", "model"),
     (Shard(0), Replicate())),
    (PartitionSpec(None, "model"), ("data", "model"),
     (Replicate(), Shard(1))),
    (PartitionSpec("model", "data"), ("data", "model"),
     (Shard(1), Shard(0))),
    (PartitionSpec(None, None, "model", None), ("data", "model"),
     (Replicate(), Shard(2))),
    (PartitionSpec(("pod", "data"), None, "model"),
     ("pod", "data", "model"), (Shard(0), Shard(0), Shard(2))),
    (PartitionSpec(None, ("pod", "data")), ("pod", "data", "model"),
     (Shard(1), Shard(1), Replicate())),
])
def test_placements(spec, names, want):
    assert S.placements(spec, _Names(*names)) == want


@pytest.mark.parametrize("spec", [
    PartitionSpec(("data", "pod")),          # against the mesh's order
    PartitionSpec("data", "data"),           # an axis twice
])
def test_placements_refuses(spec):
    with pytest.raises(ValueError):
        S.placements(spec, _Names("pod", "data", "model"))


def test_local_block_cuts_as_device_put_does():
    """A (pod, data) split cuts pod-major: JAX's major-to-minor order of
    the axes in P(("pod", "data"))."""
    import torch

    class M(_Names):
        def __init__(self, coord):
            super().__init__("pod", "data", "model")
            self.coord = coord

        def get_coordinate(self):
            return self.coord

        def size(self, i):
            return (2, 4, 2)[i]

    x = torch.arange(64).reshape(16, 4)
    pl = S.placements(PartitionSpec(("pod", "data"), "model"), M(None))
    for pod in range(2):
        for d in range(4):
            for m in range(2):
                got = S.local_block(x, pl, M([pod, d, m]))
                rows = (pod * 4 + d) * 2
                np.testing.assert_array_equal(
                    got.numpy(), x[rows:rows + 2, m * 2:m * 2 + 2].numpy())
