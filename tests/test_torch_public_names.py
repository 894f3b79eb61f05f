"""The reference's last public names on the port: ``models.common.cast``,
``tuning.measure``'s four runners and the eight names ``launch`` exports.

``cast`` gives the reference's dtype and bits. Each runner takes the
reference's arguments (the port adds ``device``; ``interpret`` is taken
and not read: a CPU tensor runs the plain version) and, on the CPU, returns
what the reference's kernel returns on the same inputs in interpret mode:
the CAM exactly, the aggregation and the fused layer (ideal and
bit-accurate) within 1e-5 * max|ref|, the crossbar within rtol 1e-5
(the reference's own Pallas kernel and plain version differ by that
much: ROADMAP §3, "Inside the reference").
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cam_match import search as jx_search
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro.kernels.crossbar_mvm.crossbar_mvm import \
    crossbar_matmul_quantized as jx_crossbar
from repro.kernels.csr_aggregate import aggregate as jx_aggregate
from repro.kernels.fused_layer import fused_gnn_layer as jx_fused
from repro.mapper.tiling import padded_grid
from repro.models import common as jx_common
from repro.tuning import measure as jx_measure
from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.tuning import measure
from repro_torch.tuning.space import (AggregateConfig, AggregateGeometry,
                                      CamConfig, CamGeometry, CrossbarConfig,
                                      CrossbarGeometry, FusedConfig,
                                      FusedGeometry)

RUNNERS = ("crossbar_runner", "fused_runner", "aggregate_runner",
           "cam_runner")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_matches_reference(arch, dtype):
    from repro.configs import get_config as jx_get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jx_get_config(arch, smoke=True), dtype=dtype)
    x = np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32)
    got = common.cast(torch.from_numpy(x), cfg)
    ref = np.asarray(jx_common.cast(jnp.asarray(x), jcfg))
    assert str(got.dtype).replace("torch.", "") == ref.dtype.name
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_launch_exports_the_reference_names():
    """``repro_torch.launch`` exports what ``repro.launch`` does, each name
    the port's own object of that name in its submodule."""
    import repro.launch as jx_launch
    import repro_torch.launch as launch
    assert launch.__all__ == jx_launch.__all__
    for name in launch.__all__:
        got = getattr(launch, name)
        assert callable(got) and got.__name__ == name
        assert got.__module__.startswith("repro_torch.launch.")
    with pytest.raises(AttributeError):
        launch.no_such_name


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_takes_the_reference_arguments(name):
    ref = inspect.signature(getattr(jx_measure, name)).parameters
    got = inspect.signature(getattr(measure, name)).parameters
    assert list(got)[:len(ref)] == list(ref)
    for k, p in ref.items():
        assert got[k].default == p.default, k
    assert got["device"].default == "cuda"


def _np(t):
    return t.detach().cpu().numpy()


def test_crossbar_runner_matches_reference():
    geom = CrossbarGeometry(m=12, k=40, n=9, rows_per_xbar=16, in_bits=8)
    run = measure.crossbar_runner(geom, CrossbarConfig(), seed=3,
                                  device="cpu")
    got = _np(run())
    xq, wq = _np(run.inputs["xq"]), _np(run.inputs["codes"].wq)
    grid = padded_grid(geom.m, geom.k, geom.n, geom.rows_per_xbar)
    xp = np.zeros((grid.m_pad, grid.k_pad), np.uint32)
    xp[:geom.m, :geom.k] = xq
    wp = np.zeros((grid.k_pad, grid.n_pad), np.float32)
    wp[:geom.k, :geom.n] = wq
    cfg = JxNumerics(in_bits=geom.in_bits, rows_per_xbar=geom.rows_per_xbar)
    ref = np.asarray(jx_crossbar(jnp.asarray(xp), jnp.asarray(wp), cfg,
                                 interpret=True))[:geom.m, :geom.n]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("ideal", [True, False])
def test_fused_runner_matches_reference(ideal):
    geom = FusedGeometry(nd=20, n=30, f_in=24, f_out=8, sample=4,
                         ideal=ideal, rows_per_xbar=16)
    run = measure.fused_runner(geom, FusedConfig(), seed=1, device="cpu")
    got = _np(run())
    i = {k: jnp.asarray(_np(v)) for k, v in run.inputs.items()}
    cfg = (JxNumerics(ideal=True) if ideal
           else JxNumerics(rows_per_xbar=geom.rows_per_xbar))
    ref = np.asarray(jx_fused(i["x"], i["nbr"], i["wts"], i["w"], i["b"],
                              cfg, relu=True, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_aggregate_runner_matches_reference():
    geom = AggregateGeometry(nd=20, n=30, f=24, sample=4)
    run = measure.aggregate_runner(geom, AggregateConfig(), seed=2,
                                   device="cpu")
    got = _np(run())
    i = {k: jnp.asarray(_np(v)) for k, v in run.inputs.items()}
    ref = np.asarray(jx_aggregate(i["x"], i["nbr"], i["wts"],
                                  backend="pallas", interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_cam_runner_matches_reference():
    geom = CamGeometry(e=50, q=7)
    run = measure.cam_runner(geom, CamConfig(), seed=4, device="cpu")
    got = [_np(t) for t in run()]
    ref = jx_search(jnp.asarray(_np(run.inputs["ci"])),
                    jnp.asarray(_np(run.inputs["queries"])),
                    backend="pallas", interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
