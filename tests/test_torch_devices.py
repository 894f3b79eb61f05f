"""The port's device technologies and conductance-variation bounds against
the JAX package.

The technology records, the noise draws (numpy, seeded) and the modeled
p99 error are equal to the reference's exactly. The Monte-Carlo bounds go
through the crossbar numerics, where the port's ``jnp`` (plain) and
``pallas`` (kernel wrapper) backends are equal field for field, and within
rtol 1e-5 of the reference's ``pallas`` path (float rounding of the rescale
and of the pos - neg recombination; the reference's own two backends differ
there too). ``noisy_forward`` on the ``fused`` backend is held to the
reference's fused layer at 1e-4 * max|ref| (its own fused-vs-composed
tolerance), with parameters carried across by ``gnn.params_from_numpy``
and the same numpy noise draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import devices as jx
from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro_torch import devices as pt
from repro_torch.core import gnn
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics

TECHS = ("sot-mram", "reram", "sram", "fefet")
QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
BOUNDS_KW = dict(m=8, k=64, n=16, trials=4)


def test_technology_bank_matches_reference():
    assert pt.technology_table() == jx.technology_table()
    assert pt.known_technologies() == jx.known_technologies()
    assert pt.ANCHOR == jx.ANCHOR
    for name in TECHS:
        assert pt.primitive_scales(name) == jx.primitive_scales(name)
    with pytest.raises(pt.UnknownTechnologyError, match="registered"):
        pt.resolve_technology("sot_mram")


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("numerics", [dict(), QUANT, dict(w_bits=4)])
def test_noise_draws_and_model_match_reference(tech, numerics):
    jc, pc = JxNumerics(**numerics), CrossbarNumerics(**numerics)
    for seed in (7, [3, 1], [0, 5, 2]):
        ref = jx.sample_conductance_noise(seed, (24, 9), tech, jc)
        got = pt.sample_conductance_noise(seed, (24, 9), tech, pc)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.float32
        assert np.array_equal(got * pt.NOISE_GRID,
                              np.round(got * pt.NOISE_GRID))
    for k_rows in (1, 64, 216, 512, 1500):
        assert pt.modeled_p99_error(tech, k_rows, pc) == \
            jx.modeled_p99_error(tech, k_rows, jc)


def test_layer_noise_matches_reference():
    shapes = [(40, 24), (24, 6)]
    jx_params = [{"w": np.zeros(s, np.float32)} for s in shapes]
    pt_params = [{"w": torch.zeros(s)} for s in shapes]
    ref = jx.layer_noise([0, 3], jx_params, "reram", JxNumerics())
    got = pt.layer_noise([0, 3], pt_params, "reram", CrossbarNumerics())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _fields_close(got, ref, rtol):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(a, float):
            assert a == pytest.approx(b, rel=rtol, abs=1e-12), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("tech", TECHS)
def test_mvm_error_bounds_match_reference(tech):
    ref = jx.mvm_error_bounds(tech, **BOUNDS_KW, backend="pallas",
                              interpret=True)
    plain = pt.mvm_error_bounds(tech, **BOUNDS_KW, backend="jnp",
                                device="cpu")
    kernel = pt.mvm_error_bounds(tech, **BOUNDS_KW, backend="pallas",
                                 device="cpu")
    assert plain == kernel                      # field for field
    _fields_close(kernel, ref, rtol=1e-5)
    if tech == "sram":
        assert kernel.mean_err == kernel.p99_err == kernel.ci95 == 0.0


def test_mvm_error_bounds_contracts():
    a = pt.mvm_error_bounds("fefet", **BOUNDS_KW, seed=3, device="cpu")
    assert a == pt.mvm_error_bounds("fefet", **BOUNDS_KW, seed=3,
                                    device="cpu")
    other = pt.mvm_error_bounds("fefet", m=8, k=64, n=16, trials=6,
                                seed=11, device="cpu")
    assert a.within_ci(other) and other.seed == 11
    errs = [pt.mvm_error_bounds(t, **BOUNDS_KW, device="cpu").mean_err
            for t in sorted(TECHS, key=lambda t: pt.resolve_technology(
                t).noise_sigma)]
    assert errs == sorted(errs)
    with pytest.raises(ValueError, match="backend"):
        pt.mvm_error_bounds("reram", **BOUNDS_KW, backend="fused",
                            device="cpu")


def _forward_case(numerics):
    g = jx_random_graph(60, 400, 40, seed=3).gcn_normalize()
    nbr, wts = g.neighbor_sample(6)
    jcfg = jx_gnn.GNNConfig(in_dim=40, hidden_dims=(24,), out_dim=6,
                            sample=6, numerics=JxNumerics(**numerics))
    params = jx_gnn.init_params(jax.random.key(1), jcfg)
    noise = jx.layer_noise([0, 1], params, "reram", JxNumerics(**numerics))
    return g, nbr, wts, jcfg, params, noise


@pytest.mark.parametrize("numerics", [QUANT, dict()])
def test_noisy_forward_matches_reference(numerics):
    g, nbr, wts, jcfg, params, noise = _forward_case(numerics)
    xs = (g.features, nbr, wts)
    ref = np.asarray(jx.noisy_forward(
        params, *map(jnp.asarray, xs),
        dataclasses.replace(jcfg, backend="fused"), noise, interpret=True))
    oracle = np.asarray(jx.noisy_forward(
        params, *map(jnp.asarray, xs),
        dataclasses.replace(jcfg, backend="jnp"), noise))
    scale = float(np.abs(ref).max())
    pparams = gnn.params_from_numpy(params, device="cpu")
    pxs = tuple(torch.from_numpy(np.asarray(a)) for a in xs)
    outs = {}
    for backend in ("fused", "pallas", "jnp"):
        pcfg = gnn.GNNConfig(in_dim=40, hidden_dims=(24,), out_dim=6,
                             sample=6, numerics=CrossbarNumerics(**numerics),
                             backend=backend)
        outs[backend] = pt.noisy_forward(pparams, *pxs, pcfg, noise).numpy()
    np.testing.assert_allclose(outs["fused"], ref, rtol=1e-4,
                               atol=1e-4 * scale)
    # the port's three backends agree bit for bit on one device
    assert np.array_equal(outs["fused"], outs["jnp"])
    assert np.array_equal(outs["pallas"], outs["jnp"])
    # The reference's jitted oracle and its Pallas kernels can split by
    # whole ADC steps under noise at larger shapes; on these shapes they
    # do not, and the port lands within f32 rounding of the oracle (about
    # 3e-7 * max|ref|). 1e-5 holds that with room to spare and stays
    # below the size of one ADC step at the high input bits.
    np.testing.assert_allclose(outs["jnp"], oracle, rtol=1e-5,
                               atol=1e-5 * scale)


def test_noisy_forward_rejects_ideal_numerics_and_moves_outputs():
    g, nbr, wts, jcfg, params, noise = _forward_case(QUANT)
    pparams = gnn.params_from_numpy(params, device="cpu")
    pxs = tuple(torch.from_numpy(np.asarray(a)) for a in (g.features, nbr,
                                                          wts))
    pcfg = gnn.GNNConfig(in_dim=40, hidden_dims=(24,), out_dim=6, sample=6,
                         numerics=CrossbarNumerics(**QUANT), backend="fused")
    clean = pt.noisy_forward(pparams, *pxs, pcfg, [None, None])
    assert torch.equal(clean, gnn.forward(pparams, *pxs, pcfg))
    assert not torch.equal(pt.noisy_forward(pparams, *pxs, pcfg, noise),
                           clean)
    with pytest.raises(ValueError, match="bit-accurate"):
        pt.noisy_forward(pparams, *pxs, dataclasses.replace(
            pcfg, numerics=CrossbarNumerics(ideal=True)), noise)


def test_accuracy_bounds_contracts():
    kw = dict(scale=0.004, trials=2, hidden=16, out_dim=4, device="cpu")
    quiet = pt.accuracy_bounds("sram", **kw)
    assert quiet.mean_err == 0.0 and quiet.flip_rate == 0.0
    noisy = {b: pt.accuracy_bounds("reram", backend=b, **kw)
             for b in ("jnp", "pallas", "fused")}
    assert noisy["jnp"] == noisy["pallas"] == noisy["fused"]
    assert noisy["jnp"].mean_err > 0.0
    assert 0.0 <= noisy["jnp"].flip_rate <= 1.0
    assert noisy["jnp"].technology == "reram" and noisy["jnp"].trials == 2
