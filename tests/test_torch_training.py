"""The port's GNN training against the JAX package's.

One graph, one set of labels and the reference's parameters (carried over
by ``params_from_numpy``) go through ``repro.core.gnn.loss_fn`` /
``grad_fn`` and through ``repro_torch.core.gnn``'s on CPU tensors, with
ideal, default and 12-bit-ADC/64-row crossbar numerics. The loss within
rtol 1e-5, every gradient leaf within atol 1e-5 * max|g_ref| of that
leaf. The hand-written kernels are forward-only in both packages:
``grad_fn`` raises on ``pallas`` and ``fused``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import gnn as jx_gnn
from repro.core.graph import random_graph as jx_random_graph
from repro.kernels.crossbar_mvm import CrossbarNumerics as JxNumerics
from repro.kernels.crossbar_mvm import (
    crossbar_matmul_signed_ref as jx_signed_ref)
from repro_torch.core import gnn
from repro_torch.core.graph import random_graph
from repro_torch.kernels.crossbar_mvm import (CrossbarNumerics,
                                              crossbar_matmul_signed_ref)

QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
NUMERICS = {"ideal": dict(ideal=True), "bit-accurate": QUANT,
            "default bit-accurate": {}}
DIMS = dict(in_dim=16, hidden_dims=(32,), out_dim=4, sample=8)


@pytest.fixture(scope="module")
def case():
    """(reference args, port args) on the 50-node graph of the reference's
    ``test_training_reduces_loss``."""
    g = jx_random_graph(50, 250, 16, seed=1).gcn_normalize()
    nbr, wts = g.neighbor_sample(8)
    labels = np.random.default_rng(0).integers(0, 4, 50).astype(np.int32)
    arrays = (g.features, nbr, wts, labels)
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


def _configs(numerics: str, backend: str = "jnp"):
    kw = NUMERICS[numerics]
    return (jx_gnn.GNNConfig(**DIMS, numerics=JxNumerics(**kw),
                             backend=backend),
            gnn.GNNConfig(**DIMS, numerics=CrossbarNumerics(**kw),
                          backend=backend))


def _params(cfg_jx, zero_column: bool = False) -> list:
    params = jax.tree.map(np.array, jx_gnn.init_params(jax.random.key(3),
                                                       cfg_jx))
    if zero_column:
        # one pre-activation column of layer 1 exactly 0 (b is 0): the
        # ReLU's gradient at 0 decides layer 1's gradients
        params[0]["w"][:, 5] = 0.0
    return params


def _assert_grads_close(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g_layer, r_layer in zip(got, ref):
        assert sorted(g_layer) == sorted(r_layer)
        for k in r_layer:
            r = np.asarray(r_layer[k])
            assert not g_layer[k].requires_grad
            np.testing.assert_allclose(g_layer[k].numpy(), r, rtol=0,
                                       atol=1e-5 * float(np.abs(r).max()))


@pytest.mark.parametrize("numerics", sorted(NUMERICS))
@pytest.mark.parametrize("backend", ["jnp", "pallas", "fused"])
def test_loss_fn_matches_reference(case, backend, numerics):
    jx_args, pt_args = case
    cfg_jx, cfg = _configs(numerics, backend)
    params = _params(cfg_jx)
    ref = float(jx_gnn.loss_fn(params, *jx_args, cfg_jx))
    got = gnn.loss_fn(gnn.params_from_numpy(params, device="cpu"),
                      *pt_args, cfg)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("zero_column", [False, True],
                         ids=["random", "zero-column"])
@pytest.mark.parametrize("numerics", sorted(NUMERICS))
def test_grad_fn_matches_reference(case, numerics, zero_column):
    jx_args, pt_args = case
    cfg_jx, cfg = _configs(numerics)
    params = _params(cfg_jx, zero_column)
    loss_ref, grads_ref = jx_gnn.grad_fn(params, *jx_args, cfg_jx)
    port_params = gnn.params_from_numpy(params, device="cpu")
    loss, grads = gnn.grad_fn(port_params, *pt_args, cfg)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    _assert_grads_close(grads, grads_ref)
    # the parameters are left as they were, outside any graph
    for layer, ref_layer in zip(port_params, params):
        for k in layer:
            assert not layer[k].requires_grad
            np.testing.assert_array_equal(layer[k].numpy(), ref_layer[k])


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_grad_fn_raises_on_kernel_backends(case, backend):
    jx_args, pt_args = case
    cfg_jx, cfg = _configs("ideal", backend)
    params = _params(cfg_jx)
    with pytest.raises(NotImplementedError):
        jx_gnn.grad_fn(params, *jx_args, cfg_jx)
    with pytest.raises(NotImplementedError):
        gnn.grad_fn(gnn.params_from_numpy(params, device="cpu"), *pt_args,
                    cfg)


def test_training_reduces_loss():
    g = random_graph(50, 250, 16, seed=1).gcn_normalize()
    cfg = gnn.GNNConfig(**DIMS)
    params = gnn.init_params(cfg, seed=3, device="cpu")
    nbr, wts = g.neighbor_sample(8)
    labels = torch.from_numpy(
        np.random.default_rng(0).integers(0, 4, 50))
    args = (torch.from_numpy(g.features), torch.from_numpy(nbr),
            torch.from_numpy(wts), labels, cfg)
    l0, _ = gnn.grad_fn(params, *args)
    for _ in range(40):
        _, grads = gnn.grad_fn(params, *args)
        params = [{k: p[k] - 0.5 * gr[k] for k in p}
                  for p, gr in zip(params, grads)]
    l1, _ = gnn.grad_fn(params, *args)
    assert float(l1) < float(l0) * 0.8


# inputs of the signed crossbar with ties on every piecewise-linear op of
# its gradient: entries at exactly 0 (the split into two DAC passes), an
# abs-max shared by two entries of opposite sign, and a tensor whose
# abs-max sits exactly on the scale floor 1e-8
def _tie_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    x[:, 3] = 0.0
    x[0, 0], x[1, 1] = 4.0, -4.0
    w = rng.normal(size=(20, 5)).astype(np.float32)
    w[2, 2] = 3.5
    w[4, 1] = -3.5
    floor = np.zeros((6, 20), np.float32)
    floor[2, 2], floor[3, 4] = np.float32(1e-8), -np.float32(1e-8)
    return [(x, w), (floor, w)]


@pytest.mark.parametrize("numerics", ["bit-accurate",
                                      "default bit-accurate"])
@pytest.mark.parametrize("which", [0, 1], ids=["ties", "scale-floor"])
def test_signed_crossbar_gradient_ties_match_reference(numerics, which):
    x, w = _tie_inputs()[which]
    kw = NUMERICS[numerics]
    jx_cfg, cfg = JxNumerics(**kw), CrossbarNumerics(**kw)
    out_w = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    loss_ref = lambda a, b: jnp.sum(jx_signed_ref(a, b, jx_cfg) * out_w)
    gx_ref, gw_ref = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(x),
                                                        jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    torch.sum(crossbar_matmul_signed_ref(xt, wt, cfg)
              * torch.from_numpy(out_w)).backward()
    for got, ref in ((xt.grad, gx_ref), (wt.grad, gw_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
