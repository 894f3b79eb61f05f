"""The port's hetGNN-LSTM taxi forecaster (§4.2) against the JAX package's.

The reference's small case (``tests/test_taxi.py``'s ``_setup``: a 4 x 4
region, P 5, Q 2, hidden 16, three 30-node random graphs) goes through
``repro.core.taxi`` and ``repro_torch.core.taxi`` on CPU tensors, with
the reference's parameters carried over by ``params_from_numpy`` and its
stream passed as numpy arrays. Forward within rtol 1e-5, atol 1e-5 *
max|ref|; the loss within rtol 1e-5; every gradient leaf within atol
1e-5 * max|ref| of that leaf. After three AdamW steps the first moments
hold the same bound and the parameters rtol 1e-5 with atol 1e-4 times the
summed learning rates: AdamW divides each gradient by its own running
scale, so an element whose gradient is small moves by about the learning
rate whatever its gradient's rounding, and the gradients' absolute
agreement (1e-5 * max|g|) bounds no relative error there.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import costmodel as jx_costmodel
from repro.core import random_graph as jx_random_graph
from repro.core import taxi as jx_taxi
from repro.core.graph import TAXI_STATS as JX_TAXI_STATS
from repro.optim import AdamWConfig as JxAdamWConfig
from repro.optim import adamw_init as jx_adamw_init
from repro.optim import adamw_update as jx_adamw_update
from repro_torch.core import taxi
from repro_torch.examples import taxi_forecast
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

N = 30
SMALL = dict(m=4, n=4, p_hist=5, q_future=2, hidden=16, lstm_hidden=16,
             sample=4)


@pytest.fixture(scope="module")
def case():
    """(reference config, port config, reference params, reference args,
    port args): the reference's ``_setup`` and a stream of P + Q steps."""
    cfg_jx = jx_taxi.TaxiConfig(**SMALL)
    key = jax.random.key(0)
    params = jax.tree.map(np.asarray, jx_taxi.init_params(key, cfg_jx))
    nbrs, wtss = [], []
    for r in range(cfg_jx.n_edge_types):
        g = jx_random_graph(N, N * 3, 1, seed=r).gcn_normalize()
        nbr, wts = g.neighbor_sample(cfg_jx.sample)
        nbrs.append(nbr)
        wtss.append(wts)
    stream = np.asarray(jx_taxi.synthetic_stream(
        key, N, cfg_jx.p_hist + cfg_jx.q_future, cfg_jx))
    x_hist = stream[:cfg_jx.p_hist]
    target = stream[cfg_jx.p_hist:].transpose(1, 0, 2).reshape(
        N, cfg_jx.q_future, cfg_jx.m, cfg_jx.n)
    arrays = (x_hist, np.stack(nbrs), np.stack(wtss), target)
    return (cfg_jx, taxi.TaxiConfig(**SMALL), params,
            tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.tensor(a) for a in arrays))


def _close(got: torch.Tensor, ref, rtol: float = 0.0) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=rtol,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_init_params_relational_shapes():
    cfg = taxi.TaxiConfig(m=4, n=4, hidden=16, n_edge_types=3)
    params = taxi.init_params(cfg, seed=0, device="cpu")
    ref = jx_taxi.init_params(jax.random.key(0), jx_taxi.TaxiConfig(
        m=4, n=4, hidden=16, n_edge_types=3))
    assert sorted(params) == sorted(ref)
    for k, v in params.items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32
    # one independent transform per edge type
    for r in range(1, cfg.n_edge_types):
        assert not torch.allclose(params["w_rel"][0], params["w_rel"][r])
    assert torch.equal(params["w_rel"],
                       taxi.init_params(cfg, seed=0, device="cpu")["w_rel"])


def test_forward_matches_reference(case):
    cfg_jx, cfg, params, jx_args, pt_args = case
    ref = jx_taxi.forward(params, *jx_args[:3], cfg_jx)
    got = taxi.forward(taxi.params_from_numpy(params, device="cpu"),
                       *pt_args[:3], cfg)
    assert tuple(got.shape) == (N, cfg.q_future, cfg.m, cfg.n)
    _close(got, ref, rtol=1e-5)


def test_grad_fn_matches_reference(case):
    cfg_jx, cfg, params, jx_args, pt_args = case
    loss_ref, grads_ref = jx_taxi.grad_fn(params, *jx_args, cfg_jx)
    loss, grads = taxi.grad_fn(taxi.params_from_numpy(params, device="cpu"),
                               *pt_args, cfg)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    assert sorted(grads) == sorted(grads_ref)
    for k, g in grads.items():
        assert not g.requires_grad
        _close(g, grads_ref[k])


def test_training_reduces_mse():
    """The reference's ``test_training_reduces_mse`` on the port's own
    parameters and stream: 150 steps of plain gradient descent."""
    cfg = taxi.TaxiConfig(**SMALL)
    nbrs, wtss = [], []
    for r in range(cfg.n_edge_types):
        g = jx_random_graph(N, N * 3, 1, seed=r).gcn_normalize()
        nbr, wts = g.neighbor_sample(cfg.sample)
        nbrs.append(nbr)
        wtss.append(wts)
    nbr, wts = torch.from_numpy(np.stack(nbrs)), torch.from_numpy(
        np.stack(wtss))
    params = taxi.init_params(cfg, seed=0, device="cpu")
    stream = taxi.synthetic_stream(0, N, cfg.p_hist + cfg.q_future, cfg,
                                   device="cpu")
    x_hist = stream[:cfg.p_hist]
    target = stream[cfg.p_hist:].permute(1, 0, 2).reshape(
        N, cfg.q_future, cfg.m, cfg.n)
    l0, _ = taxi.grad_fn(params, x_hist, nbr, wts, target, cfg)
    for _ in range(150):
        _, grads = taxi.grad_fn(params, x_hist, nbr, wts, target, cfg)
        params = {k: p - 0.3 * grads[k] for k, p in params.items()}
    l1, _ = taxi.grad_fn(params, x_hist, nbr, wts, target, cfg)
    assert float(l1) < float(l0) * 0.7, (float(l0), float(l1))


def test_adamw_steps_match_reference(case):
    """Three steps of the example's optimizer (AdamW, no weight decay,
    warm-up 10) on both sides."""
    cfg_jx, cfg, params, jx_args, pt_args = case
    ref, got = params, taxi.params_from_numpy(params, device="cpu")
    opt_jx = jx_adamw_init(ref)
    opt = adamw_init(got)
    kw = dict(lr=3e-3, weight_decay=0.0, warmup=10)
    for _ in range(3):
        _, g_jx = jx_taxi.grad_fn(ref, *jx_args, cfg_jx)
        ref, opt_jx, _ = jx_adamw_update(ref, g_jx, opt_jx,
                                         JxAdamWConfig(**kw))
        _, g = taxi.grad_fn(got, *pt_args, cfg)
        got, opt, _ = adamw_update(got, g, opt, AdamWConfig(**kw))
    assert int(opt["step"]) == int(opt_jx["step"]) == 3
    moved = kw["lr"] * (1 + 2 + 3) / kw["warmup"]     # the summed rates
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-4 * moved)
        _close(opt["m"][k], opt_jx["m"][k], rtol=1e-5)


def test_synthetic_stream_deterministic():
    cfg = taxi.TaxiConfig(**SMALL)
    a = taxi.synthetic_stream(3, N, 7, cfg, device="cpu")
    assert tuple(a.shape) == (7, N, cfg.region) and a.dtype == torch.float32
    assert torch.equal(a, taxi.synthetic_stream(3, N, 7, cfg, device="cpu"))
    assert not torch.equal(a, taxi.synthetic_stream(4, N, 7, cfg,
                                                     device="cpu"))
    assert float(a.abs().max()) < 1.5


def test_table1_lines_equal_reference():
    """The example's closing lines, from the port's cost model, equal the
    lines the reference's example prints from its own."""
    want = []
    for setting in ("centralized", "decentralized", "semi"):
        m = jx_costmodel.predict(setting, JX_TAXI_STATS, n_clusters=100)
        want.append(f"  {setting:14s} compute {m.t_compute*1e6:9.2f} us   "
                    f"comm {m.t_communicate*1e3:9.2f} ms   "
                    f"P_compute {m.p_compute*1e3:7.2f} mW")
    assert taxi_forecast.table1_lines()[1:] == want


def test_example_runs_on_cpu(capsys):
    taxi_forecast.main(["--nodes", "24", "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("trained 3 steps") for ln in out)
    assert any(ln.startswith("device cpu:") for ln in out)
    assert out[-4:] == taxi_forecast.table1_lines()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = taxi.TaxiConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taxi.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taxi.synthetic_stream(0, N, 4, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taxi_forecast.main(["--nodes", "8", "--steps", "1"])
