"""The port's kernel wrappers and plain versions against the JAX package.

Same inputs, made with numpy from a seed, go through ``repro`` (Pallas in
interpret mode on the CPU) and through ``repro_torch`` on CPU tensors,
where each wrapper runs its kernel's plain version. Tolerances:

  * layers: rtol 1e-4, atol 1e-4 * max|ref| (the reference's own
    ``tests/test_kernels_fused_layer.py``): matmul and gather sums run in
    another order;
  * aggregation: rtol 1e-5, atol 1e-4 (``test_kernels_csr_aggregate.py``);
  * quantizers: exact (same f32 divisions, round half to even);
  * the crossbar pass on codes: rtol 1e-6, atol 1e-6 * max|ref|, well
    below one ADC step (the tile sums are added in another order);
  * the signed crossbar product: rtol/atol 1e-5 (float rounding of the
    rescale and of the pos - neg recombination);
  * the CAM search: exact.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import crossbar_mvm as jx_xbar
from repro.kernels.cam_match import scan as jx_scan
from repro.kernels.cam_match import search as jx_search
from repro.kernels.crossbar_mvm.crossbar_mvm import (
    crossbar_matmul_quantized as jx_xbar_quantized)
from repro.kernels.csr_aggregate import aggregate as jx_aggregate
from repro.kernels.fused_layer import fused_gnn_layer as jx_fused_layer
from repro.kernels.fused_layer import fused_zmax as jx_zmax
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import crossbar_mvm as pt_xbar
from repro_torch.kernels.cam_match import cam_search, scan, search
from repro_torch.kernels.csr_aggregate import aggregate, csr_aggregate
from repro_torch.kernels.fused_layer import (fused_gnn_layer,
                                             fused_ideal_layer_plain,
                                             fused_layer_ref, fused_zmax)

QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
IDEAL = dict(ideal=True)
DEFAULT = dict()                        # the bit-accurate default numerics


def _case(n, f, h, nd, s, seed=0, zero_rows=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    nbr = rng.integers(0, n, size=(nd, s)).astype(np.int32)
    wts = rng.normal(size=(nd, s)).astype(np.float32)
    wts[:zero_rows] = 0.0
    w = rng.normal(size=(f, h)).astype(np.float32)
    b = rng.normal(size=(h,)).astype(np.float32)
    return x, nbr, wts, w, b


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, ref, rtol=1e-4, atol_rel=1e-4):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_rel * scale)


LAYER_CASES = [
    # (numerics, n, f, h, nd, s, zero_rows)
    (IDEAL, 20, 32, 16, 20, 4, 0),        # aligned
    (IDEAL, 23, 50, 17, 11, 5, 0),        # odd shapes, Nd != N
    (IDEAL, 7, 300, 33, 7, 1, 0),         # F > 128, S = 1
    (IDEAL, 40, 16, 128, 40, 9, 0),       # H > F
    (QUANT, 20, 32, 16, 20, 4, 0),
    (QUANT, 23, 50, 17, 11, 5, 0),
    (QUANT, 7, 130, 33, 7, 3, 0),         # three 64-row crossbars
    (QUANT, 16, 48, 8, 16, 6, 0),         # signed Z: the neg DAC pass
    (DEFAULT, 30, 40, 12, 30, 6, 0),      # 512-row crossbars
    (IDEAL, 12, 32, 8, 5, 4, 5),          # zero-degree rows only
    (QUANT, 12, 32, 8, 5, 4, 5),
    (QUANT, 24, 40, 10, 24, 5, 7),        # some zero-degree rows
]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("numerics,n,f,h,nd,s,zero_rows", LAYER_CASES)
def test_fused_layer_matches_reference(numerics, n, f, h, nd, s, zero_rows,
                                       relu):
    x, nbr, wts, w, b = _case(n, f, h, nd, s, seed=n + f,
                              zero_rows=zero_rows)
    ref = jx_fused_layer(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts),
                         jnp.asarray(w), jnp.asarray(b),
                         jx_xbar.CrossbarNumerics(**numerics), relu=relu,
                         bf=32)
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    got = fused_gnn_layer(*_t(x, nbr, wts, w, b), cfg, relu=relu)
    _close(got, ref)
    if zero_rows:            # zero-degree rows give exactly act(b)
        want = np.maximum(b, 0) if relu else b
        np.testing.assert_array_equal(got[:zero_rows].numpy(),
                                      np.tile(want, (zero_rows, 1)))
    # the composed plain path agrees too
    _close(fused_layer_ref(*_t(x, nbr, wts, w, b), cfg, relu=relu), ref)


def test_fused_layer_with_conductance_noise():
    """A w_noise draw (multiples of 1/8, as devices.variation makes) moves
    the programmed codes the same way on both sides."""
    x, nbr, wts, w, b = _case(20, 70, 12, 20, 5, seed=9)
    noise = (np.random.default_rng(3).integers(-4, 5, size=(70, 12))
             / 8.0).astype(np.float32)
    cfg_jx = jx_xbar.CrossbarNumerics(**QUANT)
    ref = jx_fused_layer(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts),
                         jnp.asarray(w), jnp.asarray(b), cfg_jx, relu=True,
                         bf=32, w_noise=jnp.asarray(noise))
    got = fused_gnn_layer(*_t(x, nbr, wts, w, b),
                          pt_xbar.CrossbarNumerics(**QUANT), relu=True,
                          w_noise=torch.from_numpy(noise))
    _close(got, ref)
    clean = fused_gnn_layer(*_t(x, nbr, wts, w, b),
                            pt_xbar.CrossbarNumerics(**QUANT), relu=True)
    assert not torch.equal(got, clean)


@pytest.mark.parametrize("n,f,nd,s", [(20, 32, 20, 4), (23, 50, 11, 5),
                                      (7, 300, 7, 1)])
def test_aggregate_matches_reference(n, f, nd, s):
    x, nbr, wts, _, _ = _case(n, f, 1, nd, s, seed=f)
    ref = jx_aggregate(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts),
                       backend="pallas")
    for backend in ("jnp", "pallas"):
        got = aggregate(*_t(x, nbr, wts), backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("bf", [0, -128])
def test_aggregate_rejects_non_positive_bf(bf):
    x, nbr, wts, _, _ = _case(8, 16, 1, 8, 2)
    with pytest.raises(ValueError, match="bf"):
        aggregate(*_t(x, nbr, wts), backend="pallas", bf=bf)


def test_zmax_matches_reference():
    x, nbr, wts, _, _ = _case(23, 50, 1, 11, 5, seed=4, zero_rows=2)
    ref = jx_zmax(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts))
    got = fused_zmax(*_t(x, nbr, wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert (got[:2] == 0).all()


def test_ideal_plain_matches_composed_oracle():
    x, nbr, wts, w, b = _case(23, 50, 17, 11, 5, seed=2)
    got = fused_ideal_layer_plain(*_t(x, nbr, wts, w, b), relu=True)
    _close(got, fused_layer_ref(*_t(x, nbr, wts, w, b), relu=True))


@pytest.mark.parametrize("numerics", [QUANT, DEFAULT])
def test_crossbar_oracles_match_reference(numerics):
    """Quantizer codes and scales are exact; one unsigned pass and the
    signed product agree within float rounding of the rescale."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, 130)).astype(np.float32)
    w = rng.normal(size=(130, 11)).astype(np.float32)
    jc, pc = (jx_xbar.CrossbarNumerics(**numerics),
              pt_xbar.CrossbarNumerics(**numerics))
    from repro.kernels.crossbar_mvm.ref import (quantize_inputs,
                                                quantize_weights)
    xq, xs = quantize_inputs(jnp.asarray(np.abs(x)), jc)
    pxq, pxs = pt_xbar.quantize_inputs(torch.from_numpy(np.abs(x)), pc)
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq, np.int32))
    assert float(pxs) == float(xs)
    wq, ws = quantize_weights(jnp.asarray(w), jc)
    pwq, pws = pt_xbar.quantize_weights(torch.from_numpy(w), pc)
    np.testing.assert_array_equal(pwq.numpy(), np.asarray(wq))
    assert float(pws) == float(ws)
    ref = jx_xbar.crossbar_matmul_ref(jnp.asarray(np.abs(x)),
                                      jnp.asarray(w), jc)
    got = pt_xbar.crossbar_matmul_ref(torch.from_numpy(np.abs(x)),
                                      torch.from_numpy(w), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
    ref = jx_xbar.crossbar_matmul_signed_ref(jnp.asarray(x), jnp.asarray(w),
                                             jc)
    got = pt_xbar.crossbar_matmul_signed_ref(torch.from_numpy(x),
                                             torch.from_numpy(w), pc)
    _close(got, ref, rtol=1e-5, atol_rel=1e-5)


def _noisy_codes(m, k, n, seed, noisy=True):
    """DAC codes [M, K] and conductance codes [K, N]; with ``noisy``, the
    codes carry a conductance-noise draw on the 1/8 grid (sigma 0.05 * 127
    codes, as ``devices.variation`` makes for ReRAM)."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(0, 256, size=(m, k)).astype(np.int32)
    wq = np.clip(np.round(rng.normal(size=(k, n)) * 60), -127, 127)
    if noisy:
        nz = np.round(rng.normal(size=(k, n)) * 0.05 * 127 * 8) / 8
        wq = np.clip(wq + nz, -127, 127)
    return xq, wq.astype(np.float32)


@pytest.mark.parametrize("numerics,m,k,n,noisy", [
    (QUANT, 64, 256, 64, True),     # 12-bit ADC: ties of p / lsb move
    (QUANT, 16, 192, 32, False),
    (DEFAULT, 16, 512, 128, True),
])
def test_crossbar_code_pass_matches_reference_kernel(numerics, m, k, n,
                                                     noisy):
    """The ADC multiplies by the f32 reciprocal of its step, as XLA
    computes the reference's division by the constant step: on noisy
    codes an IEEE division lands a whole ADC code (x 2^b) away."""
    xq, wq = _noisy_codes(m, k, n, seed=m + k, noisy=noisy)
    ref = np.asarray(jx_xbar_quantized(
        jnp.asarray(xq.astype(np.uint32)), jnp.asarray(wq),
        jx_xbar.CrossbarNumerics(**numerics), bm=m, bn=n, interpret=True))
    got = pt_xbar.crossbar_matmul_quantized(
        *_t(xq, wq), pt_xbar.CrossbarNumerics(**numerics))
    _close(got, ref, rtol=1e-6, atol_rel=1e-6)


def test_crossbar_quantized_wrapper_is_its_plain_version_on_cpu():
    """Ragged M, K and N need no padding; the block knobs are validated
    and change nothing."""
    xq, wq = _noisy_codes(7, 150, 11, seed=1)
    cfg = pt_xbar.CrossbarNumerics(**QUANT)
    plain = pt_xbar.crossbar_matmul_quantized_plain(*_t(xq, wq), cfg)
    for blocks in (dict(), dict(bm=8, bn=16, depth=3), dict(depth=1)):
        assert torch.equal(pt_xbar.crossbar_matmul_quantized(
            *_t(xq, wq), cfg, **blocks), plain)
    for bad in (dict(bm=0), dict(bn=-1), dict(depth=2), dict(depth=0)):
        with pytest.raises(ValueError):
            pt_xbar.crossbar_matmul_quantized(*_t(xq, wq), cfg, **bad)
    with pytest.raises(TypeError):
        pt_xbar.crossbar_matmul_quantized(*_t(xq.astype(np.int64), wq), cfg)
    with pytest.raises(NotImplementedError, match="tuning"):
        pt_xbar.crossbar_matmul(*_t(np.abs(wq.T), wq), cfg, tuned={})


@pytest.mark.parametrize("numerics", [QUANT, DEFAULT])
@pytest.mark.parametrize("noisy", [False, True])
def test_crossbar_matmul_signed_matches_reference(numerics, noisy):
    """The kernel-backed signed product against the reference's Pallas
    ops path; on one device it equals the port's plain oracle exactly."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 130)).astype(np.float32)
    w = (rng.normal(size=(130, 24)) * 0.1).astype(np.float32)
    nz = (np.round(rng.normal(size=(130, 24)) * 0.05 * 127 * 8) / 8
          ).astype(np.float32) if noisy else None
    jc = jx_xbar.CrossbarNumerics(**numerics)
    pc = pt_xbar.CrossbarNumerics(**numerics)
    ref = jx_xbar.crossbar_matmul_signed(
        jnp.asarray(x), jnp.asarray(w), jc, interpret=True,
        w_noise=None if nz is None else jnp.asarray(nz))
    tn = None if nz is None else torch.from_numpy(nz)
    got = pt_xbar.crossbar_matmul_signed(*_t(x, w), pc, w_noise=tn)
    _close(got, ref, rtol=1e-5, atol_rel=1e-5)
    assert torch.equal(got, pt_xbar.crossbar_matmul_signed_ref(
        *_t(x, w), pc, w_noise=tn))
    unsigned = pt_xbar.crossbar_matmul(*_t(np.abs(x), w), pc, w_noise=tn)
    assert torch.equal(unsigned, pt_xbar.crossbar_matmul_ref(
        *_t(np.abs(x), w), pc, w_noise=tn))


@pytest.mark.parametrize("e,q", [(256, 16), (1000, 7), (5, 33), (0, 4),
                                 (9, 0)])
def test_cam_search_matches_reference(e, q):
    """Ragged shapes and negative queries (which match nothing) give the
    reference's bitmap and counts exactly (its Pallas path takes no empty
    operand; its jnp oracle does)."""
    rng = np.random.default_rng(e + q)
    ci = rng.integers(-2, 20, size=e).astype(np.int32)
    queries = rng.integers(-3, 20, size=q).astype(np.int32)
    ref_match, ref_counts = jx_search(
        jnp.asarray(ci), jnp.asarray(queries),
        backend="pallas" if e and q else "jnp", interpret=True)
    match, counts = cam_search(*_t(ci, queries))
    assert match.dtype == torch.int8 and counts.dtype == torch.int32
    np.testing.assert_array_equal(match.numpy(), np.asarray(ref_match))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    for backend in ("jnp", "pallas"):
        m2, c2 = search(*_t(ci, queries), backend=backend, bq=4, be=64)
        assert torch.equal(m2, match) and torch.equal(c2, counts)
    if q:
        assert int(counts[queries < 0].abs().sum()) == 0


def test_cam_search_contract_errors_and_scan():
    ci, queries = _t(np.arange(8, dtype=np.int32),
                     np.array([1, 2], np.int32))
    for bad in (dict(bq=0), dict(be=-128)):
        with pytest.raises(ValueError):
            search(ci, queries, backend="pallas", **bad)
    with pytest.raises(NotImplementedError, match="tuning"):
        search(ci, queries, backend="pallas", tuned={})
    with pytest.raises(ValueError, match="backend"):
        search(ci, queries, backend="mosaic")
    with pytest.raises(TypeError):
        cam_search(ci.long(), queries)
    rp = np.array([0, 2, 2, 5, 9], np.int32)
    pos = np.arange(9, dtype=np.int32)
    np.testing.assert_array_equal(
        scan(*_t(rp, pos)).numpy(),
        np.asarray(jx_scan(jnp.asarray(rp), jnp.asarray(pos))))


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    reset_launch_counts()
    x, nbr, wts, w, b = _case(20, 32, 16, 20, 4)
    for numerics in (IDEAL, QUANT):
        fused_gnn_layer(*_t(x, nbr, wts, w, b),
                        pt_xbar.CrossbarNumerics(**numerics))
    csr_aggregate(*_t(x, nbr, wts))
    xq, wq = _noisy_codes(4, 32, 8, seed=0)
    pt_xbar.crossbar_matmul_quantized(*_t(xq, wq),
                                      pt_xbar.CrossbarNumerics(**QUANT))
    cam_search(*_t(nbr.reshape(-1), np.arange(4, dtype=np.int32)))
    assert launch_counts() == {
        "fused_ideal_layer": 0, "fused_zmax": 0, "fused_quant_layer": 0,
        "csr_aggregate": 0, "crossbar_matmul_quantized": 0,
        "cam_search": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, nbr, wts, w, b = _case(8, 16, 4, 8, 2)
    xt, nt, wt, Wt, bt = _t(x, nbr, wts, w, b)
    with pytest.raises(TypeError):
        csr_aggregate(xt, nt.long(), wt)
    with pytest.raises(ValueError):
        csr_aggregate(xt.t(), nt, wt)
    with pytest.raises(ValueError):
        fused_gnn_layer(xt, nt, wt, Wt[:-1].contiguous(), bt)
