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
  * the CAM search: exact;
  * the quant kernel's int8 digits and integer formulation against the
    f32 partials of the plain version: exact;
  * the ideal kernel's 3xTF32 formulation against the plain ideal layer:
    rtol 1e-5, atol 1e-5 * max|ref| (``chip_smoke.py``'s check).
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
from repro_torch.kernels.crossbar_mvm import ops as xbar_ops
from repro_torch.kernels.crossbar_mvm.ref import _adc
from repro_torch.kernels.cam_match import cam_search, scan, search
from repro_torch.kernels.csr_aggregate import aggregate, csr_aggregate
from repro_torch.kernels.fused_layer import (fused_gnn_layer,
                                             fused_ideal_layer_plain,
                                             fused_layer_ref,
                                             fused_quant_layer, fused_zmax)
from repro_torch.kernels.fused_layer import ops as fl_ops
from repro_torch.tuning import (CamConfig, CamGeometry, CrossbarConfig,
                                CrossbarGeometry, TunedKernels)

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
    (IDEAL, 9, 600, 24, 9, 3, 0),         # F beyond one K chunk of the
    (IDEAL, 7, 1100, 16, 7, 2, 0),        # ideal kernel's gather window
    (IDEAL, 10, 40, 130, 10, 4, 0),       # H beyond one column tile
    (dict(in_bits=12), 20, 40, 12, 20, 5, 0),   # DAC codes of two bytes
    (dict(in_bits=16, adc_bits=12, rows_per_xbar=64), 20, 40, 12, 20, 5, 0),
    (dict(w_bits=12, rows_per_xbar=64), 20, 40, 12, 20, 5, 0),  # 2 digits
    (dict(w_bits=16, rows_per_xbar=64), 23, 130, 17, 11, 5, 0),  # 3 digits
    (dict(in_bits=30), 20, 40, 12, 20, 5, 0),   # the widest DAC codes
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


@pytest.mark.parametrize("numerics", [
    dict(w_bits=12, rows_per_xbar=64), dict(w_bits=16, rows_per_xbar=64),
    dict(in_bits=16, adc_bits=12, rows_per_xbar=64)])
def test_wide_numerics_with_conductance_noise(numerics):
    """Conductance noise on 12- and 16-bit codes (two and three int8
    digits on the card) and on 16-bit DAC codes moves the programmed codes
    the same way on both sides."""
    x, nbr, wts, w, b = _case(20, 70, 12, 20, 5, seed=10)
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    noise = (np.round(np.random.default_rng(4).normal(size=(70, 12))
                      * 0.05 * cfg.w_levels * 8) / 8).astype(np.float32)
    ref = jx_fused_layer(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts),
                         jnp.asarray(w), jnp.asarray(b),
                         jx_xbar.CrossbarNumerics(**numerics), relu=True,
                         bf=32, w_noise=jnp.asarray(noise))
    got = fused_gnn_layer(*_t(x, nbr, wts, w, b), cfg, relu=True,
                          w_noise=torch.from_numpy(noise))
    _close(got, ref)


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


@pytest.mark.parametrize("numerics,k,wide", [
    (DEFAULT, 512, 512.0),              # beyond +-511: three digits
    (QUANT, 256, -600.0),
    (dict(in_bits=12), 512, None),      # DAC codes of two bytes
    (dict(in_bits=16, adc_bits=12, rows_per_xbar=64), 256, None),
    (dict(w_bits=12, rows_per_xbar=64), 256, None),
    (dict(w_bits=16, rows_per_xbar=64), 256, None),
    (dict(in_bits=30), 512, None),      # the widest DAC codes
])
@pytest.mark.parametrize("noisy", [False, True])
def test_crossbar_takes_wide_codes_like_the_reference(numerics, k, wide,
                                                      noisy):
    """Codes the int8 digits of two could not hold (beyond +-511, w_bits
    12 and 16) and DAC codes of 12 and 16 bits compute, and agree with the
    reference's kernel as the 8-bit codes do."""
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    rng = np.random.default_rng(k + cfg.w_bits + cfg.in_bits)
    xq = rng.integers(0, 1 << cfg.in_bits, size=(16, k)).astype(np.int32)
    wq, _ = _grid_codes(k, 32, cfg.w_bits, noisy, seed=k)
    wq = wq.numpy()
    if wide is not None:
        wq[3, 4] = wide
    ref = np.asarray(jx_xbar_quantized(
        jnp.asarray(xq.astype(np.uint32)), jnp.asarray(wq),
        jx_xbar.CrossbarNumerics(**numerics), bm=16, bn=32, interpret=True))
    got = pt_xbar.crossbar_matmul_quantized(*_t(xq, wq), cfg)
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
    # a tuned bundle is honoured and changes nothing (on the card neither)
    x, w = _t(np.ascontiguousarray(np.abs(wq.T)), wq)
    geom = CrossbarGeometry(m=x.shape[0], k=x.shape[1], n=w.shape[1],
                            rows_per_xbar=cfg.rows_per_xbar,
                            in_bits=cfg.in_bits)
    tuned = TunedKernels.of({geom.key(): CrossbarConfig(bn=16, depth=1)})
    assert torch.equal(pt_xbar.crossbar_matmul(x, w, cfg, tuned=tuned),
                       pt_xbar.crossbar_matmul(x, w, cfg))


@pytest.mark.parametrize("bad,numerics,match", [
    (0.3, DEFAULT, "1/8"), (0.0625, DEFAULT, "1/8"),
    (float("nan"), DEFAULT, "1/8"), (float("inf"), QUANT, "1/8"),
    (4096.0, DEFAULT, "2\\^24"), (-40000.0, QUANT, "2\\^24"),
    (300.0, dict(rows_per_xbar=8192), "2\\^24"),
])
def test_crossbar_quantized_refuses_codes_the_kernel_cannot_take(
        bad, numerics, match):
    """Codes off the 1/8 grid or whose partials leave f32 exactness
    (rows_per_xbar * 8 * max|code| >= 2^24) are refused on the CPU as on
    the card, so both devices take the same inputs; any code within that
    bound takes enough int8 digits."""
    xq, wq = _noisy_codes(5, 40, 6, seed=2)
    wq[3, 4] = bad
    with pytest.raises(ValueError, match=match):
        pt_xbar.crossbar_matmul_quantized(
            *_t(xq, wq), pt_xbar.CrossbarNumerics(**numerics))


@pytest.mark.parametrize("numerics", [DEFAULT, QUANT])
@pytest.mark.parametrize("noisy", [False, True])
def test_crossbar_entry_points_agree_on_ragged_tiles(numerics, noisy):
    """At K = 1,100 (two full 512-row crossbar tiles and a ragged one, or
    18 tiles of 64 rows with a ragged last) the programmed-weights entry
    point, the conductance-code entry point and the plain version agree
    bit for bit; the code check picks two digits exactly for noisy
    codes."""
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    rng = np.random.default_rng(7)
    xq = torch.from_numpy(rng.integers(0, 256, (9, 1100)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(1100, 24)).astype(np.float32))
    nz = torch.from_numpy((np.round(rng.normal(size=(1100, 24)) * 0.05 *
                                    127 * 8) / 8).astype(np.float32))
    codes = pt_xbar.program_conductances(w, cfg, nz if noisy else None)
    assert xbar_ops.check_codes(codes.wq, cfg) == (2 if noisy else 1)
    plain = pt_xbar.crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
    assert torch.equal(pt_xbar.crossbar_matmul_quantized(xq, codes.wq, cfg),
                       plain)
    assert torch.equal(pt_xbar.crossbar_matmul_programmed(xq, codes, cfg),
                       plain)


def test_programming_helpers_keep_their_fused_layer_names():
    """The helpers that program weights live with the crossbar and are
    the same objects under their old ``fused_layer.ops`` names."""
    for name in ("Conductances", "program_conductances", "conductance_digits",
                 "digit_tiles", "tile_depth", "digit_count", "check_in_bits",
                 "check_noise_grid", "GRID", "DIGIT_BASE", "MAX_DIGITS"):
        assert getattr(fl_ops, name) is getattr(xbar_ops, name)


@pytest.mark.parametrize("numerics", [QUANT, DEFAULT])
@pytest.mark.parametrize("noisy", [False, True])
def test_crossbar_matmul_signed_matches_reference(numerics, noisy,
                                                  monkeypatch):
    """The kernel-backed signed product against the reference's Pallas
    ops path; on one device it equals the port's plain oracle exactly,
    and both sign passes share one programming of the weights."""
    real, programmed = xbar_ops.program_conductances, []

    def program(*args, **kwargs):
        programmed.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(xbar_ops, "program_conductances", program)
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
    assert len(programmed) == 1
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
        m2, c2 = search(*_t(ci, queries), backend=backend, bq=4, be=128)
        assert torch.equal(m2, match) and torch.equal(c2, counts)
    if q:
        assert int(counts[queries < 0].abs().sum()) == 0


def test_cam_search_contract_errors_and_scan():
    ci, queries = _t(np.arange(8, dtype=np.int32),
                     np.array([1, 2], np.int32))
    for bad in (dict(bq=0), dict(be=-128)):
        with pytest.raises(ValueError):
            search(ci, queries, backend="pallas", **bad)
    tuned = TunedKernels.of({CamGeometry(e=8, q=2).key():
                             CamConfig(bq=16, be=512)})
    for got, want in zip(search(ci, queries, backend="pallas", tuned=tuned),
                         search(ci, queries, backend="pallas")):
        assert torch.equal(got, want)
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
    from repro_torch.kernels.recurrence import rglru_scan, wkv6_scan
    a = torch.rand((2, 5, 8), requires_grad=True)
    rglru_scan(a, torch.rand((2, 5, 8))).sum().backward()
    r = torch.rand((2, 5, 3, 16), requires_grad=True)
    wkv6_scan(r, r, r, r, torch.rand((3, 16)),
              torch.zeros((2, 3, 16, 16)))[0].sum().backward()
    from repro_torch.kernels.attention import flash_attention
    qkv = torch.randn((1, 20, 2, 128)).bfloat16().requires_grad_()
    flash_attention(qkv, qkv, qkv).float().sum().backward()
    from repro_torch.kernels.optim import adamw_norm, adamw_update
    from repro_torch.optim import AdamWConfig
    leaf = lambda: [torch.rand(5)]
    scale, _ = adamw_norm(leaf(), 1.0)
    adamw_update(leaf(), leaf(), leaf(), leaf(), scale, torch.tensor(1e-3),
                 torch.tensor(0.1), torch.tensor(0.05), AdamWConfig())
    assert launch_counts() == {
        "fused_ideal_layer": 0, "fused_zmax": 0, "fused_quant_layer": 0,
        "csr_aggregate": 0, "crossbar_matmul_quantized": 0,
        "cam_search": 0, "rglru_scan": 0, "wkv6_scan": 0,
        "flash_attention_forward": 0, "flash_attention_backward": 0,
        "adamw_norm": 0, "adamw_update": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, nbr, wts, w, b = _case(8, 16, 4, 8, 2)
    xt, nt, wt, Wt, bt = _t(x, nbr, wts, w, b)
    with pytest.raises(TypeError):
        csr_aggregate(xt, nt.long(), wt)
    with pytest.raises(ValueError):
        csr_aggregate(xt.t(), nt, wt)
    with pytest.raises(ValueError):
        fused_gnn_layer(xt, nt, wt, Wt[:-1].contiguous(), bt)


# ---- the quant kernel's int8 tensor-core formulation, checked on the CPU


def _grid_codes(k, n, w_bits, noisy, seed):
    """Conductance codes as the serving path programs them: quantized
    weights, and with ``noisy`` a ReRAM-sized draw on the 1/8 grid, clipped
    to +-w_levels (``quant_operands`` with ``w_noise``)."""
    rng = np.random.default_rng(seed)
    cfg = pt_xbar.CrossbarNumerics(w_bits=w_bits)
    wq, _ = pt_xbar.quantize_weights(
        torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)), cfg)
    if noisy:
        nz = np.round(rng.normal(size=(k, n)) * 0.05 * cfg.w_levels * 8) / 8
        wq = pt_xbar.apply_conductance_noise(
            wq, torch.from_numpy(nz.astype(np.float32)), cfg)
    return wq.contiguous(), cfg


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("w_bits", list(range(2, 17)))
def test_conductance_digits_reconstruct_eight_times_the_code(w_bits, noisy):
    """Clean codes within +-127 are one int8 digit, the code; other codes
    are D digits of 8 * code in base 128, most significant first, the lower
    ones in [0, 127] and the top one in [-128, 127]: two up to w_bits 12,
    three up to 16 (and 19). The count comes from the configuration and
    the noise flag alone."""
    wq, cfg = _grid_codes(70, 12, w_bits, noisy, seed=w_bits)
    nd = fl_ops.digit_count(cfg, noisy)
    assert nd == (1 if not noisy and w_bits <= 8
                  else 2 if w_bits <= 12 else 3)
    digits = fl_ops.conductance_digits(wq, nd)
    assert digits.dtype == torch.int8
    assert digits.shape == (nd, 70, 12)
    d = digits.to(torch.int32)
    w8 = (wq * 8).to(torch.int32)
    if nd == 1:
        assert torch.equal(8 * d[0], w8)
        assert int(d.abs().max()) <= cfg.w_levels
        return
    assert int(d[1:].min()) >= 0 and int(d[1:].max()) <= 127
    value = torch.zeros_like(w8)
    for digit in d:
        value = fl_ops.DIGIT_BASE * value + digit
    assert torch.equal(value, w8)
    assert int(d[0].min()) >= -128 and int(d[0].max()) <= 127


def test_conductance_digits_refuse_what_the_kernel_cannot_hold():
    """Noise off the 1/8 grid is refused where the weights are
    programmed, on every device, so the plain version and the kernel take
    the same inputs; wide codes are programmed with more digits: above 127
    (w_bits 9 to 12) two, w_bits 11 as well, w_bits 16 three; only
    partials that leave f32 exactness are refused."""
    cfg = pt_xbar.CrossbarNumerics()
    w = torch.ones(2, 2)
    for bad in (0.3, 0.0625, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="1/8"):
            fl_ops.program_conductances(w, cfg, torch.tensor([[0.0, bad],
                                                              [0.5, 1.0]]))
    w11 = pt_xbar.CrossbarNumerics(w_bits=11)
    codes = fl_ops.program_conductances(w, w11)
    assert torch.equal(codes.wq, torch.full((2, 2), 1023.0))
    assert fl_ops.digit_count(w11, noisy=False) == 2
    assert fl_ops.digit_count(pt_xbar.CrossbarNumerics(w_bits=10), False) == 2
    assert fl_ops.digit_count(pt_xbar.CrossbarNumerics(
        w_bits=16, rows_per_xbar=64), False) == 3
    with pytest.raises(ValueError, match="2\\^24"):
        fl_ops.program_conductances(w, pt_xbar.CrossbarNumerics(w_bits=16))
    wq = torch.tensor([[1023.0, -1023.0], [200.0, -2047.0]])
    value = torch.zeros((2, 2), dtype=torch.int32)
    for digit in fl_ops.conductance_digits(wq, 2).to(torch.int32):
        value = 128 * value + digit
    assert torch.equal(value, (8 * wq).to(torch.int32))


def test_fused_layer_refuses_noise_off_the_grid_on_every_device():
    """``fused_gnn_layer(w_noise=...)`` takes draws on the 1/8 grid (what
    ``devices.sample_conductance_noise`` makes) and raises for any other
    perturbation, on the CPU as on the card; ``program_conductances`` on
    the CPU equals quantize-then-perturb and builds no digits."""
    x, nbr, wts, w, b = _t(*_case(10, 24, 6, 9, 3))
    on_grid = torch.full_like(w, 0.375)
    with pytest.raises(ValueError, match="1/8"):
        fused_gnn_layer(x, nbr, wts, w, b, pt_xbar.CrossbarNumerics(),
                        w_noise=on_grid + 0.01)
    fused_gnn_layer(x, nbr, wts, w, b, pt_xbar.CrossbarNumerics(),
                    w_noise=on_grid)
    cfg = pt_xbar.CrossbarNumerics()
    codes = fl_ops.program_conductances(w, cfg, on_grid)
    wq, w_scale = pt_xbar.quantize_weights(w, cfg)
    assert torch.equal(codes.wq, pt_xbar.apply_conductance_noise(
        wq, on_grid, cfg))
    assert torch.equal(codes.w_scale, w_scale)
    assert codes.digits is None and codes.kp == 0


@pytest.mark.parametrize("f,r", [(496, 512), (496, 64), (130, 50), (7, 4),
                                 (0, 64)])
def test_digit_tiles_put_each_crossbar_tile_at_a_multiple_of_32(f, r):
    """[D, H, Kp]: row k of the codes sits at depth (k // r) * rpad + k % r,
    rpad = r rounded up to 32; every other depth holds 0."""
    digits = torch.randint(-128, 128, (2, f, 5), dtype=torch.int8)
    layout, kp = fl_ops.digit_tiles(digits, r)
    rpad = -(-r // 32) * 32
    assert kp % 32 == 0 and layout.shape == (2, 5, kp)
    assert layout.is_contiguous()
    k = torch.arange(f)
    pos = k // r * rpad + k % r
    assert torch.equal(layout[:, :, pos], digits.transpose(1, 2))
    rest = torch.ones(kp, dtype=torch.bool)
    rest[pos] = False
    assert int(layout[:, :, rest].abs().sum()) == 0
    if f:
        assert kp == int(pos[-1]) // 32 * 32 + 32


def _int8_tile_partials(codes_t, digits_t, in_bits):
    """The kernel's integer formulation of one crossbar tile: DAC codes
    packed four to a 32-bit word, plane b as (word >> b) & 0x01010101,
    int32 products against each int8 digit, combined in base 128 (Horner's
    rule, most significant digit first), times 0.125 with two or more
    digits. Returns the f32 partials, [in_bits, M, N]."""
    m, kt = codes_t.shape
    packed = torch.zeros((m, -(-kt // 4) * 4), dtype=torch.uint8)
    packed[:, :kt] = codes_t.to(torch.uint8)
    words = packed.view(torch.int32)
    out = []
    for b in range(in_bits):
        plane = ((words >> b) & 0x01010101).view(torch.uint8)[:, :kt]
        acc = [plane.to(torch.int32) @ d.to(torch.int32) for d in digits_t]
        if len(acc) == 1:
            out.append(acc[0].to(torch.float32))
        else:
            val = torch.zeros_like(acc[0])
            for a in acc:
                val = fl_ops.DIGIT_BASE * val + a
            out.append(val.to(torch.float32) * 0.125)
    return torch.stack(out)


# the bit-accurate numerics whose codes the kernels split into passes of 8
# bit planes (in_bits > 8) or three digits (w_bits > 12)
IN12 = dict(in_bits=12)
IN16_64 = dict(in_bits=16, adc_bits=12, rows_per_xbar=64)
W12_64 = dict(w_bits=12, rows_per_xbar=64)
W16_64 = dict(w_bits=16, rows_per_xbar=64)
IN30 = dict(in_bits=30)


@pytest.mark.parametrize("numerics", [DEFAULT, QUANT])
@pytest.mark.parametrize("noisy", [False, True])
def test_int8_formulation_equals_the_f32_bit_plane_partials(numerics, noisy):
    """Every (tile, bit) partial of the integer formulation equals the f32
    product of the plain version bit for bit, and the ADC'd, shifted and
    tile-summed result equals ``crossbar_matmul_quantized_plain``; so does
    the kernels' chunked staging of the same digits, at any chunk depth."""
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    xq, wq = _noisy_codes(24, 600, 20, seed=5, noisy=noisy)
    xq, wq = _t(xq, wq)
    digits = fl_ops.conductance_digits(wq, fl_ops.digit_count(cfg, noisy))
    assert digits.shape[0] == (2 if noisy else 1)
    r = cfg.rows_per_xbar
    acc = torch.zeros((24, 20), dtype=torch.float32)
    for t0 in range(0, 600, r):
        parts = _int8_tile_partials(xq[:, t0:t0 + r],
                                    digits[:, t0:t0 + r], cfg.in_bits)
        tile = torch.zeros_like(acc)
        for b in range(cfg.in_bits):
            plane = ((xq[:, t0:t0 + r] >> b) & 1).float()
            assert torch.equal(parts[b], plane @ wq[t0:t0 + r])
            tile = tile + _adc(parts[b], cfg) * (2.0 ** b)
        acc = acc + tile
    plain = pt_xbar.crossbar_matmul_quantized_plain(xq, wq, cfg)
    assert torch.equal(acc, plain)
    layout, kp = fl_ops.digit_tiles(digits, r)
    for kc in (32, 96, 256, kp):
        assert torch.equal(_staged_crossbar(xq, layout, kp, cfg, kc), plain)


@pytest.mark.parametrize("numerics", [IN12, IN16_64, W12_64, W16_64, IN30])
@pytest.mark.parametrize("noisy", [False, True])
def test_wide_codes_formulation_equals_the_plain_version(numerics, noisy):
    """DAC codes wider than a byte, in passes of 8 bit planes with the
    tile's sum carried from pass to pass, and conductance codes of two or
    three digits, combined per k-step by Horner's rule: the kernels'
    staging, emulated at several chunk depths (a tile then spans chunks
    and is staged again for its second pass), equals
    ``crossbar_matmul_quantized_plain`` bit for bit."""
    cfg = pt_xbar.CrossbarNumerics(**numerics)
    rng = np.random.default_rng(11)
    xq = torch.from_numpy(rng.integers(0, 1 << cfg.in_bits,
                                       (20, 300)).astype(np.int32))
    wq, _ = _grid_codes(300, 12, cfg.w_bits, noisy, seed=cfg.w_bits)
    nd = xbar_ops.check_codes(wq, cfg)
    assert nd == fl_ops.digit_count(cfg, noisy) or not noisy
    layout, kp = fl_ops.digit_tiles(fl_ops.conductance_digits(wq, nd),
                                    cfg.rows_per_xbar)
    plain = pt_xbar.crossbar_matmul_quantized_plain(xq, wq, cfg)
    for kc in (32, 96, kp):
        assert torch.equal(_staged_crossbar(xq, layout, kp, cfg, kc), plain)


def _staged_crossbar(xq, layout, kp, cfg, kc):
    """The bit-accurate kernels' staging, emulated: DAC codes at the
    digits' tile-padded depth p (row (p // rpad) * r + p % rpad of K, or a
    pad), chunks of ``kc`` depth positions; the crossbar tiles in order,
    and per pass of 8 bit planes (byte g of the codes) the tile's int32
    bit-plane sums over the chunks it meets (one digit, two with an
    accumulator each, or more combined per k-step of 32 by Horner's rule),
    then the pass's ADC, shift and add into the tile's running sum, which
    is added to the output where the tile ends."""
    r, m, k = cfg.rows_per_xbar, *xq.shape
    rpad = -(-r // 32) * 32
    nd = layout.shape[0]
    p = torch.arange(kp)
    tile, off = p // rpad, p % rpad
    live = off < torch.clamp(k - tile * r, max=r)
    codes = torch.where(live, xq[:, torch.clamp(tile * r + off, max=k - 1)],
                        0)
    digits = layout.to(torch.int32)
    mvm = torch.zeros((m, layout.shape[1]), dtype=torch.float32)
    for tb in range(0, kp, rpad):
        te = min(tb + rpad, kp)
        tile_sum = torch.zeros_like(mvm)
        for g in range(-(-cfg.in_bits // 8)):
            acc = torch.zeros((8, min(nd, 2), m, layout.shape[1]),
                              dtype=torch.int32)
            q = tb
            while q < te:               # the chunks the tile meets
                end = min(te, (q // kc + 1) * kc)
                for ks in range(q, end, 32):
                    byte = (codes[:, ks:ks + 32] >> (8 * g)) & 0xff
                    for b in range(8):
                        plane = (byte >> b) & 1
                        prods = [plane @ digits[d, :, ks:ks + 32].T
                                 for d in range(nd)]
                        if nd <= 2:
                            for d in range(nd):
                                acc[b, d] += prods[d]
                        else:
                            c = torch.zeros_like(prods[0])
                            for prod in prods:
                                c = fl_ops.DIGIT_BASE * c + prod
                            acc[b, 0] += c
                q = end
            if nd == 1:
                part = acc[:, 0].float()
            elif nd == 2:
                part = (fl_ops.DIGIT_BASE * acc[:, 0] + acc[:, 1]).float() \
                    * 0.125
            else:
                part = acc[:, 0].float() * 0.125
            for b in range(8):
                if 8 * g + b < cfg.in_bits:
                    tile_sum = tile_sum + _adc(part[b], cfg) * (
                        2.0 ** (8 * g + b))
        mvm = mvm + tile_sum
    return mvm


@pytest.mark.parametrize("in_bits", [0, 31, 32])
def test_dac_codes_beyond_the_int32_codes_raise(in_bits):
    """in_bits runs from 1 to MAX_IN_BITS (30) on every device: above it
    the plain version's top DAC level, 2^in_bits - 1 rounded in float32,
    overflows its int32 codes."""
    assert xbar_ops.MAX_IN_BITS == 30
    cfg = pt_xbar.CrossbarNumerics(in_bits=in_bits)
    x, nbr, wts, w, b = _t(*_case(12, 32, 8, 12, 4))
    codes = fl_ops.program_conductances(w, cfg)
    scales = torch.tensor([0.1, 0.1, 0.01])
    xq = torch.zeros((4, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 codes"):
        fused_quant_layer(x, nbr, wts, codes, b, scales, cfg)
    with pytest.raises(ValueError, match="int32 codes"):
        pt_xbar.crossbar_matmul_quantized(xq, codes.wq, cfg)
    with pytest.raises(ValueError, match="int32 codes"):
        xbar_ops.crossbar_matmul_programmed(xq, codes, cfg)


def test_quant_layer_raises_where_partials_leave_f32_exactness():
    """rows_per_xbar * 8 * w_levels must stay below 2^24: the wrapper (and
    the fused backend through it) raises above, on any device."""
    x, nbr, wts, w, b = _t(*_case(12, 32, 8, 12, 4))
    scales = torch.tensor([0.1, 0.1, 0.01])
    fits = pt_xbar.CrossbarNumerics(rows_per_xbar=16513)    # 16,777,208
    assert fits.rows_per_xbar * 8 * fits.w_levels < 1 << 24
    fused_quant_layer(x, nbr, wts, fl_ops.program_conductances(w, fits), b,
                      scales, fits)
    codes = fl_ops.program_conductances(w, pt_xbar.CrossbarNumerics())
    for big in (pt_xbar.CrossbarNumerics(rows_per_xbar=16514),
                pt_xbar.CrossbarNumerics(rows_per_xbar=1 << 15),
                pt_xbar.CrossbarNumerics(w_bits=16, rows_per_xbar=512)):
        with pytest.raises(ValueError, match="2\\^24"):
            fused_quant_layer(x, nbr, wts, codes, b, scales, big)
        with pytest.raises(ValueError, match="2\\^24"):
            fused_gnn_layer(x, nbr, wts, w, b, big)


@pytest.mark.parametrize("f,r,depth", [(4768, 512, 4768), (4769, 512, 4800),
                                       (4700, 50, 6016), (3703, 48, 4960),
                                       (3703, 512, 3712), (1433, 64, 1440)])
def test_quant_layer_raises_above_its_shared_memory_depth(f, r, depth):
    """The quant layer takes any tile-padded depth: where its digits and a
    row tile's codes do not fit a block's shared memory, its kernel stages
    K in chunks. On every device it computes where the reference does, and
    agrees with it (citeseer's F = 3,703 at rows_per_xbar 48 has a depth
    of 4,960)."""
    assert fl_ops.tile_depth(f, r) == depth
    cfg = pt_xbar.CrossbarNumerics(rows_per_xbar=r)
    rng = np.random.default_rng(f)
    x = rng.normal(size=(6, f)).astype(np.float32)
    nbr = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    wts = np.full((3, 2), 0.5, np.float32)
    w = rng.normal(size=(f, 2)).astype(np.float32)
    b = np.zeros(2, np.float32)
    ref = jx_fused_layer(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wts),
                         jnp.asarray(w), jnp.asarray(b),
                         jx_xbar.CrossbarNumerics(rows_per_xbar=r), bf=32)
    codes, scales = fl_ops.quant_operands(
        fl_ops.fused_zmax_plain(*_t(x, nbr, wts)), torch.from_numpy(w), cfg)
    got = fused_quant_layer(*_t(x, nbr, wts), codes, torch.from_numpy(b),
                            scales, cfg)
    _close(got, ref)


# ---- the ideal kernel's 3xTF32 tensor-core formulation, checked on the CPU


def _tf32(v):
    """``cvt.rna.tf32.f32``: v rounded to 10 mantissa bits, ties away from
    zero (sign and magnitude: adding half an ulp to the magnitude bits)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_layer(z, w, b, *, relu, three, nsplit=8):
    """The ideal kernel's product, emulated: z and W split into TF32 hi
    and lo; per k8 step lo*hi, then hi*lo, then hi*hi into f32 sums (only
    hi*hi with ``three`` False: plain TF32); warp q of a unit takes every
    nsplit-th k8 step from q, and the partials are added in order of q;
    then + b and the activation."""
    zh, wh = _tf32(z), _tf32(w)
    zl, wl = _tf32(z - zh), _tf32(w - wh)
    parts = [torch.zeros((z.shape[0], w.shape[1])) for _ in range(nsplit)]
    for ks in range(-(-z.shape[1] // 8)):
        k = slice(8 * ks, 8 * ks + 8)
        acc = parts[ks % nsplit]
        if three:
            acc = acc + zl[:, k] @ wh[k]
            acc = acc + zh[:, k] @ wl[k]
        parts[ks % nsplit] = acc + zh[:, k] @ wh[k]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    out = out + b
    return torch.clamp_min(out, 0.0) if relu else out


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10
    v = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 1.5 * ulp, 3.0], dtype=torch.float32)
    assert _tf32(v).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0,
                                 1.0 + 2 * ulp, 3.0]


@pytest.mark.parametrize("f,h,relu", [(496, 64, True), (496, 64, False),
                                      (64, 16, True)])
def test_3xtf32_formulation_stays_within_the_ideal_tolerance(f, h, relu):
    """The ideal kernel's 3xTF32 product (mirrors ``tf32_mma.cuh`` and the
    split of K across a unit's warps in ``fused_layer.cu``, as
    ``test_int8_formulation_equals_the_f32_bit_plane_partials`` does for
    the quant kernel) stays within ``chip_smoke.py``'s rtol 1e-5, atol
    1e-5 * max|ref| of ``fused_ideal_layer_plain`` at collab-like
    magnitudes (layer 1: 496 -> 64, layer 2: 64 -> 16, 83 % of the slots
    padding); plain TF32 (hi * hi alone) does not at 496 -> 64."""
    rng = np.random.default_rng(f + h)
    n, nd, s = 600, 256, 8
    x = rng.normal(size=(n, f)).astype(np.float32)
    if f == 64:                     # layer 2 reads relu'd activations
        x = np.maximum(x, 0.0)
    nbr = rng.integers(0, n, size=(nd, s)).astype(np.int32)
    deg = rng.integers(0, 3, size=nd)
    live = np.arange(s)[None, :] < deg[:, None] + 1     # self + neighbours
    wts = np.where(live, 1.0 / (deg[:, None] + 1), 0.0).astype(np.float32)
    w = (rng.normal(size=(f, h)) * np.sqrt(2.0 / (f + h))).astype(np.float32)
    b = (0.1 * rng.normal(size=h)).astype(np.float32)
    x, nbr, wts, w, b = _t(x, nbr, wts, w, b)
    ref = fused_ideal_layer_plain(x, nbr, wts, w, b, relu=relu)
    z = fl_ops.csr_aggregate_ref(x, nbr, wts)
    tol = 1e-5 * float(ref.abs().max())

    def within(got):
        return bool(((got - ref).abs() <= tol + 1e-5 * ref.abs()).all())
    assert within(_tf32_layer(z, w, b, relu=relu, three=True))
    if f == 496:
        assert not within(_tf32_layer(z, w, b, relu=relu, three=False))
