"""The port's CAM-built k-NN graphs against the JAX package.

Same features, made with numpy from a seed, go through ``repro.neighbors``
(the CAM search's Pallas kernel in interpret mode on the CPU) and through
``repro_torch.neighbors`` on the CPU, where the CAM wrapper runs its plain
version. Everything here is integer or built from integers, so every
comparison is exact: signatures, tags, band counts on both modes, the
top-k selection, and the CSR triple (indptr, indices, weights) of the
graphs.
"""
import numpy as np
import pytest

from repro import neighbors as jx
from repro_torch import neighbors as pt


def _feats(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)) \
        .astype(np.float32)


def _same_graph(got, ref):
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.edge_weight, ref.edge_weight)
    np.testing.assert_array_equal(got.features, ref.features)
    assert got.indices.dtype == ref.indices.dtype == np.int32
    assert got.edge_weight.dtype == np.float32


@pytest.mark.parametrize("n,f,bands,bits,seed", [
    (40, 16, 4, 6, 7), (17, 8, 5, 7, 0), (64, 32, 8, 8, 3)])
def test_signatures_and_tags_match_reference(n, f, bands, bits, seed):
    x = _feats(n, f, seed=seed)
    ref = jx.lsh_signatures(x, n_bands=bands, band_bits=bits, seed=seed)
    got = pt.lsh_signatures(x, n_bands=bands, band_bits=bits, seed=seed)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(pt.tag_bands(got, bits),
                                  jx.tag_bands(ref, bits))


@pytest.mark.parametrize("n,q,f", [(17, 17, 8), (64, 23, 24), (30, 5, 16)])
def test_band_match_counts_match_reference_on_both_modes(n, q, f):
    x = _feats(n, f, seed=3)
    sig_e = pt.lsh_signatures(x, n_bands=5, band_bits=7)
    sig_q = pt.lsh_signatures(_feats(q, f, seed=4), n_bands=5, band_bits=7)
    ref = jx.band_match_counts(sig_e, sig_q, mode="cam", backend="pallas",
                               band_bits=7, interpret=True)
    for mode, backend in (("topk", "jnp"), ("cam", "jnp"),
                          ("cam", "pallas")):
        got = pt.band_match_counts(sig_e, sig_q, mode=mode, backend=backend,
                                   band_bits=7, device="cpu")
        np.testing.assert_array_equal(got.numpy(), ref)


def test_band_match_counts_chunk_the_bitmap(monkeypatch):
    """Queries are chunked so one launch's bitmap stays in the budget; the
    chunked counts equal the one-shot ones."""
    from repro_torch.neighbors import knn
    x = _feats(50, 12, seed=5)
    sig = pt.lsh_signatures(x, n_bands=4, band_bits=6)
    whole = pt.band_match_counts(sig, sig, mode="cam", band_bits=6,
                                 device="cpu")
    monkeypatch.setattr(knn, "_BITMAP_BUDGET", 50 * 16 * 3)   # 3 queries
    calls = []
    real = knn.cam_search
    monkeypatch.setattr(knn, "cam_search",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    chunked = pt.band_match_counts(sig, sig, mode="cam", backend="pallas",
                                   band_bits=6, device="cpu")
    assert len(calls) == 17                       # ceil(50 / 3)
    assert (chunked == whole).all()


@pytest.mark.parametrize("exclude_self", [False, True])
def test_select_topk_matches_reference(exclude_self):
    """Many ties: the collision-free key orders by (score desc, id asc)."""
    counts = np.random.default_rng(9).integers(0, 4, size=(30, 30)) \
        .astype(np.int32)
    for k in (1, 5, 29):
        ref = jx.select_topk(counts, k, exclude_self=exclude_self)
        got = pt.select_topk(counts, k, exclude_self=exclude_self)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)
            assert g.dtype.itemsize == 4


def test_select_topk_validation():
    counts = np.zeros((4, 6), np.int32)
    with pytest.raises(ValueError, match="out of range"):
        pt.select_topk(counts, 7)
    with pytest.raises(ValueError, match="square"):
        pt.select_topk(counts, 2, exclude_self=True)


@pytest.mark.parametrize("n,f,k,min_bands", [(48, 16, 4, 1), (33, 8, 8, 3)])
def test_knn_graph_matches_reference_on_every_path(n, f, k, min_bands):
    x = _feats(n, f, seed=n)
    ref = jx.knn_graph(x, k=k, n_bands=6, band_bits=5, seed=2, mode="cam",
                       backend="pallas", min_bands=min_bands, interpret=True)
    for mode, backend in (("topk", "jnp"), ("cam", "jnp"),
                          ("cam", "pallas")):
        got = pt.knn_graph(x, k=k, n_bands=6, band_bits=5, seed=2,
                           mode=mode, backend=backend, min_bands=min_bands,
                           device="cpu")
        _same_graph(got, ref)


@pytest.mark.parametrize("name", ["recsys", "anomaly"])
def test_scenario_graph_matches_reference(name):
    fx, lx = jx.scenario_features(name, n_nodes=96, seed=1)
    fp, lp = pt.scenario_features(name, n_nodes=96, seed=1)
    np.testing.assert_array_equal(fp, fx)
    np.testing.assert_array_equal(lp, lx)
    ref = jx.scenario_graph(name, n_nodes=96, k=6, seed=1,
                            neighbor_mode="cam", backend="pallas",
                            interpret=True)
    got = pt.scenario_graph(name, n_nodes=96, k=6, seed=1,
                            neighbor_mode="cam", backend="pallas",
                            device="cpu")
    _same_graph(got, ref)
    ng, nr = got.gcn_normalize(), ref.gcn_normalize()
    np.testing.assert_array_equal(ng.edge_weight, nr.edge_weight)
    np.testing.assert_array_equal(ng.self_loop, nr.self_loop)


def test_neighbor_contract_errors():
    sig = pt.lsh_signatures(_feats(8, 4), n_bands=2, band_bits=4)
    with pytest.raises(ValueError, match="neighbor mode"):
        pt.band_match_counts(sig, sig, mode="lsh", device="cpu")
    with pytest.raises(ValueError, match="band mismatch"):
        pt.band_match_counts(sig, sig[:, :1], device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        pt.scenario_features("taxi")
    assert pt.NEIGHBOR_MODES == jx.NEIGHBOR_MODES
    assert pt.SCENARIOS == jx.SCENARIOS
