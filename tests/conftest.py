"""Shared fixtures: the canonical (setting, backend) parity grid, the
small-graph factory, and the centralized-oracle case — one definition for
the 3-backend x 3-setting loops that used to be copy-pasted across
test_semi_runtime.py, test_streaming.py, and test_kernels_fused_layer.py.

Also ensures the tests directory is importable (for the _hyp hypothesis
shim) regardless of pytest's import mode / invocation directory.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

# the canonical axes every parity grid draws from (keep in sync with
# repro.core.gnn.BACKENDS / repro.core.partition settings — asserted in
# test_semi_runtime.py)
SETTINGS = ("centralized", "decentralized", "semi")
BACKENDS = ("jnp", "pallas", "fused")
DISTRIBUTED_SETTINGS = ("decentralized", "semi")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-device subprocess test")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; run on the card with "
        "`python -m pytest -m card tests/test_torch_flash_attention.py`")


@pytest.fixture(params=BACKENDS)
def backend(request):
    """Every kernel backend (jnp oracle, composed pallas, fused)."""
    return request.param


@pytest.fixture(params=SETTINGS)
def setting(request):
    """Every execution setting (paper Fig. 4 + §5)."""
    return request.param


@pytest.fixture(params=DISTRIBUTED_SETTINGS)
def distributed_setting(request):
    """Settings with an exchange to measure (centralized has none)."""
    return request.param


@pytest.fixture(params=[(s, b) for s in SETTINGS for b in BACKENDS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def setting_backend(request):
    """The full 3-setting x 3-backend parity grid."""
    return request.param


@pytest.fixture
def make_graph():
    """Small-graph factory: a (by default gcn-normalized) random CSR graph
    with the skewed degree profile the runtime sees."""
    from repro.core.graph import random_graph

    def make(n=40, e=200, f=12, seed=1, normalize=True, weighted=True):
        g = random_graph(n, e, f, seed=seed, weighted=weighted)
        return g.gcn_normalize() if normalize else g
    return make


@pytest.fixture(scope="session")
def oracle_case():
    """Shared parity case: (graph, cfg, params, ref) where ``ref`` is the
    centralized full-graph embedding every setting/backend must match."""
    import jax
    from repro.core import gnn
    from repro.core.graph import random_graph
    from repro.core.partition import plan_execution
    g = random_graph(40, 200, 8, seed=0).gcn_normalize()
    cfg = gnn.GNNConfig(in_dim=8, hidden_dims=(16,), out_dim=4, sample=8)
    params = gnn.init_params(jax.random.key(0), cfg)
    cent = plan_execution(g, "centralized", sample=8)
    ref = cent.scatter(np.asarray(cent.make_forward(cfg)(params)))
    return g, cfg, params, ref
