"""The LM stack on meshes of four gloo CPU ranks.

Training on 2x2 (data, model): the cases of ``tests/test_torch_lm_mesh.py``
(smoke internlm2, grok-1 with expert-inner TP, deepseek-v3 with EP; 3
AdamW steps at f32 from the reference's parameters on its batches), held
to the port's unsharded run and to the reference's one-device
``train_step``. Decoding on 1x4: smoke internlm2's 2 KV heads and
deepseek-v3's latents do not divide a model axis of 4, so the caches are
split over their slots (``cache_shardings``) and each rank attends over
the slots it holds before the ranks' partial softmaxes are combined; 3
decode steps' logits against the unsharded ones at f32, within 1e-4 *
max|ref|."""
import numpy as np
import pytest

import _lm_mesh_ranks as ranks
from _lm_mesh_cases import reference_runs, spawn_ranks


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return reference_runs(tmp_path_factory.mktemp("lm_mesh4"))


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    return spawn_ranks(ranks.run_meshes, 4, tmp_path_factory, "mesh4",
                       cases["path"], [(2, 2)])[0]


@pytest.mark.parametrize("against", ["port", "ref"])
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_2x2_run_matches(cases, sharded, arch, against):
    losses, params = sharded[(arch, "2x2")]
    want_l, want_p = cases[arch][against]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5, atol=0)
    for g, r in zip(params, want_p):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    return spawn_ranks(ranks.run_decode, 4, tmp_path_factory, "decode",
                       (1, 4))[0]


@pytest.mark.parametrize("arch", ranks.DECODE_ARCHS)
def test_decode_on_slot_split_caches_matches_unsharded(decoded, arch):
    logits, placements = decoded[arch]
    assert any("Shard(dim=1)" in p for p in placements), placements
    for got, ref in zip(logits, ranks.plain_decode(arch)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
