"""The port's ten architectures at the configs' own bf16 against the JAX
package's, the prefill/decode consistency, and the full configs' sizes.

A bf16 weight set drawn by the reference carries across
(``params_from_numpy``, each leaf's dtype kept): the loss and three
decode steps' logits within 0.05 * max|ref|. The port's prefill against
its own teacher-forced decode chain on the reference's consistency cases
(rtol and atol 0.15). The full configs' ``param_count`` and
``active_param_count`` equal the reference's (rwkv6-3b's in the JAX
package's form: its full config is the published Finch block).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _lm_cases import PORT_FIELDS, Case, decode_both, jax_form, scale
from repro.configs import ARCHS as JX_ARCHS
from repro.configs import get_config as jx_get_config
from repro_torch import _tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build


@pytest.fixture(scope="module", params=ARCHS)
def bf16(request):
    return Case(request.param, "bfloat16")


# the reference's consistency cases (tests/test_archs_smoke.py): the MoE
# archs drop other tokens at a prefill's capacity than at a decode step's
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b",
                                  "recurrentgemma-9b", "h2o-danube-3-4b",
                                  "minicpm3-4b", "qwen2-vl-2b"])
def test_prefill_decode_consistency(arch):
    """Greedy continuation from the port's prefill == its teacher-forced
    decode chain, at the configs' own dtype and the reference's tolerance
    (rtol, atol 0.15)."""
    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    params = model.init(3, device="cpu")
    b, s = 1, 8
    toks = torch.randint(0, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(4))
    mrope = (torch.arange(s)[None, None].expand(3, b, s)
             if cfg.mrope_sections else None)
    with torch.no_grad():
        last, _ = model.prefill(params, toks, mrope_pos=mrope)
        caches = model.init_caches(b, s + 2, device="cpu")
        for i in range(s):
            logits, caches = model.decode_step(params, toks[:, i:i + 1],
                                               caches, i)
    np.testing.assert_allclose(logits.float().numpy(),
                               last.float().numpy(), rtol=0.15, atol=0.15)


def test_loss_and_decode_bf16(bf16):
    """The configs' own bf16: the weights carried across keep their dtype;
    the loss and the decode logits within 0.05 * max|ref|."""
    for leaf in _tree.leaves(bf16.tp):
        assert leaf.dtype in (torch.bfloat16, torch.float32)
    assert any(leaf.dtype == torch.bfloat16 for leaf in _tree.leaves(bf16.tp))
    with torch.no_grad():
        loss, _ = bf16.tm.loss(bf16.tp, bf16.tb)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(bf16.jloss)) <= 0.05 * abs(
        float(bf16.jloss)), bf16.arch
    for step, (got, ref) in enumerate(decode_both(bf16)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=0.05 * scale(ref),
                                   err_msg=f"{bf16.arch} step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_equal_reference(arch):
    """Every config is the reference's in the reference's fields, and
    counts its parameters alike in the JAX package's form. The port's own
    fields (``PORT_FIELDS``) keep their defaults but in rwkv6-3b's full
    config, the published Finch block."""
    assert ARCHS == JX_ARCHS
    got, ref = jax_form(get_config(arch)), jx_get_config(arch)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    shared = lambda c: {k: v for k, v in dataclasses.asdict(c).items()
                        if k not in PORT_FIELDS}
    assert shared(got) == dataclasses.asdict(ref)
    assert shared(get_config(arch)) == dataclasses.asdict(ref)
    assert shared(get_config(arch, smoke=True)) == \
        dataclasses.asdict(jx_get_config(arch, smoke=True))
    assert jax_form(get_config(arch, smoke=True)) == \
        get_config(arch, smoke=True)
    assert (jax_form(get_config(arch)) == get_config(arch)) == \
        (arch != "rwkv6-3b")
