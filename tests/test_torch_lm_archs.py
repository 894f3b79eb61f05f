"""The port's ten architectures against the JAX package's at
``dtype="float32"``, at their smoke sizes, with the reference's weights
carried over (``params_from_numpy``): the loss within rtol 1e-5 and every
gradient leaf within atol 1e-4 * max|ref leaf|; three decode steps'
logits within 1e-4 * max|ref| (the reference's caches carried across
after the first); the port's prefill against the reference's within
1e-4 * max|ref|. The reference runs under ``jax.jit``, once per
architecture (a module fixture). The bf16 cases are in
``test_torch_lm_archs_bf16.py``.
"""
import numpy as np
import pytest
import jax
import torch

from _lm_cases import B, Case, decode_both, scale
from repro_torch import _tree
from repro_torch.configs import ARCHS


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return Case(request.param, "float32")


def test_loss_and_grads_f32(f32):
    (loss, aux), grads = _tree.value_and_grad(f32.tm.loss, f32.tp, f32.tb,
                                              has_aux=True)
    assert abs(float(loss) - float(f32.jloss)) <= 1e-5 * abs(
        float(f32.jloss)), (f32.arch, float(loss), float(f32.jloss))
    ref, jdef = jax.tree.flatten(f32.jgrads)
    got, tdef = _tree.flatten(grads)
    assert str(tdef) == str(jdef)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * scale(r), err_msg=f32.arch)


def test_decode_logits_f32(f32):
    for step, (got, ref) in enumerate(decode_both(f32)):
        assert got.shape == (B, 1, f32.tcfg.vocab)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale(ref),
                                   err_msg=f"{f32.arch} step {step}")


def test_prefill_matches_reference_f32(f32):
    """The port's prefill equals the reference's (1e-4 * max|ref|)."""
    if f32.jcfg.is_encdec:
        frames, jframes = f32.tb["frames"], f32.jb["frames"]
    else:
        frames = jframes = None
    mrope = f32.tb.get("mrope_pos")
    jl, _ = jax.jit(f32.jm.prefill)(f32.jp, f32.jb["tokens"], jframes,
                                    f32.jb.get("mrope_pos"))
    with torch.no_grad():
        tl, _ = f32.tm.prefill(f32.tp, f32.tb["tokens"], frames, mrope)
    ref = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                               atol=1e-4 * scale(ref), err_msg=f32.arch)
