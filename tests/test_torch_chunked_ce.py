"""The LM loss's head and cross entropy (``transformer._chunked_ce``) on
the CPU: the gradients of a bf16 head carry no systematic scale.

The loss is a mean over n labelled positions, so the gold token's
gradient, -(1 - p) / n, is nearly one number at every position while p
is small (as at initialisation, where p is about 1 / vocab). Rounded
once to bf16 it is off by the same share at every position: bf16(1/2,044)
is 1/2,048, 0.2 % low, and bf16(1/510) is 1/512, 0.4 % low. Here n is
2,044 (4 rows of 512, each row's last label -1) or 510, the vocabulary is
small and the width 128, so a test is a fraction of a second.

The measure of a systematic scale is the least-squares slope of the
program's gradient on the float64 one, <got, ref> / <ref, ref> - 1: with
h in float32, as the loss hands it over, it reads under 2e-5 here (CPU,
torch 2.13); with h in bf16, where the gradient is rounded to bf16 at
once, -1.45e-3 at n = 2,044 and +7.8e-4 at n = 510. The limits: under a
twentieth of the single rounding's share for the float32 h, over an
eighth of it for the bf16 h (the test sees a bias where there is one).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer

D, V = 128, 2048


def _slope(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float((got * ref).sum() / (ref * ref).sum()) - 1.0


def _case(rows: int, seq: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              d_model=D, vocab=V, tie_embeddings=False)
    # h as the final norm hands it over: float32 values of rms 1
    h = torch.randn(rows, seq, D, generator=gen).bfloat16().float()
    head = (torch.randn(D, V, generator=gen) * D ** -0.5).bfloat16()
    labels = torch.randint(0, V, (rows, seq), generator=gen)
    labels[:, -1] = -1
    return cfg, h, head, labels


def _reference(h, head, labels):
    """(dh, dhead) of the mean cross entropy in float64."""
    h64 = h.double().requires_grad_()
    w64 = head.double().requires_grad_()
    logits = torch.einsum("bsd,dv->bsv", h64, w64).reshape(-1, V)
    loss = torch.nn.functional.cross_entropy(
        logits, labels.reshape(-1), ignore_index=-1)
    return torch.autograd.grad(loss, [h64, w64])


@pytest.mark.parametrize("rows,seq", [(4, 512), (2, 256)])
def test_hidden_state_gradient_carries_no_systematic_scale(rows, seq):
    cfg, h, head, labels = _case(rows, seq, 1)
    n = int((labels >= 0).sum())
    share = abs(n / 2.0 ** round(torch.log2(torch.tensor(float(n))).item())
                - 1.0)
    dh_ref, _ = _reference(h, head, labels)
    slopes = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = h.to(dtype).requires_grad_()
        (dh,) = torch.autograd.grad(transformer._chunked_ce(
            {"head": head}, x, labels, cfg), [x])
        assert dh.dtype == dtype
        slopes[dtype] = _slope(dh, dh_ref)
    assert abs(slopes[torch.float32]) < share / 20, slopes
    assert abs(slopes[torch.bfloat16]) > share / 8, slopes


def test_head_gradient_is_the_rounded_logits_gradients_product():
    """The head's gradient takes hi alone (a gold column seen once is a
    bf16 value over n whatever the rounding): within one bf16 step of
    the gradient of the logits' product with one cast of their gradient,
    as autograd gives it through ``einsum(...).float()`` (the products'
    float32 sums may be ordered otherwise, which moves the entries that
    cancel near 0 by more)."""
    cfg, h, head, labels = _case(4, 512, 2)
    w = head.clone().requires_grad_()
    (dw,) = torch.autograd.grad(transformer._chunked_ce(
        {"head": w}, h, labels, cfg), [w])
    w2 = head.clone().requires_grad_()
    logits = torch.einsum("bsd,dv->bsv", h.bfloat16(), w2).float()
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    loss = torch.sum((torch.logsumexp(logits, -1) - gold) * valid) \
        / valid.sum()
    (dw2,) = torch.autograd.grad(loss, [w2])
    assert dw.dtype == torch.bfloat16
    ref = dw2.float().abs()
    assert bool(((dw.float() - dw2.float()).abs()
                 <= 2.0 ** -7 * ref + 2.0 ** -16 * ref.max()).all())
