"""Public wrappers of the flash-attention kernels (``csrc/flash_attention.cu``).

  * ``flash_attention(q, k, v, window=)``: causal GQA attention bound to
    autograd by a ``torch.autograd.Function``; bf16 in, bf16 out, float32
    scores and products inside (the kernel's header has the design).
  * ``flash_attention_forward`` / ``flash_attention_backward``: the two
    entry points, each with a ``launches`` counter (the backward launches
    two kernels, the dQ pass and the dK/dV pass). On a CPU tensor they run
    the plain version (``ref.py``); on a CUDA tensor they launch the kernel
    or raise.

``models.attention.chunked_attention`` decides which calls come here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_backward_ref, flash_attention_forward_ref

HEAD_DIM = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check(what: str, q, k, v, *more) -> None:
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError(f"{what}: want q [B, Sq, H, D], k, v [B, Sk, KV, "
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, d = q.shape
    if (d != HEAD_DIM or k.shape != v.shape or k.shape[0] != b
            or k.shape[-1] != d or h % k.shape[2] or not sq or
            not k.shape[1]):
        raise ValueError(f"{what}: takes q [B, Sq, H, {HEAD_DIM}], k and v "
                         f"[B, Sk, KV, {HEAD_DIM}] with H a multiple of "
                         f"KV, not {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v) + more:
        if t.device != q.device:
            raise ValueError(f"{what}: the tensors must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the tensors must be contiguous")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel reads 16-byte aligned rows")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: want bf16 q, k, v, got {t.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, not "
                         f"{q.device}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def flash_attention_forward(q, k, v, *, window: int = 0, keep: bool = True,
                            terms: int = 3) -> tuple:
    """(out bf16 [B, Sq, H, 128], O float32 [B, Sq, H, 128] or None,
    L float32 [B, Sq, H]): causal attention of q against k, v over a
    window of ``window`` positions (0: all before). ``keep``: write the
    float32 O the backward pass reads (else None). ``terms`` 1 rounds P to
    bf16 before P.V: the tests' control, not the program's numerics."""
    _check("flash_attention", q, k, v)
    if window < 0 or terms not in (1, 3):
        raise ValueError(f"flash_attention: window {window} < 0 or terms "
                         f"{terms} not 1 or 3")
    if q.device.type == "cpu":
        out, o32, lse = flash_attention_forward_ref(q, k, v, window=window,
                                                    terms=terms)
        return out, o32 if keep else None, lse
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
        if keep else None
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    fn = _build.c_function("flash_attention", "flash_attention_forward",
                           (_P,) * 6 + (_I,) * 6 + (_F, _I, _P))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _ptr(o32), lse.data_ptr(), b, sq, k.shape[1], h,
                    k.shape[2], window, d ** -0.5, terms, _stream(q)),
                 "flash_attention")
    flash_attention_forward.launches += 1
    return out, o32, lse


flash_attention_forward.launches = 0


def flash_attention_backward(q, k, v, o32, lse, dout, *, window: int = 0,
                             terms: int = 3, f32: bool = False) -> tuple:
    """(dq, dk, dv) in bf16 for the gradient ``dout`` (bf16) of
    ``flash_attention_forward``'s output, from its float32 O and L; with
    ``f32`` also (dq, dk, dv) in float32, the kernels' accumulators."""
    _check("flash_attention backward", q, k, v, o32, lse, dout)
    if dout.dtype != torch.bfloat16 or o32.dtype != torch.float32 \
            or lse.dtype != torch.float32 or dout.shape != q.shape \
            or o32.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention backward: want bf16 dout and "
                         "float32 O shaped as q, float32 L [B, Sq, H]")
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_backward_ref(q, k, v, o32, lse, dout,
                                                  window=window, terms=terms)
        grads = tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
        return grads + ((dq, dk, dv) if f32 else ())
    b, sq, h, d = q.shape
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    full = tuple(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                 for t in (q, k, v)) if f32 else (None, None, None)
    fn = _build.c_function("flash_attention", "flash_attention_backward",
                           (_P,) * 13 + (_I,) * 6 + (_F, _I, _P))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                    lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    *(_ptr(t) for t in full), b, sq, k.shape[1], h,
                    k.shape[2], window, d ** -0.5, terms, _stream(q)),
                 "flash_attention backward")
    flash_attention_backward.launches += 2
    return (dq, dk, dv) + (full if f32 else ())


flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window: int, keep: bool):
        out, o32, lse = flash_attention_forward(q, k, v, window=window,
                                                keep=keep)
        if keep:
            ctx.save_for_backward(q, k, v, o32, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o32, lse,
                                              dout.contiguous(),
                                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, window: int = 0) -> torch.Tensor:
    """Causal attention, bf16 q [B, Sq, H, 128] against k, v [B, Sk, KV,
    128] (query position i sees keys j <= i, and i - j < ``window`` when
    the window is not 0), with a gradient for each input. Returns
    [B, Sq, H, 128] bf16: the float32 result of ``chunked_attention``'s
    online softmax, rounded once."""
    keep = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, window, keep)
