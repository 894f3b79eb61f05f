"""Plain PyTorch version of the flash-attention kernels
(``csrc/flash_attention.cu``): the kernels' algorithm, tile by tile.

It runs on CPU tensors (the wrapper's CPU implementation, the tests) and,
on the card, only where ``chip_smoke.py`` holds the kernels against it and
times it; never on a CUDA tensor of the main path.

What it repeats of the kernels, in float32:

  * GQA packing: the G query heads of a KV head are the rows of one
    matrix, row r = position r // G, head r % G;
  * the forward's query tiles of ``FWD_ROWS`` packed rows against key
    tiles of ``FWD_KEYS`` (zero keys past the end), the online softmax
    (score times the float32 scale, ``NEG_INF`` masks, the running max
    and sum, the denominator clamped at 1e-30), L = m + log l;
  * the tiles that the causal or window mask hides wholly, skipped;
  * the products with a float32 operand (P.V, P^T.dO, dS.K, dS^T.Q) as the
    sum of three products of its bf16 terms (``split3``), or of one, the
    bf16-rounded operand, for ``terms=1`` (the tests' control);
  * the backward's D = rowsum(dO * O) from the float32 O, P recomputed as
    exp(s - L), the dQ pass over ``DQ_ROWS`` x ``DQ_KEYS`` tiles and the
    dK/dV pass over ``BWD_KEYS`` x ``BWD_ROWS`` tiles, dK and dV summed
    over the G heads of a KV head.

Sums are taken in other orders than the tensor cores take them, so the
kernels agree with this to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
FWD_ROWS, FWD_KEYS = 64, 64      # the kernels' kFwdRows, kFwdKeys
DQ_ROWS, DQ_KEYS = 64, 64        # kDqRows, kDqKeys
BWD_KEYS, BWD_ROWS = 64, 32      # kBwdKeys, kBwdRows


def split3(x: torch.Tensor) -> tuple:
    """float32 ``x`` as three bf16 tensors whose sum is ``x`` exactly
    (for |x| >= 2**-110; below that the bits lost are under 2**-133):
    hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b for a float32 ``a`` and a ``b`` of bf16 values (as float32):
    the sum of the products of ``a``'s three bf16 terms, or of its bf16
    rounding alone for ``terms=1``."""
    parts = split3(a) if terms == 3 else (a.to(torch.bfloat16),)
    out = parts[0].float() @ b
    for p in parts[1:]:
        out = out + p.float() @ b
    return out


def pack(x: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, KV, S * G, D], the G heads of a KV head as rows
    (row r: position r // G, head r % G)."""
    b, s, h, d = x.shape
    g = h // kv
    return x.reshape(b, s, kv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, kv, s * g, d)


def unpack(x: torch.Tensor, h: int) -> torch.Tensor:
    """The inverse of ``pack``: [B, KV, S * G, ...] -> [B, S, H, ...]."""
    b, kv, sg = x.shape[:3]
    g = h // kv
    rest = x.shape[3:]
    x = x.reshape(b, kv, sg // g, g, *rest).transpose(1, 2)
    return x.reshape(b, sg // g, h, *rest).contiguous()


def key_tiles(lo: int, hi: int, keys: int, sk: int, window: int) -> range:
    """The tiles of ``keys`` keys that query positions [lo, hi] see."""
    end = min(sk, hi + 1)
    begin = max(0, lo - window + 1) if window > 0 else 0
    if end <= begin:
        return range(0)
    return range(begin // keys, -(-end // keys))


def live(pos: torch.Tensor, key: torch.Tensor, sk: int,
         window: int) -> torch.Tensor:
    """[rows, keys] mask: the key exists, is not after the query's
    position and (with a window) lies within the window."""
    rel = pos[:, None] - key[None, :]
    ok = (key[None, :] < sk) & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    return ok


def _heads(k: torch.Tensor, tile: int) -> torch.Tensor:
    """[B, Sk, KV, D] -> [B, KV, Sk', D] float32, zero keys appended up to
    a whole number of ``tile`` keys, as the kernels' tiles read them."""
    k = k.permute(0, 2, 1, 3).float()
    pad = -k.shape[2] % tile
    return torch.nn.functional.pad(k, (0, 0, 0, pad)) if pad else k


def flash_attention_forward_ref(q, k, v, *, window: int = 0,
                                terms: int = 3) -> tuple:
    """(out bf16 [B, Sq, H, D], O float32 [B, Sq, H, D], L float32
    [B, Sq, H]) of causal attention, as the forward kernel computes them.
    q: [B, Sq, H, D], k, v: [B, Sk, KV, D], bf16."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    qp = pack(q, kv).float()
    kf, vf = _heads(k, FWD_KEYS), _heads(v, FWD_KEYS)
    rows = sq * g
    dev = dict(device=q.device)
    o = torch.zeros((b, kv, rows, d), **dev)
    lse = torch.zeros((b, kv, rows), **dev)
    for r0 in range(0, rows, FWD_ROWS):
        r1 = min(r0 + FWD_ROWS, rows)
        pos = torch.arange(r0, r1, **dev) // g
        qt = qp[:, :, r0:r1]
        m = torch.full((b, kv, r1 - r0), NEG_INF, **dev)
        l = torch.zeros((b, kv, r1 - r0), **dev)
        acc = torch.zeros((b, kv, r1 - r0, d), **dev)
        for t in key_tiles(r0 // g, (r1 - 1) // g, FWD_KEYS, sk, window):
            j = torch.arange(t * FWD_KEYS, (t + 1) * FWD_KEYS, **dev)
            s = (qt @ kf[:, :, j].transpose(-1, -2)) * scale
            s = torch.where(live(pos, j, sk, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + split_matmul(p, vf[:, :, j], terms)
            m = m_new
        den = torch.clamp_min(l, 1e-30)
        o[:, :, r0:r1] = acc / den[..., None]
        lse[:, :, r0:r1] = m + torch.log(den)
    o32 = unpack(o, h)
    return o32.to(torch.bfloat16), o32, unpack(lse, h)


def flash_attention_backward_ref(q, k, v, o32, lse, dout, *, window: int = 0,
                                 terms: int = 3) -> tuple:
    """(dq [B, Sq, H, D], dk, dv [B, Sk, KV, D]) in float32 for the
    gradient ``dout`` (bf16) of ``flash_attention_forward_ref``'s output,
    from its float32 O and L, as the two backward kernels compute them."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    rows = sq * g
    qp, op = pack(q, kv).float(), pack(dout, kv).float()
    lp = pack(lse[..., None], kv)[..., 0]
    dp_ = pack((dout.float() * o32).sum(-1)[..., None], kv)[..., 0]   # D
    kf, vf = _heads(k, BWD_KEYS), _heads(v, BWD_KEYS)
    dev = dict(device=q.device)

    def probs(r0, r1, j):
        """P and dS of packed rows [r0, r1) against keys j."""
        pos = torch.arange(r0, r1, **dev) // g
        s = (qp[:, :, r0:r1] @ kf[:, :, j].transpose(-1, -2)) * scale
        s = torch.where(live(pos, j, sk, window), s, NEG_INF)
        p = torch.exp(s - lp[:, :, r0:r1, None])
        dpv = op[:, :, r0:r1] @ vf[:, :, j].transpose(-1, -2)
        return p, p * (dpv - dp_[:, :, r0:r1, None]) * scale

    dq = torch.zeros((b, kv, rows, d), **dev)
    for r0 in range(0, rows, DQ_ROWS):
        r1 = min(r0 + DQ_ROWS, rows)
        for t in key_tiles(r0 // g, (r1 - 1) // g, DQ_KEYS, sk, window):
            j = torch.arange(t * DQ_KEYS, (t + 1) * DQ_KEYS, **dev)
            _, ds = probs(r0, r1, j)
            dq[:, :, r0:r1] += split_matmul(ds, kf[:, :, j], terms)

    dk = torch.zeros((b, kv, kf.shape[2], d), **dev)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, BWD_KEYS):
        j = torch.arange(k0, k0 + BWD_KEYS, **dev)
        k_last = min(k0 + BWD_KEYS, sk) - 1
        r_end = min(rows, (k_last + window) * g) if window > 0 else rows
        for u0 in range(k0 * g // BWD_ROWS * BWD_ROWS, r_end, BWD_ROWS):
            u1 = min(u0 + BWD_ROWS, rows)
            p, ds = probs(u0, u1, j)
            dv[:, :, j] += split_matmul(p.transpose(-1, -2),
                                        op[:, :, u0:u1], terms)
            dk[:, :, j] += split_matmul(ds.transpose(-1, -2),
                                        qp[:, :, u0:u1], terms)
    keys = (lambda x: x[:, :, :sk].permute(0, 2, 1, 3).contiguous())
    return unpack(dq, h), keys(dk), keys(dv)
