"""Plain PyTorch versions of the two sequence scans and their gradients.

They run on CPU tensors (the scans' CPU implementation, the tests) and, on
the card, only where ``chip_smoke.py`` holds the kernels against them;
never on a CUDA tensor of the main path.

  * ``rglru_scan_ref``: the RG-LRU recurrence ``h_t = a_t * h_{t-1} +
    g_t`` (``h_{-1} = h0``), one rounded multiply and one rounded add a
    step, as the kernel rounds.
  * ``wkv6_scan_ref``: the RWKV-6 recurrence
    ``y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` (``S_{-1} = S0``); the state
    update rounds as the kernel does.

The backward versions walk time in reverse with the formulas the kernels
use (``csrc/rglru_scan.cu``, ``csrc/wkv6_scan.cu``).
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, g: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """a, g: [B, S, W]; h0: [B, W]. Returns every h: [B, S, W]."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                            h0: torch.Tensor, dy: torch.Tensor) -> tuple:
    """(da, dg, dh0) of ``rglru_scan_ref``'s output ``h`` given its
    gradient ``dy``: dh_t = dy_t + a_{t+1} dh_{t+1}, da_t = dh_t h_{t-1},
    dg_t = dh_t, dh0 = a_0 dh_0."""
    s = a.shape[1]
    da = torch.empty_like(a)
    dg = torch.empty_like(a)
    carry = torch.zeros_like(h0)
    for t in range(s - 1, -1, -1):
        dh = dy[:, t] + carry
        da[:, t] = dh * (h[:, t - 1] if t > 0 else h0)
        dg[:, t] = dh
        carry = a[:, t] * dh
    return da, dg, carry


def wkv6_scan_ref(r, k, v, w, u, s0, chunk: int = 0) -> tuple:
    """r, k, v, w: [B, S, H, Dh]; u: [H, Dh]; s0: [B, H, Dh, Dh].
    Returns (y [B, S, H, Dh], the final state, the checkpoints): the
    state before every ``chunk``-th step, [B, H, ceil(S / chunk), Dh,
    Dh] (an empty [B, H, 0, Dh, Dh] with ``chunk`` 0)."""
    s = s0
    ys, saved = [], []
    for t in range(r.shape[1]):
        if chunk and t % chunk == 0:
            saved.append(s)
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               s + u[None, :, :, None] * kv))
        s = w_t[..., None] * s + kv
    b, _, h, d = r.shape
    ckpt = (torch.stack(saved, dim=2) if saved else
            s0.new_empty((b, h, 0, d, d)))
    return torch.stack(ys, dim=1), s, ckpt


def wkv6_scan_backward_ref(r, k, v, w, u, s0, dy, ds) -> tuple:
    """(dr, dk, dv, dw, du, ds0) of ``wkv6_scan_ref`` from S0 given the
    gradients of y (``dy``) and of the final state (``ds``), with G_t =
    dL/dS_t:
      dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
      dk_t = G_t v_t + u r_t (v_t . dy_t)
      dv_t = G_t^T k_t + dy_t sum(r_t u k_t)
      dw_t = rowsum(G_t S_{t-1})
      du   = sum over t and the batch of r_t k_t (v_t . dy_t)
      G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  dS0 = G_{-1}."""
    n = r.shape[1]
    states = [s0]
    for t in range(n - 1):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        states.append(w[:, t, ..., None] * states[-1] + kv)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    g = ds
    for t in range(n - 1, -1, -1):
        r_t, k_t, v_t, w_t, dy_t = r[:, t], k[:, t], v[:, t], w[:, t], \
            dy[:, t]
        prev = states[t]
        vd = (v_t * dy_t).sum(-1, keepdim=True)          # [B, H, 1]
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", prev, dy_t) \
            + u * k_t * vd
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", g, v_t) + u * r_t * vd
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", g, k_t) \
            + dy_t * (r_t * u * k_t).sum(-1, keepdim=True)
        dw[:, t] = (g * prev).sum(-1)
        du = du + (r_t * k_t * vd).sum(0)
        g = w_t[..., None] * g + r_t[..., :, None] * dy_t[..., None, :]
    return dr, dk, dv, dw, du, g
