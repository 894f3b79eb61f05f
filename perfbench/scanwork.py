"""The work the RWKV-6 scan needs, counted from a cell's shapes alone.

Copied here so that a change to the program cannot move it: the count of
the port's ``chip_smoke.py`` path K3 (the scans' bounds), for one
call of ``wkv6_scan`` over r, k, v, w [B, S, H, Dh], u [H, Dh] and a state
[B, H, Dh, Dh] (n = B S H Dh elements a tensor):

  forward   bytes: r, k, v, w, u and the state read once, y and the final
            state written once, float32: 4 (5 n + H Dh + 2 B H Dh^2).
            Operations, per state element a step r^T S (2) and w S + k v
            (3), per key element a step the bonus v sum(r u k) (5):
            5 n Dh + 5 n.
  backward  bytes: r, k, v, w, u, the state, dy and dS read, dr, dk, dv,
            dw, du and dS0 written: 4 (9 n + 2 H Dh + 3 B H Dh^2).
            Operations, per state element a step the recomputed state (3),
            S dy, G v, G^T k and rowsum(G S) (2 each), G's update (3); per
            key element a step the bonus terms (16): 14 n Dh + 16 n.

What a design saves between the two passes (the kernel's checkpoints) is
its own traffic and not counted. ``bound_s`` is the least time one call
forward and backward can take on the card: the bytes over 3.35 TB/s
against the operations over 67 TFLOP/s float32, the larger.
"""
from __future__ import annotations

from . import yardstick

# the program's spans that hold the scan's calls: the forward's, and the
# backward's intervals on the autograd thread
SPANS = ("model.wkv6", "model.wkv6.backward")


def wkv6_bytes(b: int, s: int, h: int, dh: int) -> dict:
    n = b * s * h * dh
    return {"forward": 4 * (5 * n + h * dh + 2 * b * h * dh * dh),
            "backward": 4 * (9 * n + 2 * h * dh + 3 * b * h * dh * dh)}


def wkv6_flops(b: int, s: int, h: int, dh: int) -> dict:
    n = b * s * h * dh
    return {"forward": 5.0 * n * dh + 5.0 * n,
            "backward": 14.0 * n * dh + 16.0 * n}


def bound_s(b: int, s: int, h: int, dh: int) -> float:
    """Seconds one call's forward and backward need at the least."""
    peak = yardstick.H100
    by_bytes = sum(wkv6_bytes(b, s, h, dh).values()) / peak["hbm_bps"]
    by_flops = sum(wkv6_flops(b, s, h, dh).values()) / peak["f32_flops"]
    return max(by_bytes, by_flops)


def step_bound_s(model: dict, traffic: dict) -> float:
    """Seconds the scans of one training step need at the least: one call
    a layer over the step's batch (each microbatch's share, summed)."""
    dh = model["rwkv_head_dim"]
    h = model["d_model"] // dh
    micro = traffic["batch"] // traffic["accum_steps"]
    return (model["n_layers"] * traffic["accum_steps"]
            * bound_s(micro, traffic["seq"], h, dh))

