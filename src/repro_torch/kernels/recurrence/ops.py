"""Public wrappers of the two sequence-scan kernels (``csrc/rglru_scan.cu``,
``csrc/wkv6_scan.cu``), registered as PyTorch custom ops.

Each scan and its backward pass is a ``torch.library.custom_op``
(``repro_torch::rglru_scan``, ``repro_torch::rglru_scan_backward``,
``repro_torch::wkv6_scan``, ``repro_torch::wkv6_scan_backward``) with

  * a CPU implementation, the plain version (``ref.py``);
  * a CUDA implementation that launches the hand-written kernel, and
    raises for what the kernel does not take; there is no other fallback;
  * a fake implementation (shapes and dtypes), which the dry run's meta
    tensors run;
  * ``register_autograd``, whose backward is the backward op.

So ``analysis.opcount.OpCounter`` sees one op a launch: a scan is one op
a layer forward and one backward, whatever the sequence length.

``rglru_scan.launches`` and ``wkv6_scan.launches`` count the kernels'
launches, forward and backward passes both.

The kernels' designs (each ``.cu`` file's header has the detail):

  * ``rglru_scan`` is bound by bytes: a thread walks one channel through
    time (every h as the plain loop rounds it), a block is one warp of 32
    channels, and its inputs stream through a ring of 16-step tiles in
    shared memory that the Tensor Memory Accelerator fills 9 tiles (6 in
    the backward) ahead, so tens of KB are in flight on each SM even at
    one sequence. The copy engine wants W a multiple of 4: the wrapper
    pads other widths with zero channels and slices them off.
  * ``wkv6_scan`` is bound by the issue of instructions: each state stays
    in registers, split over 2 warps a 16-column slab (forward) or a
    16-row slab (backward: a thread block cluster a (b, h), the column
    sums of dv added across it through distributed shared memory), with
    inputs staged ``CHUNK`` steps at a time by the Tensor Memory
    Accelerator. The forward saves its state every ``CHUNK`` steps (only
    when a gradient will be taken: the wrapper asks for it when grad mode
    is on and an input requires a gradient); the backward walks the
    chunks in reverse and recomputes each one's states from its
    checkpoint, on chip: the states at every fourth step in shared
    memory, four at a time in registers. No scratch in device memory.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (rglru_scan_backward_ref, rglru_scan_ref,
                  wkv6_scan_backward_ref, wkv6_scan_ref)

CHUNK = 16          # steps between the RWKV forward's saved states
HEAD_DIMS = (16, 32, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _stream(t: torch.Tensor) -> int:
    # imported here: the GNN kernels' package imports the tuning registry,
    # which imports the models' analysis, which imports this module
    from ..csr_aggregate.ops import stream_ptr
    return stream_ptr(t)


def _check(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: want float32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: the tensors must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, not {dev}")


def _aligned(*ts: torch.Tensor) -> list:
    """The tensors, each at a 16-byte aligned address (a copy where not):
    the copy engine reads the scans' inputs in boxes."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _tileable(*ts: torch.Tensor) -> list:
    """RG-LRU arrays ([..., W]) as the copy engine reads them: W padded with
    zeros up to a multiple of 4 where it is not one (a padded channel has
    a = g = dy = 0, so its h and gradients stay 0), each base 16-byte
    aligned."""
    pad = -ts[0].shape[-1] % 4
    if pad:
        return [torch.nn.functional.pad(t, (0, pad)) for t in ts]
    return _aligned(*ts)


def _unpadded(t: torch.Tensor, w: int) -> torch.Tensor:
    return t if t.shape[-1] == w else t[..., :w].contiguous()


# ---------------------------------------------------------------- RG-LRU
@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(a: torch.Tensor, g: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    _check("rglru_scan", a, g, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, g, h0)
    if not a.numel():
        return torch.empty_like(a)
    b, s, w = a.shape
    a, g, h0 = _tileable(a, g, h0)
    h = torch.empty_like(a)
    fn = _build.c_function("rglru_scan", "rglru_scan_f32",
                           (_P, _P, _P, _P, _I, _I, _I, _P))
    _build.check(fn(a.data_ptr(), g.data_ptr(), h0.data_ptr(), h.data_ptr(),
                    b, s, a.shape[2], _stream(a)), "rglru_scan")
    rglru_scan.launches += 1
    return _unpadded(h, w)


@_rglru_scan.register_fake
def _(a, g, h0):
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::rglru_scan_backward", mutates_args=())
def _rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                         dy: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check("rglru_scan backward", a, h, h0, dy)
    if a.device.type == "cpu":
        return rglru_scan_backward_ref(a, h, h0, dy)
    if not a.numel():
        return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    b, s, w = a.shape
    a, h, h0, dy = _tileable(a, h, h0, dy)
    da, dg, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    fn = _build.c_function("rglru_scan", "rglru_scan_backward_f32",
                           (_P,) * 7 + (_I, _I, _I, _P))
    _build.check(fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dy.data_ptr(),
                    da.data_ptr(), dg.data_ptr(), dh0.data_ptr(), b, s,
                    a.shape[2], _stream(a)), "rglru_scan backward")
    rglru_scan.launches += 1
    return _unpadded(da, w), _unpadded(dg, w), _unpadded(dh0, w)


@_rglru_scan_backward.register_fake
def _(a, h, h0, dy):
    return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)


def _rglru_setup(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, h0, output)


def _rglru_backward(ctx, dy):
    a, h0, h = ctx.saved_tensors
    return torch.ops.repro_torch.rglru_scan_backward(a, h, h0,
                                                     dy.contiguous())


_rglru_scan.register_autograd(_rglru_backward, setup_context=_rglru_setup)


def rglru_scan(a: torch.Tensor, g: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """Every state of ``h_t = a_t * h_{t-1} + g_t`` from ``h0`` (zero by
    default, the full-sequence mode). a, g: [B, S, W] float32; h0: [B, W].
    Returns h: [B, S, W]. On the card it equals the plain loop bit for
    bit."""
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    return torch.ops.repro_torch.rglru_scan(a.contiguous(), g.contiguous(),
                                            h0.contiguous())


rglru_scan.launches = 0


# ---------------------------------------------------------------- RWKV-6
def _chunks(s: int, chunk: int) -> int:
    return -(-s // chunk) if chunk else 0


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6_scan: the kernel takes head dims "
                         f"{HEAD_DIMS}, not {d}")


def _wkv6_forward_args(r, k, v, w, u, s0, chunk: int) -> tuple:
    """The tensors the forward kernel is handed, in its argument order:
    r, k, v, w, u, S0, each at a 16-byte aligned base (a copy where not:
    the copy engine reads r, k, v, w in boxes, and ``load_n`` reads S0
    with float4 loads, so a state sliced out of a larger buffer would stop
    the launch), then the fresh y, final state and checkpoints."""
    b, s, h, d = r.shape
    return (*_aligned(r, k, v, w, u, s0), torch.empty_like(r),
            torch.empty_like(s0), r.new_empty((b, h, _chunks(s, chunk), d, d)))


def _wkv6_backward_args(r, k, v, w, u, ckpt, dy, ds) -> tuple:
    """The tensors the backward kernel is handed, in its argument order:
    r, k, v, w, u, the checkpoints, dy and dS, each at a 16-byte aligned
    base (``load_n`` reads the checkpoints and dS with float4 loads), then
    the fresh dr, dk, dv, dw, du's partial sums a batch row and dS0."""
    b, _, h, d = r.shape
    return (*_aligned(r, k, v, w, u, ckpt, dy, ds),
            *(torch.empty_like(r) for _ in range(4)), r.new_empty((b, h, d)),
            torch.empty_like(ds))


@torch.library.custom_op("repro_torch::wkv6_scan", mutates_args=())
def _wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               chunk: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check("wkv6_scan", r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, s0, chunk)
    b, s, h, d = r.shape
    _check_head_dim(d)
    if chunk not in (0, CHUNK):
        raise ValueError(f"wkv6_scan: the kernel saves its state every "
                         f"{CHUNK} steps or not at all, not every {chunk}")
    args = _wkv6_forward_args(r, k, v, w, u, s0, chunk)
    if r.numel():
        fn = _build.c_function("wkv6_scan", "wkv6_scan_f32",
                               (_P,) * 9 + (_I,) * 5 + (_P,))
        # an empty checkpoint tensor (chunk 0) goes as a null pointer
        _build.check(fn(*(t.data_ptr() or None for t in args), b, h, s, d,
                        chunk, _stream(r)), "wkv6_scan")
        wkv6_scan.launches += 1
    return args[6:]


@_wkv6_scan.register_fake
def _(r, k, v, w, u, s0, chunk):
    b, s, h, d = r.shape
    return (torch.empty_like(r), torch.empty_like(s0),
            r.new_empty((b, h, _chunks(s, chunk), d, d)))


@torch.library.custom_op("repro_torch::wkv6_scan_backward", mutates_args=())
def _wkv6_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                        dy: torch.Tensor, ds: torch.Tensor, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
    _check("wkv6_scan backward", r, k, v, w, u, ckpt, dy, ds)
    if chunk < 1 or ckpt.shape[2] != _chunks(r.shape[1], chunk):
        raise ValueError("wkv6_scan backward: the forward saved no states "
                         "(it ran without a gradient)")
    if r.device.type == "cpu":
        return wkv6_scan_backward_ref(r, k, v, w, u, ckpt[:, :, 0], dy, ds)
    b, s, h, d = r.shape
    _check_head_dim(d)
    if chunk != CHUNK:
        raise ValueError(f"wkv6_scan backward: the kernel reads states "
                         f"saved every {CHUNK} steps, not every {chunk}")
    if not r.numel():
        return (*(torch.empty_like(r) for _ in range(4)), torch.zeros_like(u),
                ds.clone())
    args = _wkv6_backward_args(r, k, v, w, u, ckpt, dy, ds)
    fn = _build.c_function("wkv6_scan", "wkv6_scan_backward_f32",
                           (_P,) * 14 + (_I,) * 5 + (_P,))
    _build.check(fn(*(t.data_ptr() for t in args), b, h, s, d, chunk,
                    _stream(r)), "wkv6_scan backward")
    wkv6_scan.launches += 1
    dr, dk, dv, dw, du_part, ds0 = args[8:]
    return dr, dk, dv, dw, du_part.sum(0), ds0


@_wkv6_scan_backward.register_fake
def _(r, k, v, w, u, ckpt, dy, ds, chunk):
    return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(r),
            torch.empty_like(r), torch.empty_like(u), torch.empty_like(ds))


def _wkv6_setup(ctx, inputs, output):
    r, k, v, w, u, s0, chunk = inputs
    ctx.save_for_backward(r, k, v, w, u, output[2])
    ctx.chunk = chunk
    ctx.s0_shape = s0.shape


def _wkv6_backward(ctx, dy, ds, _dckpt):
    r, k, v, w, u, ckpt = ctx.saved_tensors
    dy = torch.zeros_like(r) if dy is None else dy.contiguous()
    ds = (r.new_zeros(ctx.s0_shape) if ds is None else ds.contiguous())
    grads = torch.ops.repro_torch.wkv6_scan_backward(r, k, v, w, u, ckpt,
                                                     dy, ds, ctx.chunk)
    return (*grads, None)


_wkv6_scan.register_autograd(_wkv6_backward, setup_context=_wkv6_setup)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor) -> tuple:
    """The RWKV-6 recurrence from state ``s0``. r, k, v, w: [B, S, H, Dh]
    float32; u: [H, Dh]; s0: [B, H, Dh, Dh]. Returns (y [B, S, H, Dh], the
    final state [B, H, Dh, Dh]). On the card Dh is 16, 32 or 64; the final
    state equals the plain loop's bit for bit."""
    ts = tuple(t.contiguous() for t in (r, k, v, w, u, s0))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    y, s, _ = torch.ops.repro_torch.wkv6_scan(*ts, CHUNK if grad else 0)
    return y, s


wkv6_scan.launches = 0


def wkv6_residency(b: int, h: int, d: int) -> dict:
    """What the card makes of ``wkv6_scan``'s launches at B ``b``, H ``h``
    and Dh ``d``: blocks an SM (forward, backward) and the backward's
    clusters that run at once, against the blocks and clusters a launch
    has. Needs the card."""
    _check_head_dim(d)
    out = (ctypes.c_int * 3)()
    fn = _build.c_function("wkv6_scan", "wkv6_scan_residency",
                           (_I, _I, _I, _P))
    _build.check(fn(b, h, d, ctypes.addressof(out)), "wkv6_scan residency")
    slabs = d // 16
    return {"forward_blocks_per_sm": out[0], "backward_blocks_per_sm": out[1],
            "backward_clusters_at_once": out[2],
            "blocks": b * h * slabs, "clusters": b * h,
            "cluster_size": slabs}
