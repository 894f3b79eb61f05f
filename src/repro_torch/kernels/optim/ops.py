"""Public wrappers of the AdamW kernels (``csrc/adamw.cu``).

  * ``adamw_norm(grads, max_norm, reduce=None)``: (the clipping scale, the
    global norm) of a list of gradient leaves, two 0-dim float32 tensors on
    their device: a launch of partial sums (one a ``MAX_LEAVES`` leaves)
    and one block over them. ``reduce``, where given, sums the partial sums
    in place over the ranks of a mesh between the two. Nothing is read back
    to the host.
  * ``adamw_update(params, grads, ms, vs, scale, lr, b1c, b2c, cfg)``:
    AdamW over lists of leaves, written over ``params``, ``ms`` and ``vs``:
    one launch for each (parameter dtype, gradient dtype) pair (and each
    ``MAX_LEAVES`` leaves of it).

Each has a ``launches`` counter. On CPU tensors they run the plain version
(``ref.py``), ``adamw_update`` copying its results over its inputs as the
kernel writes them. On meta tensors (a dry run's model of the card) they
allocate what the kernels allocate and compute nothing. On CUDA tensors they launch the kernels or raise. Both
take bf16 or float32 parameters and gradients, float32 moments, every
tensor on one device; the parameters and moments must be contiguous (they
are written in place), a gradient that is not is copied first.
``optim.adamw_update`` decides which calls come here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import adamw_leaf, scale_of, sum_squares

MAX_LEAVES = 48       # csrc/adamw.cu kMaxLeaves: leaves a launch
BLOCKS_PER_SM = 4     # both grids; the norm's fixes its order of summation
DTYPES = (torch.bfloat16, torch.float32)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _blocks(t: torch.Tensor) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        t.device).multi_processor_count


def _groups(n: int) -> int:
    return -(-n // MAX_LEAVES)


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _check_grads(what: str, grads: list) -> None:
    if not grads:
        raise ValueError(f"{what}: no leaves")
    dev = grads[0].device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: runs on CPU, CUDA or meta tensors, not "
                         f"{dev}")
    for g in grads:
        if g.device != dev:
            raise ValueError(f"{what}: the leaves must share a device")
        if g.dtype not in DTYPES:
            raise TypeError(f"{what}: want bf16 or float32 gradients, got "
                            f"{g.dtype}")


def adamw_norm(grads: list, max_norm: float, reduce=None) -> tuple:
    """(min(1, max_norm / max(gn, 1e-9)), gn) for gn the global L2 norm
    of ``grads``: 0-dim float32 tensors on the leaves' device.
    ``reduce(partials)``, where given, is called on the tensor of partial
    sums of squares before the norm is taken from it, to sum it in place
    over ranks that each hold a part of the gradients (an all-reduce):
    every rank hands in as many leaves, on the same kind of card."""
    _check_grads("adamw_norm", grads)
    if grads[0].is_meta:
        # what the kernels allocate (a partial sum a launch stands for its
        # grid's), and the reduction; nothing is computed
        partials = torch.empty(_groups(len(grads)), dtype=torch.float64,
                               device="meta")
        if reduce is not None:
            reduce(partials)
        out = torch.empty(2, dtype=torch.float32, device="meta")
        return out[1], out[0]
    if not grads[0].is_cuda:
        ss = sum_squares(grads)
        if reduce is not None:
            reduce(ss)
        return scale_of(ss, max_norm)
    gs = [g.contiguous() for g in grads]
    dev, blocks, stream = gs[0].device, _blocks(gs[0]), _stream(gs[0])
    partials = torch.empty(_groups(len(gs)) * blocks, dtype=torch.float64,
                           device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    sums = _build.c_function("adamw", "adamw_norm_sums",
                             (_I, _P, _P, _P, _I, _P, _P))
    _build.check(sums(len(gs), _array(_P, [g.data_ptr() for g in gs]),
                      _array(ctypes.c_longlong, [g.numel() for g in gs]),
                      _array(_I, [g.dtype == torch.float32 for g in gs]),
                      blocks, partials.data_ptr(), stream), "adamw_norm")
    if reduce is not None:
        reduce(partials)
    scale = _build.c_function("adamw", "adamw_norm_scale",
                              (_I, _P, _P, _F, _P))
    _build.check(scale(partials.numel(), partials.data_ptr(), out.data_ptr(),
                       float(max_norm), stream), "adamw_norm")
    adamw_norm.launches += _groups(len(gs)) + 1
    return out[1], out[0]


adamw_norm.launches = 0


def adamw_update(params: list, grads: list, ms: list, vs: list, scale, lr,
                 b1c, b2c, cfg) -> None:
    """One AdamW step over the leaves, in place: each parameter, its
    float32 moments ``ms``, ``vs`` and its gradient clipped by ``scale``,
    at learning rate ``lr`` with bias corrections ``b1c``, ``b2c`` (0-dim
    float32 tensors) and ``cfg``'s b1, b2, eps and weight_decay."""
    what = "adamw_update"
    _check_grads(what, grads)
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"{what}: {len(params)} parameters, {len(grads)} "
                         f"gradients, {len(ms)} and {len(vs)} moments")
    dev = grads[0].device
    for p, g, m, v in zip(params, grads, ms, vs):
        if any(t.device != dev for t in (p, m, v)):
            raise ValueError(f"{what}: the leaves must share a device")
        if p.dtype not in DTYPES or m.dtype != torch.float32 \
                or v.dtype != torch.float32:
            raise TypeError(f"{what}: want bf16 or float32 parameters and "
                            f"float32 moments, got {p.dtype}, {m.dtype}, "
                            f"{v.dtype}")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"{what}: a leaf's parameter, gradient and "
                             f"moments differ in shape: {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"{what}: the parameters and moments are "
                             f"written in place and must be contiguous")
    if grads[0].is_meta:
        return
    if not grads[0].is_cuda:
        for p, g, m, v in zip(params, grads, ms, vs):
            for t, new in zip((p, m, v), adamw_leaf(p, g, m, v, scale, lr,
                                                    b1c, b2c, cfg)):
                t.copy_(new)
        return
    numbers = [t.to(device=dev, dtype=torch.float32).reshape(())
               for t in (scale, lr, b1c, b2c)]
    pairs: dict = {}
    for i, (p, g) in enumerate(zip(params, grads)):
        pairs.setdefault((p.dtype, g.dtype), []).append(i)
    fn = _build.c_function("adamw", "adamw_update",
                           (_I, _I, _I) + (_P,) * 9 + (_F,) * 6 + (_I, _P))
    blocks, stream = _blocks(grads[0]), _stream(grads[0])
    for (p_dtype, g_dtype), idx in pairs.items():
        gs = [grads[i].contiguous() for i in idx]
        ptrs = [_array(_P, [ts[i].data_ptr() for i in idx])
                for ts in (params, ms, vs)]
        _build.check(fn(len(idx), p_dtype == torch.bfloat16,
                        g_dtype == torch.bfloat16, ptrs[0],
                        _array(_P, [g.data_ptr() for g in gs]), ptrs[1],
                        ptrs[2],
                        _array(ctypes.c_longlong, [g.numel() for g in gs]),
                        *(t.data_ptr() for t in numbers), cfg.b1,
                        1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                        cfg.weight_decay, blocks, stream), what)
        adamw_update.launches += sum(
            1 for lo in range(0, len(gs), MAX_LEAVES)
            if any(g.numel() for g in gs[lo:lo + MAX_LEAVES]))


adamw_update.launches = 0
