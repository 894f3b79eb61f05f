"""Shared building blocks: norms, RoPE/M-RoPE, FFNs, init, sharding hooks.

The counterpart of ``repro.models.common`` on PyTorch tensors. Where the
reference lets ``jnp`` promote mixed dtypes (a bf16 weight times an f32
activation), the port casts explicitly: ``torch.matmul`` refuses mixed
dtypes. ``jax.nn.gelu`` is the tanh approximation, so ``gelu`` here passes
``approximate="tanh"``.

Initialisation draws from an ``InitKey``: a ``torch.Generator`` on the
parameters' device and the leading shape of a stacked parameter (the
repeated cycles' leading axis). Its bits differ from ``jax.random``'s;
weights carry across the packages through ``params_from_numpy``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import _tree
from .._device import resolve_device
from .config import ModelConfig

# ---------------------------------------------------------------- sharding
# Logical activation-sharding hooks. A launcher installs a {name: placement}
# map; inside the model activations are tagged by logical name. With no map
# installed (the tests, one card) this is a no-op, as in the reference.
_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(rules: dict):
    old = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = old


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    rules = getattr(_CTX, "rules", None)
    if rules and name in rules:
        raise NotImplementedError(
            f"activation sharding rule for {name!r}: sharded placements "
            f"come with the port of distributed/sharding.py (ROADMAP §1 "
            f"item 3)")
    return x


# ---------------------------------------------------------------- numerics
def dtype_of(name: str) -> torch.dtype:
    """``torch.dtype`` for a config's dtype name (``"bfloat16"``, ...)."""
    return getattr(torch, name)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to their common dtype,
    as ``jnp.einsum`` promotes them."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: exact products
    of the (bf16) operands, summed in float32."""
    return torch.einsum(eq, *(o.float() for o in ops))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------- init
@dataclasses.dataclass(frozen=True)
class InitKey:
    """Where parameters are drawn: ``gen`` on the parameters' device, and
    ``lead``, the leading shape every parameter drawn with it gets (the
    stacked cycles')."""
    gen: torch.Generator
    lead: tuple = ()

    @classmethod
    def from_seed(cls, seed: int, device="cuda") -> "InitKey":
        dev = resolve_device(device)
        return cls(torch.Generator(device=dev).manual_seed(int(seed)))

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def stacked(self, n: int) -> "InitKey":
        return dataclasses.replace(self, lead=self.lead + (n,))


def init_dense(key: InitKey, shape, scale: float | None = None,
               dtype="bfloat16") -> torch.Tensor:
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(key.lead + shape, generator=key.gen, device=key.device,
                    dtype=torch.float32) * s
    return w.to(dtype_of(dtype))


def init_full(key: InitKey, shape, value: float, dtype="float32"
              ) -> torch.Tensor:
    """A constant parameter (norm scales, decay bases) of ``key``'s lead."""
    return torch.full(key.lead + tuple(shape), value,
                      dtype=dtype_of(dtype), device=key.device)


# ---------------------------------------------------------------- RoPE
def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               sections: tuple = ()) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, Dh]; pos: [B, S] or [3, B, S]
    (M-RoPE). Rotates halves (``jnp.split``), not interleaved pairs.

    With ``sections`` (qwen2-vl M-RoPE), the Dh/2 frequency pairs are split
    into len(sections) groups, group g rotating by pos[g] (temporal/height/
    width axes). Text-only inputs pass identical pos per group.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)       # [Dh/2]
    if sections:
        if sum(sections) != dh // 2 or pos.dim() != 3:
            raise ValueError(f"M-RoPE needs sections summing to {dh // 2} "
                             f"and pos [3, B, S]: {sections}, "
                             f"{tuple(pos.shape)}")
        parts = []
        start = 0
        for g, sec in enumerate(sections):
            f = freqs[start:start + sec]
            parts.append(pos[g].float()[..., None] * f)
            start += sec
        angles = torch.cat(parts, dim=-1)                # [B, S, Dh/2]
    else:
        if pos.dim() == 3:
            pos = pos[0]
        angles = pos.float()[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]                # [B, S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- FFN
def init_ffn(key: InitKey, cfg: ModelConfig, d_ff: int | None = None
             ) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": init_dense(key, (d, 2 * f), dtype=cfg.dtype),
                "wo": init_dense(key, (f, d), dtype=cfg.dtype)}
    return {"wi": init_dense(key, (d, f), dtype=cfg.dtype),
            "wo": init_dense(key, (f, d), dtype=cfg.dtype)}


def swiglu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    gate, up = torch.chunk(h, 2, dim=-1)
    return F.silu(gate.float()).to(dtype) * up


def ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = einsum("...d,df->...f", x, params["wi"])
    if cfg.act == "swiglu":
        h = swiglu(h, x.dtype)
    else:
        h = gelu(h.float()).to(x.dtype)
    h = shard(h, "ffn_hidden")
    return einsum("...f,fd->...d", h, params["wo"])


# ---------------------------------------------------------------- embedding
def init_embed(key: InitKey, cfg: ModelConfig) -> dict:
    p = {"tok": init_dense(key, (cfg.vocab, cfg.d_model), scale=1.0,
                           dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(key, (cfg.d_model, cfg.vocab),
                               dtype=cfg.dtype)
    return p


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    # a gather whose gradient is index_add_; the gradient of tok[tokens]
    # is an accumulating index_put_, which CUDA runs one repeated index
    # after another
    tok = params["tok"]
    out = torch.index_select(tok, 0, tokens.reshape(-1))
    return shard(out.reshape(tuple(tokens.shape) + (tok.shape[-1],)),
                 "embed")


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["head"]
    logits = einsum("...d,dv->...v", x, w)
    return shard(logits, "logits")


# ---------------------------------------------------------------- weights
def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: its bits
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's tree from the reference's (parameters, caches or decode
    states as numpy arrays, or anything ``np.asarray`` takes): the same
    keys, lists and stacked leaves, each leaf's dtype kept."""
    dev = resolve_device(device)
    return _tree.tree_map(lambda a: _leaf_from_numpy(a, dev), tree)
