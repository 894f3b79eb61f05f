"""Unified model configuration for the 10 assigned architectures.

The counterpart of ``repro.models.config``, a copy: one frozen (hashable)
dataclass drives the whole zoo; every architecture is a point in this
config space (see ``repro_torch/configs/*.py``). ``param_count`` and
``active_param_count`` are the reference's arithmetic. ``scan_layers``
keeps the stacked layout of the repeated cycles' parameters (a leading
axis, looped over); ``remat="full"`` recomputes each cycle in the
backward pass.

One field is the port's own, defaulting to the JAX package's form:
``rwkv_block`` selects the RWKV block, ``"simplified"`` (the JAX
package's: one shared mixing LoRA, RMS block norms, a group norm without
bias, eps 1e-5) or ``"finch"`` (the published RWKV-6 block of RWKV-LM's
``RWKV_Tmix_x060`` / ``RWKV_CMix_x060``: five mixing LoRAs, a decay LoRA,
LayerNorm block norms with bias, a group norm with bias and eps 1e-5
times ``head_size_divisor`` 8 squared). ``param_count`` is exact for the
Finch block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


RWKV_BLOCKS = ("simplified", "finch")
# the Finch time mix's LoRA ranks, RWKV-LM x060's below a width of 4,096
FINCH_MIX_RANK = 32
FINCH_DECAY_RANK = 64


def finch_layer_params(d: int, d_ff: int) -> int:
    """Parameters of one Finch layer: the time mix (``maa_x``, ``maa`` of
    five, the mixing LoRA, ``decay`` and its LoRA, ``u``, r/k/v/g/o, the
    group norm's weight and bias), the channel mix (``maa_k``, ``maa_r``,
    k/v/r) and the two LayerNorms' weights and biases."""
    time_mix = (6 * d + 2 * d * 5 * FINCH_MIX_RANK + d
                + 2 * d * FINCH_DECAY_RANK + d + 5 * d * d + 2 * d)
    channel_mix = 2 * d + 2 * d * d_ff + d * d
    return time_mix + channel_mix + 4 * d


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared experts (deepseek-v3: 1)
    router: str = "softmax"        # 'softmax' (grok) | 'sigmoid' (deepseek)
    capacity_factor: float = 1.25
    n_dense_layers: int = 0        # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0            # their hidden size


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int                    # query low-rank dim (0 = full-rank q)
    kv_lora: int                   # KV latent dim (the cache-compressed dim)
    rope_dim: int                  # decoupled RoPE key dim per head
    nope_dim: int                  # non-positional q/k dim per head
    v_dim: int                     # value dim per head


@dataclasses.dataclass(frozen=True)
class EncoderConfig:               # whisper-style encoder (stub frontend)
    n_layers: int
    n_frames: int = 1500           # 30 s of audio at 50 Hz post-conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                       # 0 => d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)    # mixer cycle: attn|local|rglru|rwkv
    window: int = 0                         # SWA window for 'attn' (0 = full)
    local_window: int = 2048                # window for 'local' entries
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mrope_sections: Tuple[int, ...] = ()    # qwen2-vl M-RoPE (t, h, w) pairs
    encoder: Optional[EncoderConfig] = None  # whisper
    act: str = "swiglu"                     # 'swiglu' | 'gelu'
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "none"                     # 'none' | 'full'
    attn_chunk: int = 1024                  # chunked-attention block size
    rwkv_head_dim: int = 64
    rwkv_block: str = "simplified"          # 'simplified' | 'finch'
    rglru_width: int = 0                    # 0 => d_model
    mtp: bool = False                       # deepseek multi-token prediction
    scan_layers: bool = True                # stacked cycles, looped over

    def __post_init__(self):
        if self.rwkv_block not in RWKV_BLOCKS:
            raise ValueError(f"rwkv_block {self.rwkv_block!r} is none of "
                             f"{RWKV_BLOCKS}")
        if self.rwkv_block == "finch" and (
                set(self.pattern) != {"rwkv"} or self.moe is not None
                or self.encoder is not None):
            raise ValueError("the Finch block makes a stack of RWKV layers "
                             "alone: pattern ('rwkv',), no MoE, no encoder")

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> Tuple[str, ...]:
        """Remainder layers when n_layers % len(pattern) != 0."""
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS / roofline)."""
        d, v = self.d_model, self.vocab
        n = v * d * (1 if self.tie_embeddings else 2)   # embed (+ head)
        if self.rwkv_block == "finch":
            # the layers' leaves, each counted, and the final norm
            return n + d + self.n_layers * finch_layer_params(d, self.d_ff)
        per_layer = {}
        dh = self.dh
        # mixers
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora or d
            attn = (d * m.q_lora if m.q_lora else 0) \
                + q_in * self.n_heads * (m.nope_dim + m.rope_dim) \
                + d * (m.kv_lora + m.rope_dim) \
                + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim) \
                + self.n_heads * m.v_dim * d
        else:
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
        per_layer["attn"] = per_layer["local"] = attn
        w = self.rglru_width or d
        per_layer["rglru"] = d * 2 * w + 4 * w + 2 * w * w + w * d + 2 * w
        per_layer["rwkv"] = 6 * d * d + d * 64 * 2   # r,k,v,g,o,w-lora approx
        # ffn
        ffn_dense = d * self.d_ff * (3 if self.act == "swiglu" else 2)
        counts = {}
        for i in range(self.n_layers):
            kind = self.pattern[i % len(self.pattern)]
            counts[kind] = counts.get(kind, 0) + 1
            if self.moe is not None and kind in ("attn", "local", "rwkv", "rglru"):
                pass
        n += sum(per_layer[k] * c for k, c in counts.items())
        if self.moe is None:
            n += self.n_layers * ffn_dense
        else:
            mo = self.moe
            e_ffn = d * mo.d_ff_expert * 3
            moe_layers = self.n_layers - mo.n_dense_layers
            n += mo.n_dense_layers * d * (mo.d_ff_dense or self.d_ff) * 3
            n += moe_layers * (mo.n_experts + mo.n_shared) * e_ffn
            n += moe_layers * d * mo.n_experts            # router
        if self.encoder is not None:
            n += self.encoder.n_layers * (attn + ffn_dense)
            n += self.n_layers * attn                      # cross-attn
        n += 2 * d * self.n_layers                         # norms (approx)
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k) for MODEL_FLOPS."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        mo = self.moe
        full = self.param_count()
        moe_layers = self.n_layers - mo.n_dense_layers
        e_ffn = d * mo.d_ff_expert * 3
        inactive = moe_layers * (mo.n_experts - mo.top_k) * e_ffn
        return full - inactive
