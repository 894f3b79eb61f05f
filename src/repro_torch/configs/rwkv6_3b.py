"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent
decay time-mix + channel-mix."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, pattern=("rwkv",), rwkv_head_dim=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, pattern=("rwkv",), rwkv_head_dim=16, attn_chunk=8,
)
