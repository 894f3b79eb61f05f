"""Grok-1 314B [hf:xai-org/grok-1]: MoE, 8 experts top-2."""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768), remat="full",
)

SMOKE = ModelConfig(
    name="grok1-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64), attn_chunk=8,
)
