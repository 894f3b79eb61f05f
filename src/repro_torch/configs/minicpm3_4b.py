"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense, MLA attention."""
from ..models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=96,
    mla=MLAConfig(q_lora=768, kv_lora=256, rope_dim=32, nope_dim=64, v_dim=64),
    tie_embeddings=True, remat="full",
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    mla=MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16),
    tie_embeddings=True, attn_chunk=8,
)
