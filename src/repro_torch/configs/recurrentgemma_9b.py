"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention, 2:1
(pattern rglru, rglru, local; MQA kv=1; window 2048)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
    n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    pattern=("rglru", "rglru", "local"), local_window=2048,
    rglru_width=4096, tie_embeddings=True, remat="full",
)

SMOKE = ModelConfig(
    name="rgemma-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    pattern=("rglru", "rglru", "local"), local_window=16, rglru_width=64,
    tie_embeddings=True, attn_chunk=8,
)
