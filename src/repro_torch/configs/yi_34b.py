"""Yi-34B [arXiv:2403.04652]: llama-arch dense GQA."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, remat="full",
)

SMOKE = ModelConfig(
    name="yi-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, attn_chunk=8,
)
