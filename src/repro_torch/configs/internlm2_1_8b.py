"""InternLM2-1.8B [arXiv:2403.17297]: dense GQA."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92544,
)

SMOKE = ModelConfig(
    name="internlm2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, attn_chunk=8,
)
