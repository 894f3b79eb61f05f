"""Qwen2-VL-2B [arXiv:2409.12191]: GQA + M-RoPE text backbone; the vision
patch frontend is stubbed — ``input_specs()`` supplies 3-axis M-RoPE position
ids (temporal/height/width), identical per axis for pure text."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    mrope_sections=(16, 24, 24), tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    mrope_sections=(2, 3, 3), tie_embeddings=True, attn_chunk=8,
)
