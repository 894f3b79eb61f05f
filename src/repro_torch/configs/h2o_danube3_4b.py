"""H2O-Danube3-4B [arXiv:2401.16818]: llama+mistral mix, sliding-window attn."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
    n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
    window=4096,                       # mistral-style SWA
)

SMOKE = ModelConfig(
    name="danube3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, window=16, attn_chunk=8,
)
