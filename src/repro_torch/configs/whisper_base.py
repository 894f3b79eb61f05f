"""Whisper-base [arXiv:2212.04356]: encoder-decoder, conv frontend stubbed —
``input_specs()`` supplies precomputed frame embeddings [B, 1500, d_model]."""
from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, act="gelu",
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
)

SMOKE = ModelConfig(
    name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, act="gelu",
    encoder=EncoderConfig(n_layers=2, n_frames=16), attn_chunk=8,
)
