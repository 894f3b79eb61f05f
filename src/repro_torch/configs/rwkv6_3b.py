"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent
decay time-mix + channel-mix.

``CONFIG`` is the published model (RWKV-x060-World-3B-v2.1,
huggingface.co/BlinkDL/rwkv-6-world; RWKV-LM's ``RWKV_Tmix_x060`` /
``RWKV_CMix_x060``): 32 layers, d 2,560, 40 heads of 64, FFN 8,960,
vocabulary 65,536, the group norm's eps 1e-5 x ``head_size_divisor`` 8
squared, 3,099,855,360 parameters. ``SMOKE`` is the JAX package's
simplified block, not the published one: it is kept only for the smoke
parity tests, which hold the port to the JAX package.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, pattern=("rwkv",), rwkv_head_dim=64,
    rwkv_block="finch",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, pattern=("rwkv",), rwkv_head_dim=16, attn_chunk=8,
)
