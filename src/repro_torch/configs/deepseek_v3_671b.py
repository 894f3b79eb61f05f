"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA + 1 shared / 256 routed top-8
MoE (sigmoid router), 3 leading dense layers, MTP."""
from ..models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, d_ff=2048, vocab=129280,
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  router="sigmoid", n_dense_layers=3, d_ff_dense=18432),
    mtp=True, remat="full",
)

SMOKE = ModelConfig(
    name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    mla=MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
                  router="sigmoid", n_dense_layers=1, d_ff_dense=128),
    mtp=True, attn_chunk=8,
)
