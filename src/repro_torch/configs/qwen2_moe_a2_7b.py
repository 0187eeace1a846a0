"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151_936,
    num_experts=60, num_shared_experts=4, top_k=4, moe_d_ff=1408,
    qkv_bias=True, tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = CONFIG.replace(
    name="qwen2-moe-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, num_experts=4, num_shared_experts=1, top_k=2,
    moe_d_ff=128, vocab_size=257)
