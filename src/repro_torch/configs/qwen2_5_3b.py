"""qwen2.5-3b — dense GQA decoder with QKV bias.  [hf:Qwen/Qwen2.5-0.5B family]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11_008, vocab_size=151_936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B (scaled per assignment)",
)

SMOKE = CONFIG.replace(
    name="qwen2.5-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=257)
