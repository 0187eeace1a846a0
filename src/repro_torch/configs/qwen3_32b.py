"""qwen3-32b — dense GQA decoder with qk-norm.  [hf:Qwen/Qwen3-8B family]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25_600, vocab_size=151_936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B (scaled per assignment)",
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=257)
