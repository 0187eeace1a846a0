"""tinyllama-1.1b — llama2-arch small dense GQA decoder.  [arXiv:2401.02385]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32_000,
    rope_theta=1e4, tie_embeddings=False,
    source="arXiv:2401.02385 (TinyLlama 1.1B)",
)

SMOKE = CONFIG.replace(
    name="tinyllama-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=257)
