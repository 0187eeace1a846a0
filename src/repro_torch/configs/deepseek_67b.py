"""deepseek-67b — llama-arch dense GQA decoder.  [arXiv:2401.02954]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22_016, vocab_size=102_400,
    rope_theta=1e4, tie_embeddings=False,
    source="arXiv:2401.02954 (DeepSeek LLM 67B)",
)

SMOKE = CONFIG.replace(
    name="deepseek-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=257)
