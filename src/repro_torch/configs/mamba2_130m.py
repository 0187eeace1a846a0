"""mamba2-130m — SSD (state-space duality), attention-free.  [arXiv:2405.21060]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=24, num_kv_heads=24,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=512,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 130m)",
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, vocab_size=257, ssm_state=16, ssm_head_dim=64,
    ssm_chunk=16)
