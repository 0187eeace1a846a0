"""internvl2-1b — VLM: InternViT (stubbed) + Qwen2-arch LM backbone.  [arXiv:2404.16821]

The vision frontend is stubbed as in the JAX package: the inputs carry
precomputed patch embeddings (`VISION_EMB_DIM`, InternViT-300M's hidden
width), projected and put before the text sequence (256 patches an
image).  The embeddings are tied, so the head is `embed`'s transpose.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151_655,
    qkv_bias=True, frontend="vision", num_vision_tokens=256,
    tie_embeddings=True,
    source="arXiv:2404.16821 (InternVL2-1B, Qwen2-0.5B backbone)",
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=257, num_vision_tokens=8)
