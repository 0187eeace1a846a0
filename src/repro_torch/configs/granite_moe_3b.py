"""granite-moe-3b-a800m — 40 routed experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=0, vocab_size=49_155,
    num_experts=40, num_shared_experts=0, top_k=8, moe_d_ff=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled per assignment)",
)

SMOKE = CONFIG.replace(
    name="granite-moe-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, num_experts=4, top_k=2, moe_d_ff=128, vocab_size=257)
