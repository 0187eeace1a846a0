"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2.  [arXiv:2403.19887]

As in the JAX package, the Mamba positions run the Mamba-2/SSD mixer
(`models.ssm`) where Jamba has Mamba-1 blocks.  Period structure: 8
layers, attention at offset 4 (64 heads over 8 KV heads of 128), MoE on
every other layer (moe_period=2), dense SwiGLU MLPs between; every
Mamba block also has `ln2` and an MLP.  `period_structure` takes whole
periods, so the smallest stack is one period of 8 layers.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24_576, vocab_size=65_536,
    num_experts=16, num_shared_experts=0, top_k=2, moe_d_ff=24_576,
    attn_period=8, attn_offset=4, moe_period=2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=False,
    source="arXiv:2403.19887 / arXiv:2408.12570 (Jamba-1.5-Large)",
)

SMOKE = CONFIG.replace(
    name="jamba-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, num_experts=4, top_k=2, moe_d_ff=512,
    attn_period=2, attn_offset=1, moe_period=2,
    ssm_state=16, ssm_head_dim=64, ssm_chunk=16, vocab_size=257)
