"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).  [arXiv:2106.07447]

The frontend (mel + conv feature extractor) is stubbed as in the JAX
package: the inputs are precomputed frame embeddings (`AUDIO_FEAT_DIM`)
through a linear projection.  Encoder-only: no decode step.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, frontend="audio", tie_embeddings=False,
    source="arXiv:2106.07447 (HuBERT X-Large)",
)

SMOKE = CONFIG.replace(
    name="hubert-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, d_ff=512, vocab_size=31)
