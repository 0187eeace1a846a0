"""Presets of the port: the solve service's `DEFAULT` and `REDUCED`
(`serving`), as in `repro.configs.serving`, and the architecture registry
of the LLM paths (serving and training): `--arch <id>` resolves here, as
in `repro.configs`.

Registered: every arch of the JAX package's registry: the dense
decoders, the MoE decoders (qwen2-moe-a2.7b, granite-moe-3b-a800m),
mamba2-130m (the ssm family), hubert-xlarge (the audio family: an
encoder-only stack behind the stubbed frame projection of
`models.model`), internvl2-1b (the vlm family: a Qwen2 decoder behind the
stubbed patch projection) and jamba-1.5-large-398b (the hybrid family:
periods of Mamba-2 and attention blocks with dense and MoE MLPs), whose
layers are all ported (`models.layers`, `models.moe`, `models.ssm`,
`models.blocks`).  `LATER`, the archs not ported yet, is empty.
"""
from . import (deepseek_67b, granite_moe_3b, hubert_xlarge, internvl2_1b,
               jamba_1_5_large, mamba2_130m, qwen2_5_3b, qwen2_moe_a2_7b,
               qwen3_32b, tinyllama_1_1b)

ARCHS = {
    "qwen3-32b": qwen3_32b,
    "qwen2.5-3b": qwen2_5_3b,
    "deepseek-67b": deepseek_67b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "mamba2-130m": mamba2_130m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "hubert-xlarge": hubert_xlarge,
    "internvl2-1b": internvl2_1b,
    "jamba-1.5-large-398b": jamba_1_5_large,
}

# archs of the JAX package not ported yet -> what ports them: none left
LATER: dict = {}


def get_config(arch: str, smoke: bool = False):
    """The `ModelConfig` of `arch` (its smoke-test reduction with
    `smoke=True`).  Raises KeyError for an unknown arch."""
    mod = ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "LATER", "get_config"]
