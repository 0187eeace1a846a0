"""Presets of the port: the solve service's `DEFAULT` and `REDUCED`
(`serving`), as in `repro.configs.serving`, and the architecture registry
of the LLM paths (serving and training): `--arch <id>` resolves here, as
in `repro.configs`.

Registered: the dense decoders, the MoE decoders (qwen2-moe-a2.7b,
granite-moe-3b-a800m), mamba2-130m (the ssm family), hubert-xlarge (the
audio family: an encoder-only stack behind the stubbed frame projection
of `models.model`) and internvl2-1b (the vlm family: a Qwen2 decoder
behind the stubbed patch projection), whose layers are all ported
(`models.layers`, `models.moe`, `models.ssm`, `models.blocks`).  The
hybrid, jamba-1.5-large-398b, raises `NotImplementedError` naming the
ROADMAP item that ports it.
"""
from . import (deepseek_67b, granite_moe_3b, hubert_xlarge, internvl2_1b,
               mamba2_130m, qwen2_5_3b, qwen2_moe_a2_7b, qwen3_32b,
               tinyllama_1_1b)

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
}

# archs of the JAX package not ported yet -> what ports them
LATER = {
    "jamba-1.5-large-398b": "the hybrid family (SSM + MoE layers), "
                            "ROADMAP.md queue A item 10",
}


def get_config(arch: str, smoke: bool = False):
    """The `ModelConfig` of `arch` (its smoke-test reduction with
    `smoke=True`).  Raises NotImplementedError for an arch the port does
    not run yet and KeyError for an unknown one."""
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} is not ported yet: it comes with {LATER[arch]}; the "
            f"port runs {sorted(ARCHS)}")
    mod = ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "LATER", "get_config"]
