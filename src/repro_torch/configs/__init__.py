"""Presets of the port: the solve service's `DEFAULT` and `REDUCED`
(`serving`), as in `repro.configs.serving`, and the architecture registry
of the LLM serving path: `--arch <id>` resolves here, as in
`repro.configs`.

Only the dense decoders are registered: their layers are all ported
(`models.layers`, `models.blocks`).  The other archs of the JAX package
raise `NotImplementedError` naming the ROADMAP item that ports them.
"""
from . import deepseek_67b, qwen2_5_3b, qwen3_32b, tinyllama_1_1b

ARCHS = {
    "qwen3-32b": qwen3_32b,
    "qwen2.5-3b": qwen2_5_3b,
    "deepseek-67b": deepseek_67b,
    "tinyllama-1.1b": tinyllama_1_1b,
}

# archs of the JAX package not ported yet -> what ports them
LATER = {
    "mamba2-130m": "the SSM family with LLM training (models/ssm.py, "
                   "kernel B5), ROADMAP.md queue A item 9, the next slice",
    "qwen2-moe-a2.7b": "the MoE family (models/moe.py), ROADMAP.md queue A "
                       "item 9",
    "granite-moe-3b-a800m": "the MoE family (models/moe.py), ROADMAP.md "
                            "queue A item 9",
    "jamba-1.5-large-398b": "the hybrid family (SSM + MoE layers), "
                            "ROADMAP.md queue A item 9",
    "hubert-xlarge": "the audio family (encoder-only), ROADMAP.md queue A "
                     "item 9",
    "internvl2-1b": "the VLM family (vision frontend), ROADMAP.md queue A "
                    "item 9",
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
