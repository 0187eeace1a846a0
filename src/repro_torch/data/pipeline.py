"""Synthetic batches per model family, counterpart of
`repro.data.pipeline`.

Both draw from one numpy `RandomState(seed)`, as the JAX package does
(the audio batch: `randn` for the frame features first, then `randint`
for the labels; the vlm batch: `randint` for the text tokens first, then
`randn` for the patch embeddings), and the stream uses its seed formula,
so the port's batches are bitwise the JAX package's.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.layers import torch_dtype
from ..models.model import AUDIO_FEAT_DIM, VISION_EMB_DIM


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device=None):
    """{"tokens": [batch, seq] int32}; for the audio family {"features":
    [batch, seq, AUDIO_FEAT_DIM] in cfg.dtype, "labels": [batch, seq]
    int32}; for the vlm family {"tokens": [batch, seq − n_vis] int32,
    "vision": [batch, n_vis, VISION_EMB_DIM] in cfg.dtype} with n_vis =
    min(num_vision_tokens or 256, seq // 2), so `seq` counts the patches
    and the text together.  On `device` (CUDA by default).  Float64 draws
    reach cfg.dtype in one rounding, as `jnp.asarray` casts them."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def ints(shape):
        return torch.from_numpy(
            rng.randint(0, cfg.vocab_size, shape).astype(np.int32)).to(dev)

    def normal(shape):
        return torch.from_numpy(rng.randn(*shape)).to(
            dev, torch_dtype(cfg.dtype))
    # a dict display evaluates in order: the draws are JAX's, in its order
    if cfg.family == "audio":
        return {"features": normal((batch, seq, AUDIO_FEAT_DIM)),
                "labels": ints((batch, seq))}
    if cfg.family == "vlm":
        n_vis = min(cfg.num_vision_tokens or 256, seq // 2)
        return {"tokens": ints((batch, seq - n_vis)),
                "vision": normal((batch, n_vis, VISION_EMB_DIM))}
    return {"tokens": ints((batch, seq))}


class TokenStream:
    """Infinite deterministic synthetic token stream with a fixed vocab.

    `shard_index / num_shards` partition the stream as per-host data
    loading would (each host reads a disjoint slice)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 device=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.shard_index, self.num_shards = \
            seed, shard_index, num_shards
        self.device = resolve_device(device)
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        seed = (self.seed + self._step * self.num_shards
                + self.shard_index) % (2 ** 31)
        self._step += 1
        return make_batch(self.cfg, self.batch, self.seq, seed=seed,
                          device=self.device)
