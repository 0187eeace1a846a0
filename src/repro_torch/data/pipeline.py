"""Synthetic batches per model family, counterpart of
`repro.data.pipeline`.

Both draw from one numpy `RandomState(seed)`, as the JAX package does
(the audio batch: `randn` for the frame features first, then `randint`
for the labels), and the stream uses its seed formula, so the port's
batches are bitwise the JAX package's.  The VLM batch raises: its
frontend is not ported.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.layers import torch_dtype
from ..models.model import AUDIO_FEAT_DIM


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device=None):
    """{"tokens": [batch, seq] int32}, or for the audio family
    {"features": [batch, seq, AUDIO_FEAT_DIM] in cfg.dtype, "labels":
    [batch, seq] int32}, on `device` (CUDA by default)."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the vlm batches come with the vision frontend "
            f"(ROADMAP.md queue A item 10)")
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if cfg.family == "audio":
        # float64 -> cfg.dtype in one rounding, as jnp.asarray casts
        feats = torch.from_numpy(rng.randn(batch, seq, AUDIO_FEAT_DIM))
        labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        return {"features": feats.to(dev, torch_dtype(cfg.dtype)),
                "labels": torch.from_numpy(labels).to(dev)}
    toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev)}


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
