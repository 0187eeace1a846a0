"""LLM serving engine: prefill + batched single-token decode with the
ring-buffer KV cache.  Counterpart of `repro.serving.engine` (lines
40-84), as plain callables: PyTorch runs eagerly, so there is no jit, and
there is no mesh (one card).

Sliding-window configs keep a ring-buffer KV cache of `sliding_window`
slots, so decode memory and cost stay O(window).  On the card, prefill
attention runs the flash-attention kernel B4 once per attention layer
(`models.layers.run_attention_with_kv`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import model as model_lib
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, tap=None):
    """(params, tokens [B,1], cache) -> (logits [B,1,V], cache); the cache
    is updated in place."""
    def step(params, tokens, cache):
        return model_lib.decode_step(params, tokens, cache, cfg, tap)
    return step


def make_prefill_fn(cfg: ModelConfig, tap=None):
    """(params, batch, context_len=None, last_logits_only=False) ->
    (logits, cache)."""
    def fn(params, batch, context_len=None, last_logits_only=False):
        return model_lib.prefill(params, batch, cfg, context_len,
                                 last_logits_only=last_logits_only,
                                 tap=tap)
    return fn


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt_tokens, max_new_tokens: int,
             context_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             on_logits: Optional[Callable] = None, tap=None):
    """Greedy (temperature <= 0) or sampled generation.

    prompt_tokens [B, S] on the params' device.  Returns [B, S +
    max_new_tokens].  Sampling draws from softmax(logits / temperature)
    with `generator` (on the same device; the JAX package's
    `jax.random.categorical` stream cannot be replayed here).
    `on_logits(i, logits)`, if given, sees the logits [B,1,V] that pick
    token i: the prefill's last (i = 0), then each decode step's.  `tap`:
    a `models.moe.Tap` every MoE layer reports to."""
    B, S = prompt_tokens.shape
    ctx = context_len or (S + max_new_tokens)
    prefill_fn = make_prefill_fn(cfg, tap)
    step_fn = make_serve_step(cfg, tap)
    last, cache = prefill_fn(params, {"tokens": prompt_tokens}, ctx,
                             last_logits_only=True)
    out = [prompt_tokens]

    def pick(lg):
        if temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg[:, 0].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    for i in range(max_new_tokens):
        if on_logits is not None:
            on_logits(i, last)
        nxt = pick(last).to(prompt_tokens.dtype)          # [B,1]
        out.append(nxt)
        if i == max_new_tokens - 1:
            break
        last, cache = step_fn(params, nxt, cache)
    return torch.cat(out, dim=1)
