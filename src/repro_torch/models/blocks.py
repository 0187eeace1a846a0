"""Transformer blocks with init, forward and decode.  Counterpart of
`repro.models.blocks` for the kinds the port runs: an attention mixer
(`kind == "attn"`) and a dense SwiGLU MLP (`mlp_kind == "dense"`).  A
block = pre-norm mixer (+ residual), then pre-norm MLP (+ residual).  The
SSM mixer and the MoE MLP raise until their slices land (ROADMAP.md
queue A item 9).
"""
from __future__ import annotations

import torch

from . import layers
from .config import ModelConfig


def check_kinds(kind: str, mlp_kind: str):
    """Raise NotImplementedError for a block the port does not run yet."""
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r}: the port runs attention blocks only; the "
            f"SSM mixer comes with LLM training (ROADMAP.md queue A item 9)")
    if mlp_kind != "dense":
        raise NotImplementedError(
            f"mlp kind {mlp_kind!r}: the port runs dense MLPs only; MoE "
            f"comes with the MoE family (ROADMAP.md queue A item 9)")


# ----------------------------------------------------------------------------
# init


def init_block(gen, cfg: ModelConfig, kind: str, mlp_kind: str, dtype,
               device=None):
    check_kinds(kind, mlp_kind)
    attn = layers.init_attention(gen, cfg, dtype, device)
    dev = attn["wq"].device
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "attn": attn,
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev)}


# ----------------------------------------------------------------------------
# forward (prefill)


def run_block(p, x, cfg: ModelConfig, kind: str, mlp_kind: str, positions):
    """Returns (x, aux_loss); aux is 0 without MoE."""
    check_kinds(kind, mlp_kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + layers.run_attention(p["attn"], h, cfg, positions)
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.run_mlp(p["mlp"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------------------------------------------------------
# decode (one token, cached)


def init_block_cache(batch: int, cfg: ModelConfig, kind: str, window: int,
                     dtype, device=None):
    check_kinds(kind, "dense")
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, window, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, window, KV, hd), dtype=dtype,
                             device=device)}


def run_block_decode(p, x, cache, pos: int, cfg: ModelConfig, kind: str,
                     mlp_kind: str):
    """x [B,1,D]; pos = tokens already in the cache.  Writes this token's
    k/v into `cache` IN PLACE at ring slot pos % W (the JAX package
    returns an updated copy; the serving loop owns the cache, so the copy
    is not needed) and returns (x, cache)."""
    check_kinds(kind, mlp_kind)
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    W = cache["k"].shape[1]
    q, k, v = layers.qkv_project(
        p["attn"], h, cfg, torch.full((1,), pos, device=x.device))
    slot = pos % W                           # ring buffer when windowed
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    valid = torch.full((B,), min(pos + 1, W), device=x.device)
    o = layers.attention_decode(q, cache["k"], cache["v"], valid, cfg)
    o = o.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    x = x + torch.matmul(o, p["attn"]["wo"])
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.run_mlp(p["mlp"], h), cache
