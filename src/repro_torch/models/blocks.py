"""Transformer and Mamba blocks with init, forward and decode.
Counterpart of `repro.models.blocks` for the kinds the port runs: an
attention mixer (`kind == "attn"`) with a dense SwiGLU MLP (`mlp_kind ==
"dense"`), and the Mamba-2 mixer (`kind == "ssm"`) with no MLP
(`mlp_kind == "none"`, the ssm family).  A block = pre-norm mixer (+
residual), then the pre-norm MLP (+ residual) if it has one.  The MoE MLP
raises until its slice lands (ROADMAP.md queue A item 10).
"""
from __future__ import annotations

import torch

from . import layers, ssm as ssm_lib
from .config import ModelConfig


def check_kinds(kind: str, mlp_kind: str):
    """Raise NotImplementedError for a block the port does not run yet."""
    if kind not in ("attn", "ssm"):
        raise ValueError(f"unknown block kind {kind!r}")
    if mlp_kind == "moe":
        raise NotImplementedError(
            "mlp kind 'moe': the port runs dense MLPs only; MoE comes with "
            "the MoE family (ROADMAP.md queue A item 10)")
    if mlp_kind not in ("dense", "none"):
        raise ValueError(f"unknown mlp kind {mlp_kind!r}")


# ----------------------------------------------------------------------------
# init


def init_block(gen, cfg: ModelConfig, kind: str, mlp_kind: str, dtype,
               device=None):
    check_kinds(kind, mlp_kind)
    if kind == "attn":
        mixer = layers.init_attention(gen, cfg, dtype, device)
    else:
        mixer = ssm_lib.init_ssm(gen, cfg, dtype, device)
    dev = next(iter(mixer.values())).device
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
         kind: mixer}
    if mlp_kind == "dense":
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    return p


# ----------------------------------------------------------------------------
# forward (prefill)


def run_block(p, x, cfg: ModelConfig, kind: str, mlp_kind: str, positions):
    """Returns (x, aux_loss); aux is 0 without MoE."""
    check_kinds(kind, mlp_kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        x = x + layers.run_attention(p["attn"], h, cfg, positions)
    else:
        x = x + ssm_lib.run_ssm(p["ssm"], h, cfg)
    if mlp_kind == "dense":
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.run_mlp(p["mlp"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------------------------------------------------------
# decode (one token, cached)


def init_block_cache(batch: int, cfg: ModelConfig, kind: str, window: int,
                     dtype, device=None):
    check_kinds(kind, "none")
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(batch, cfg, dtype, device)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, window, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, window, KV, hd), dtype=dtype,
                             device=device)}


def run_block_decode(p, x, cache, pos: int, cfg: ModelConfig, kind: str,
                     mlp_kind: str):
    """x [B,1,D]; pos = tokens already in the cache.  Writes this token's
    k/v (attention: at ring slot pos % W) or the SSM state and conv
    window into `cache` IN PLACE (the JAX package returns an updated copy;
    the serving loop owns the cache, so the copy is not needed) and
    returns (x, cache)."""
    check_kinds(kind, mlp_kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        x = x + ssm_lib.run_ssm_decode(p["ssm"], h, cache, cfg)
    else:
        x = x + _attention_decode(p["attn"], h, cache, pos, cfg)
    if mlp_kind == "dense":
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.run_mlp(p["mlp"], h)
    return x, cache


def _attention_decode(p, h, cache, pos: int, cfg: ModelConfig):
    B = h.shape[0]
    W = cache["k"].shape[1]
    q, k, v = layers.qkv_project(
        p, h, cfg, torch.full((1,), pos, device=h.device))
    slot = pos % W                           # ring buffer when windowed
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    valid = torch.full((B,), min(pos + 1, W), device=h.device)
    o = layers.attention_decode(q, cache["k"], cache["v"], valid, cfg)
    o = o.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return torch.matmul(o, p["wo"])
