"""Transformer and Mamba blocks with init, forward and decode.
Counterpart of `repro.models.blocks`: an attention mixer (`kind ==
"attn"`) or the Mamba-2 mixer (`kind == "ssm"`), then a dense SwiGLU MLP
(`mlp_kind == "dense"`), the MoE MLP (`"moe"`, `models.moe`) or none
(`"none"`, the ssm family).  A block = pre-norm mixer (+ residual), then
the pre-norm MLP (+ residual) if it has one.
"""
from __future__ import annotations

import torch

from . import layers, moe as moe_lib, ssm as ssm_lib
from .config import ModelConfig


def check_kinds(kind: str, mlp_kind: str):
    """Raise ValueError for an unknown mixer or MLP kind."""
    if kind not in ("attn", "ssm"):
        raise ValueError(f"unknown block kind {kind!r}")
    if mlp_kind not in ("dense", "moe", "none"):
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
    if mlp_kind != "none":
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if mlp_kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, dev)
    elif mlp_kind == "dense":
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    return p


def mlp_sublayer(p, x, cfg: ModelConfig, mlp_kind: str, tap=None):
    """The pre-norm MLP with its residual: (x, aux), aux None unless the
    MLP is MoE.  `tap`: a `models.moe.Tap` the MoE reports to."""
    if mlp_kind == "none":
        return x, None
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if mlp_kind == "moe":
        h, aux = moe_lib.run_moe(p["moe"], h, cfg, tap)
        return x + h, aux
    return x + layers.run_mlp(p["mlp"], h), None


# ----------------------------------------------------------------------------
# forward (prefill)


def run_block(p, x, cfg: ModelConfig, kind: str, mlp_kind: str, positions,
              tap=None):
    """Returns (x, aux_loss); aux is 0 without MoE."""
    check_kinds(kind, mlp_kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        x = x + layers.run_attention(p["attn"], h, cfg, positions)
    else:
        x = x + ssm_lib.run_ssm(p["ssm"], h, cfg)
    x, aux = mlp_sublayer(p, x, cfg, mlp_kind, tap)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


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
                     mlp_kind: str, tap=None):
    """x [B,1,D]; pos = tokens already in the cache.  Writes this token's
    k/v (attention: at ring slot pos % W) or the SSM state and conv
    window into `cache` IN PLACE (the JAX package returns an updated copy;
    the serving loop owns the cache, so the copy is not needed) and
    returns (x, cache).  A MoE MLP's aux loss is dropped, as in JAX."""
    check_kinds(kind, mlp_kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        x = x + ssm_lib.run_ssm_decode(p["ssm"], h, cache, cfg)
    else:
        x = x + _attention_decode(p["attn"], h, cache, pos, cfg)
    x, _ = mlp_sublayer(p, x, cfg, mlp_kind, tap)
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
