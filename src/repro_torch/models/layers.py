"""Core neural layers: RMSNorm, RoPE, GQA attention (naive / flash /
decode), SwiGLU MLP.  Counterpart of `repro.models.layers`.

All layers are plain functions over parameter dicts in the JAX package's
pytree layout (the same keys), with the same shape conventions:
    x      [B, S, D]
    q      [B, S, KV, G, hd]   (after `qkv_project`)
    k, v   [B, S, KV, hd]
Grouped-query attention never materializes repeated KV heads: the einsums
carry the explicit (KV, G) split, and the flash kernel reads KV head h // G.

Prefill attention routes by `cfg.attn_impl`: "chunked" (the default) and
"pallas" go to the flash-attention kernel B4 (`kernels.flash_attention`;
in the JAX package "chunked" is the pure-jnp stand-in for that kernel);
"naive" is the plain einsum path.  Decode attention, the projections and
the MLP are plain PyTorch (`torch.matmul`), as they are jnp outside any
Pallas kernel in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention_model
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name}")
    return DTYPES[name]


# ----------------------------------------------------------------------------
# initializers


def kaiming(gen, shape, dtype, fan_in=None, device=None):
    """N(0, 2 / fan_in) drawn in fp32 from `gen` on its own device, then
    cast to `dtype` on `device` (default: the generator's); fan_in
    defaults to shape[0].  On the meta device nothing is drawn."""
    fan_in = fan_in or shape[0]
    device = torch.device(device or gen.device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.mul_(math.sqrt(2.0 / fan_in)).to(device, dtype)


# ----------------------------------------------------------------------------
# norms


def rms_norm(x, weight, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x [..., S, n_heads, hd]; positions [..., S] or [S].  Rotates the
    split halves (x1, x2) of the head dim, not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention parameter init


def init_attention(gen, cfg: ModelConfig, dtype, device=None):
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": kaiming(gen, (D, H * hd), dtype, device=device),
        "wk": kaiming(gen, (D, KV * hd), dtype, device=device),
        "wv": kaiming(gen, (D, KV * hd), dtype, device=device),
        "wo": kaiming(gen, (H * hd, D), dtype, fan_in=H * hd, device=device),
    }
    device = p["wq"].device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def qkv_project(p, x, cfg: ModelConfig, positions):
    """Project x to rotated q [B,S,KV,G,hd] and k,v [B,S,KV,hd]."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, KV, H // KV, hd), k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive mask bias [Sq, Sk] in fp32 (0 or -1e30)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, -1e30).float()


def attention_naive(q, k, v, cfg: ModelConfig, q_pos, k_pos):
    """Plain attention. q [B,Sq,KV,G,hd], k/v [B,Sk,KV,hd].  The scores
    are taken in the inputs' dtype, softmaxed in fp32 and cast back to it
    before P·V, as in the JAX package."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() / math.sqrt(hd)
    scores = scores + _mask_bias(q_pos, k_pos, cfg.causal, cfg.sliding_window)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attention_decode(q, k_cache, v_cache, cache_len, cfg: ModelConfig):
    """Single-token decode attention against a (possibly ring-buffer) cache.

    q [B,1,KV,G,hd]; k_cache/v_cache [B,W,KV,hd]; cache_len [B] valid
    length.  Slots at or past cache_len are masked (the cold-start
    prefix); once warm, every slot of a ring buffer is valid."""
    hd = q.shape[-1]
    W = k_cache.shape[1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k_cache).float()
    scores = scores / math.sqrt(hd)
    slot = torch.arange(W, device=q.device)
    valid = slot[None, :] < cache_len[:, None]               # [B, W]
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)


def run_attention(p, x, cfg: ModelConfig, positions):
    """Full attention sublayer (projections + mixing + output)."""
    o, _, _ = run_attention_with_kv(p, x, cfg, positions)
    return o


def run_attention_with_kv(p, x, cfg: ModelConfig, positions):
    """As run_attention but also returns (k, v) for prefill cache writes.

    `positions` are 0..S-1 (the flash kernel counts positions from 0)."""
    B, S, _ = x.shape
    q, k, v = qkv_project(p, x, cfg, positions)
    impl = cfg.attn_impl
    if impl in ("chunked", "pallas"):
        o = flash_attention_model(q, k, v, causal=cfg.causal,
                                  window=cfg.sliding_window)
    elif impl == "naive":
        o = attention_naive(q, k, v, cfg, positions, positions)
    elif impl == "seq_parallel":
        raise NotImplementedError(
            "attn_impl='seq_parallel' shards the sequence over a device "
            "mesh; the port has no mesh yet (ROADMAP.md queue A item 6, the "
            "multi-GPU backend)")
    else:
        raise ValueError(f"unknown attn_impl {impl!r}")
    o = o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    return torch.matmul(o, p["wo"]), k, v


# ----------------------------------------------------------------------------
# MLP


def init_mlp(gen, d_model, d_ff, dtype, device=None):
    return {
        "w1": kaiming(gen, (d_model, d_ff), dtype, device=device),
        "w3": kaiming(gen, (d_model, d_ff), dtype, device=device),
        "w2": kaiming(gen, (d_ff, d_model), dtype, fan_in=d_ff,
                      device=device),
    }


def run_mlp(p, x):
    h = F.silu(torch.matmul(x, p["w1"]))
    h = h * torch.matmul(x, p["w3"])
    return torch.matmul(h, p["w2"])
