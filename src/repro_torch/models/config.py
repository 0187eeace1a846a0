"""Unified model configuration for the architecture zoo.

The port's own copy of `repro.models.config` (plain Python, the same
fields, defaults and counts).  One dataclass describes every family
(dense / moe / ssm / hybrid / audio / vlm); family-specific fields are
zero / None when unused.  The port runs the dense, moe, ssm and audio
families (`models.blocks`); `attn_impl` routes prefill attention and the
SSM scan: "chunked" (the default) and "pallas" to the flash-attention
kernel B4 and the SSD kernel B5, "naive" to the plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # ---- attention options -------------------------------------------------
    qk_norm: bool = False             # qwen3-style RMSNorm on q/k heads
    qkv_bias: bool = False            # qwen2.5-style bias on qkv projections
    rope_theta: float = 10_000.0
    causal: bool = True               # False for encoder-only (hubert)
    sliding_window: Optional[int] = None   # None = full attention

    # ---- MoE ---------------------------------------------------------------
    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01     # load-balance loss coefficient

    # ---- SSM (Mamba-2 / SSD) -----------------------------------------------
    ssm_state: int = 0                # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64            # P
    ssm_chunk: int = 64               # SSD chunk length
    ssm_conv: int = 4                 # causal conv window

    # ---- hybrid (jamba) ----------------------------------------------------
    attn_period: int = 0              # one attention layer per `attn_period`
    attn_offset: int = 0              # position of the attn layer in a period
    moe_period: int = 0               # MoE MLP every `moe_period` layers

    # ---- modality frontend (stubbed per brief) -------------------------------
    frontend: Optional[str] = None    # 'audio' | 'vision'
    num_vision_tokens: int = 0        # vlm: patch-embedding prefix length

    # ---- misc ----------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"        # 'full' | 'dots' (save matmul outputs)
    # attention / SSD implementation: 'chunked' and 'pallas' (the kernels
    # B4 and B5 in the port), 'naive' (the plain PyTorch paths)
    attn_impl: str = "chunked"
    attn_chunk: int = 512

    # citation of the source model-card / paper for the assigned config
    source: str = ""

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def supports_long_context(self) -> bool:
        """True when decode cost per token is sub-quadratic in context."""
        if self.family == "ssm":
            return True
        if self.sliding_window is not None:
            return True
        if self.family == "hybrid":
            # hybrid needs a window on its attention layers
            return self.sliding_window is not None
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kind(self, i: int) -> str:
        """Mixer kind ('attn' | 'ssm') of layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if i % self.attn_period == self.attn_offset else "ssm"
        return "attn"

    def mlp_kind(self, i: int) -> str:
        """'moe' | 'dense' | 'none' for layer i."""
        if self.family == "ssm":
            return "none"               # mamba2-130m has no separate MLP
        if self.num_experts > 0:
            if self.family == "hybrid" and self.moe_period:
                return "moe" if i % self.moe_period == self.moe_period - 1 else "dense"
            return "moe"
        return "dense"

    # --- parameter counting (used for roofline MODEL_FLOPS) -------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        D, Hd = self.d_model, self.resolved_head_dim
        attn = D * (self.num_heads * Hd) + 2 * D * (self.num_kv_heads * Hd) \
            + (self.num_heads * Hd) * D
        dense_mlp = 3 * D * self.d_ff if self.d_ff else 0
        if self.family in ("ssm", "hybrid"):
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            # in_proj -> z, x, B, C, dt ; out_proj
            ssm = D * (2 * di + 2 * N + H) + di * D + self.ssm_conv * (di + 2 * N)
        else:
            ssm = 0
        moe_e = 3 * D * self.moe_d_ff if self.moe_d_ff else 0
        total = 0
        active = 0
        for i in range(self.num_layers):
            mix = attn if self.layer_kind(i) == "attn" else ssm
            total += mix
            active += mix
            mk = self.mlp_kind(i)
            if mk == "dense":
                total += dense_mlp
                active += dense_mlp
            elif mk == "moe":
                total += (self.num_experts + self.num_shared_experts) * moe_e \
                    + D * self.num_experts
                active += (self.top_k + self.num_shared_experts) * moe_e \
                    + D * self.num_experts
        emb = self.vocab_size * D
        total += emb + (0 if self.tie_embeddings else emb)
        # embeddings are lookups, not matmuls; lm head is a matmul
        active += (0 if self.is_encoder_only else self.vocab_size * D)
        return {"total": total, "active": active}
