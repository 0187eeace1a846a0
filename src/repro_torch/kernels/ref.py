"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what one kernel under `csrc/` computes, with
the same fp32 arithmetic, as a chain of PyTorch operations.  The kernel
wrappers run them for CPU tensors (the tests), and `chip_smoke.py` holds
each kernel against them on the card.  Counterpart of `repro.kernels.ref`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# u is clamped to [U_EPS, 1 - U_EPS] before the logit (repro.kernels.ref)
U_EPS = 1e-6


def inverse_cdf_ref(u, mu, s, k):
    """Logistic + shear inverse CDF, y = mu + s·log(u/(1−u)) + k·(u−0.5).

    u [K, E, ...]; mu/s/k [K, ...] (broadcast across the event axis 1), so
    one function covers both `[K, E]` with `[K]` rows and `[K, E, C]` with
    `[K, C]` rows.  Math in fp32 with u clamped to [1e-6, 1 − 1e-6]; the
    clamp keeps NaN as NaN, as `jnp.clip` does.  Returns u's dtype, as the
    kernel writes it (the JAX oracle returns fp32; the two agree after
    rounding)."""
    uf = torch.clamp(u.float(), U_EPS, 1.0 - U_EPS)
    mu, s, k = (p.float().unsqueeze(1) for p in (mu, s, k))
    y = mu + s * torch.log(uf / (1.0 - uf)) + k * (uf - 0.5)
    return y.to(u.dtype)


# separable 3-tap blur weights (repro.kernels.imaging): w0 + 2·w1 = 1
BLUR_W0 = 0.5
BLUR_W1 = 0.25


def mask_apply_ref(x, m):
    """x [K, P]; m [P] 0/1 observation mask -> x·m, fp32 math, in x's
    dtype (the inpainting occlusion)."""
    return (x.float() * m.float()[None, :]).to(x.dtype)


def blur2d_ref(x):
    """x [K, H, W] -> separable 3-tap (0.25, 0.5, 0.25) blur, rows then
    columns, zero boundary, fp32 math, in x's dtype.  The zero-boundary
    shifts are pad + slice, in the oracle's order of operations."""
    xf = x.float()
    up = F.pad(xf[:, 1:, :], (0, 0, 0, 1))         # x[r + 1], 0 at the bottom
    down = F.pad(xf[:, :-1, :], (0, 0, 1, 0))      # x[r - 1], 0 at the top
    v = BLUR_W0 * xf + BLUR_W1 * (up + down)
    left = F.pad(v[:, :, 1:], (0, 1))              # v[c + 1]
    right = F.pad(v[:, :, :-1], (1, 0))            # v[c - 1]
    return (BLUR_W0 * v + BLUR_W1 * (left + right)).to(x.dtype)


def flash_attention_ref(q, k, v, causal: bool = True,
                        window: Optional[int] = None):
    """q [B, H, Sq, hd], k/v [B, KV, Sk, hd] (GQA: H = KV·G, query head h
    reads KV head h // G) -> [B, H, Sq, hd] in q's dtype, fp32 math.

    Positions count from 0 in both q and k; key k is visible to query i
    when k <= i (causal) and k > i - window (window).  Masked scores are
    -inf, so a row with no visible key is NaN, as in the JAX oracle."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
