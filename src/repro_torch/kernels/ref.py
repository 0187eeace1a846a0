"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what one kernel under `csrc/` computes, with
the same fp32 arithmetic, as a chain of PyTorch operations.  The kernel
wrappers run them for CPU tensors (the tests), and `chip_smoke.py` holds
each kernel against them on the card.  Counterpart of `repro.kernels.ref`.

`vjp_of_plain` is the backward of the kernels whose JAX `custom_vjp`
differentiates a plain version (flash attention, the SSD scan).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def vjp_of_plain(plain, inputs, g, *args):
    """The gradients of `plain(*inputs, *args)` against cotangent g, for
    every input, by recomputing the plain version with autograd."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(t.is_floating_point())
              for t in inputs]
        out = plain(*xs, *args)
        wrt = [t for t in xs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in xs)


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


def ssd_scan_ref(x, dt, A, Bc, Cc):
    """The SSD recurrence step by step (the truth each step; slow):
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t.

    x [B, S, H, P]; dt [B, S, H] after softplus; A [H] negative; Bc/Cc
    [B, S, N] -> y [B, S, H, P] in x's dtype, fp32 math, without the D·x
    term.  Counterpart of `repro.kernels.ref.ssd_scan_ref`."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    dA = torch.exp((dt * A[None, None, :]).float())
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * dA[:, t, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t].float() * dt[:, t, :, None],
            Bc[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cc[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x, dt, A, Bc, Cc, chunk: int):
    """The chunked SSD scan: (y [B, S, H, P] in x's dtype, the final state
    [B, H, P, N] fp32), fp32 math, without the D·x term.  The plain
    version of the SSD kernel and the port of `repro.models.ssm`
    `_ssd_chunked_body`, the same function as `ssd_scan_ref`.

    Per chunk of Q = min(chunk, S) positions (S padded to a multiple of Q
    with dt = 0, which gives the padded tokens no weight), seg =
    cumsum(dt A), summed in fp64: it falls by ~|dt A| a position, so at
    Q = 512 it reaches hundreds, where an fp32 difference seg_i − seg_j
    would keep only ~1e-4 of its value; each decay is exp of an fp64
    difference, rounded to fp32 (the JAX package sums seg in fp32).  The
    intra-chunk term (C B^T ⊙ L)(dt x) with L[i, j] =
    exp(seg_i − seg_j) for j <= i, masked BEFORE the exp, so no positive
    difference is exponentiated and the gradient stays finite; the
    inter-chunk term exp(seg) C·state with the state carried across
    chunks.  Autograd differentiates it exactly: it is the backward of
    the SSD kernel."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        S += pad
    nc = S // Q
    dA = (dt * A[None, None, :]).float()                     # [B,S,H] <= 0
    xc = (x.float() * dt[..., None]).reshape(B, nc, Q, H, P)  # dt-weighted
    Bcc = Bc.float().reshape(B, nc, Q, N)
    Ccc = Cc.float().reshape(B, nc, Q, N)
    seg = torch.cumsum(dA.reshape(B, nc, Q, H).double(), dim=2)  # fp64

    # intra-chunk: (C B^T ⊙ L) xw, L[i, j] = exp(seg_i - seg_j) for j <= i
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # [B,nc,Qi,Qj,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(rel.masked_fill(~causal[None, None, :, :, None],
                                  float("-inf"))).float()
    cb = torch.einsum("bcin,bcjn->bcij", Ccc, Bcc)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * L, xc)

    # chunk states, then the recurrence across chunks
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg).float()  # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bcc,
                          xc * decay_to_end[..., None])
    chunk_decay = torch.exp(seg[:, :, -1, :]).float()        # [B,nc,H]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]

    # inter-chunk: exp(seg) C·state of the chunk's start
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Ccc,
                         torch.stack(h_prevs, dim=1)) \
        * torch.exp(seg).float()[..., None]
    return y.reshape(B, S, H, P)[:, :S0].to(x.dtype), h
