"""Mamba-2 (SSD, state-space duality) mixer layer.  [arXiv:2405.21060]
Counterpart of `repro.models.ssm`.

The sequence mixer computes, per head h with scalar decay A_h:
    h_t = exp(A_h dt_t) h_{t-1} + dt_t B_t x_t     (state [P, N])
    y_t = C_t . h_t + D_h x_t

Training runs the chunked SSD form.  `run_ssm` routes by `cfg.attn_impl`:
"chunked" (the default) and "pallas" go to the SSD kernel B5
(`kernels.ssd_scan`; in the JAX package "chunked" is the jnp stand-in for
that kernel), "naive" to the plain `ssd_chunked`.  Prefill
(`ssd_chunked_with_state`) and the one-token decode update are plain
PyTorch, as they are jnp in the JAX package.  One B/C group (G = 1),
multi-head over the expanded inner dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ref import ssd_chunked_ref, ssd_scan_ref
from ..kernels.ssd_scan import ssd_scan
from .config import ModelConfig
from .layers import kaiming, rms_norm


def softplus(x):
    """log(1 + e^x), as `jax.nn.softplus` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm(gen, cfg: ModelConfig, dtype, device=None):
    """The JAX layout and dtypes: separate projections, `A_log`, `D` and
    `dt_bias` in fp32 whatever the model's dtype."""
    D = cfg.d_model
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    p = {"wz": kaiming(gen, (D, di), dtype, device=device),
         "wx": kaiming(gen, (D, di), dtype, device=device),
         "wB": kaiming(gen, (D, N), dtype, device=device),
         "wC": kaiming(gen, (D, N), dtype, device=device),
         "wdt": kaiming(gen, (D, H), dtype, device=device)}
    dev = p["wz"].device
    conv_w = torch.empty((cfg.ssm_conv, conv_ch), dtype=dtype, device=dev)
    if dev.type != "meta":
        conv_w = (0.1 * torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                                    device=gen.device)).to(dev, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    p.update({
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gnorm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": kaiming(gen, (di, D), dtype, fan_in=di, device=dev)})
    return p


def _split_proj(p, x, cfg: ModelConfig):
    return tuple(torch.matmul(x, p[k]) for k in ("wz", "wx", "wB", "wC",
                                                 "wdt"))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time, then SiLU.  xbc [B,S,ch], w [K,ch]."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_chunked(xh, dt, A, Bc, Cc, chunk: int):
    """The chunked SSD scan in plain PyTorch (masked before the exp).
    xh [B,S,H,P]; dt [B,S,H] after softplus; A [H] negative; Bc/Cc
    [B,S,N] -> y [B,S,H,P]."""
    return ssd_chunked_ref(xh, dt, A, Bc, Cc, chunk)[0]


def ssd_chunked_with_state(xh, dt, A, Bc, Cc, chunk: int):
    """As `ssd_chunked`, also returning the final state [B,H,P,N] fp32
    (the prefill path)."""
    return ssd_chunked_ref(xh, dt, A, Bc, Cc, chunk)


def ssd_sequential(xh, dt, A, Bc, Cc):
    """The literal per-step recurrence (slow; tests)."""
    return ssd_scan_ref(xh, dt, A, Bc, Cc)


def _mix_inputs(p, x, cfg: ModelConfig):
    """Projections, the causal conv and the discretisation shared by
    training and prefill: (z, xh, dt, A, Bc, Cc, raw conv input)."""
    B, S, _ = x.shape
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    xbc_raw = torch.cat([xin, Bc, Cc], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
    return z, xh, dt, A, Bc.contiguous(), Cc.contiguous(), xbc_raw


def _mix_output(p, y, xh, z, cfg: ModelConfig):
    """D skip, gate, group norm and the output projection."""
    B, S = y.shape[:2]
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, cfg.ssm_d_inner)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"])


def run_ssm(p, x, cfg: ModelConfig):
    """Full Mamba-2 mixer (train / forward). x [B,S,D] -> [B,S,D]."""
    z, xh, dt, A, Bc, Cc, _ = _mix_inputs(p, x, cfg)
    impl = cfg.attn_impl
    if impl in ("chunked", "pallas"):
        y = ssd_scan(xh.contiguous(), dt, A, Bc, Cc, chunk=cfg.ssm_chunk)
    elif impl == "naive":
        y = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk)
    else:
        raise ValueError(f"attn_impl {impl!r} has no SSM route (chunked, "
                         f"pallas or naive)")
    return _mix_output(p, y, xh, z, cfg)


def ssm_prefill(p, x, cfg: ModelConfig):
    """The mixer over a prompt, also returning its decode cache: the
    final state from the plain chunked scan, and the last ssm_conv − 1
    raw conv inputs.  Counterpart of `repro.models.model._ssm_prefill`."""
    z, xh, dt, A, Bc, Cc, xbc_raw = _mix_inputs(p, x, cfg)
    y, state = ssd_chunked_with_state(xh, dt, A, Bc, Cc, cfg.ssm_chunk)
    cache = {"state": state, "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :]}
    return _mix_output(p, y, xh, z, cfg), cache


# ----------------------------------------------------------------------------
# decode


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype, device=None):
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {"state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                                dtype=dtype, device=device)}


def run_ssm_decode(p, x, cache, cfg: ModelConfig):
    """One-token decode. x [B,1,D] -> y [B,1,D]; the cache's state and
    conv window are updated IN PLACE (the JAX package returns a new
    cache; the serving loop owns this one)."""
    B = x.shape[0]
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)                     # [B,1,ch]
    win = torch.cat([cache["conv"], xbc], dim=1)               # [B,K,ch]
    out = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"])
    xin, Bc, Cc = torch.split(out, [di, N, N], dim=-1)
    dt = softplus(dt[:, 0].float() + p["dt_bias"])               # [B,H]
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, H, P)
    dA = torch.exp(dt * A[None, :])
    state = cache["state"] * dA[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh.float() * dt[..., None], Bc.float())
    y = torch.einsum("bhpn,bn->bhp", state, Cc.float()).to(x.dtype)
    y = y + xh * p["D"][None, :, None].to(x.dtype)
    y = rms_norm(y.reshape(B, 1, di) * F.silu(z), p["gnorm"], cfg.norm_eps)
    cache["state"].copy_(state)
    cache["conv"].copy_(win[:, 1:])
    return torch.matmul(y, p["out_proj"])
