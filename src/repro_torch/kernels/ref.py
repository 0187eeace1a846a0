"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what one kernel under `csrc/` computes, with
the same fp32 arithmetic, as a chain of PyTorch operations.  The kernel
wrappers run them for CPU tensors (the tests), and `chip_smoke.py` holds
each kernel against them on the card.  Counterpart of `repro.kernels.ref`.
"""
from __future__ import annotations

import torch

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
