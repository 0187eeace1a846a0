"""Convergence metric — normalized parameter residuals (Eq. 6):

    r̂_i = (p_i - p̂_i) / p_i

against the loop-closure truth.  Counterpart of `repro.core.residuals`:
truths with |p_i| < DENOM_EPS divide by ±DENOM_EPS (sign-preserving, zero
counts as positive) instead of emitting inf/NaN; above the clamp the
result is the raw division.
"""
from __future__ import annotations

import torch

from .pipeline import TRUE_PARAMS

DENOM_EPS = 1e-6


def _safe_denominator(tp):
    """tp with |tp| clamped to >= DENOM_EPS, preserving sign."""
    eps = torch.tensor(DENOM_EPS, dtype=tp.dtype, device=tp.device)
    return torch.where(tp.abs() < eps, torch.where(tp < 0, -eps, eps), tp)


def normalized_residuals(pred_params, true_params=None):
    """pred_params [..., n_params] -> residuals [..., n_params]."""
    tp = torch.as_tensor(TRUE_PARAMS if true_params is None else true_params,
                         dtype=pred_params.dtype, device=pred_params.device)
    return (tp - pred_params) / _safe_denominator(tp)


def mean_abs_residual(pred_params, true_params=None):
    return normalized_residuals(pred_params, true_params).abs().mean()
