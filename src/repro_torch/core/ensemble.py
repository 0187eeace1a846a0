"""Ensemble response (Eqs. 7–8) — counterpart of `repro.core.ensemble`.

Given M trained generators G_i and a noise batch, the ensemble prediction
is the mean over generators and the uncertainty the std over generators,
both averaged over the noise batch (§VI-A).
"""
from __future__ import annotations

import torch

from . import gan
from .tree import tree_map


def ensemble_response(gen_params_stacked, noise):
    """gen_params_stacked: generator stack [M, ...]; noise [k, NOISE_DIM].

    Returns (p_hat [n_params], sigma [n_params]): Eqs. 7 and 8 averaged
    over the noise batch."""
    M = next(gan.leaves(gen_params_stacked)).shape[0]
    preds = gan.generate_params(gen_params_stacked,
                                noise.expand((M,) + tuple(noise.shape)))
    p_hat = preds.mean(0)                                  # Eq. 7
    sigma = torch.sqrt(((preds - p_hat[None]) ** 2).mean(0))   # Eq. 8
    return p_hat.mean(0), sigma.mean(0)


def stack_generators(gen_params_list):
    """Generators of one structure -> one stack [M, ...]."""
    return tree_map(lambda *xs: torch.stack(xs), *gen_params_list)
