"""The 1D proxy app's forward model: 6 parameters -> events (y0, y1).

Counterpart of `repro.core.pipeline`.  Observable j is drawn through the
inverse-CDF sampler (`kernels.inverse_cdf`) from the logistic + shear
family, with (mu, s, k) affine maps of (p[3j], p[3j+1], p[3j+2]):

    y = mu + s * log(u / (1-u)) + k * (u - 0.5),   u ~ U(0, 1)

Both channels go through ONE sampler call on u [K, E, 2] (the JAX Pallas
path launches once per channel and stacks).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..kernels.inverse_cdf import inverse_cdf_channels

N_PARAMS = 6
EVENTS_PER_SAMPLE = 100          # Tab. III: events generated per param sample
PARAM_SAMPLES = 1024             # Tab. III: predicted parameter samples
TRUE_PARAMS = (0.35, 0.62, 0.48, 0.71, 0.26, 0.55)   # loop-closure truth

# physical ranges for (mu, s, k) per observable
_MU_RANGE = (-2.0, 2.0)
_S_RANGE = (0.05, 1.0)
_K_RANGE = (-1.0, 1.0)


def _affine(p, lo, hi):
    return lo + (hi - lo) * p


def true_params(device=None) -> torch.Tensor:
    """`TRUE_PARAMS` as an fp32 tensor on `device`."""
    return torch.tensor(TRUE_PARAMS, dtype=torch.float32,
                        device=resolve_device(device))


def sample_events(params, u):
    """params [K, 6] in (0, 1); u [K, E, 2] uniform noise -> events
    [K·E, 2], E events per parameter sample, observables (y0, y1)."""
    K, E, C = u.shape
    mu = _affine(params[:, 0::3], *_MU_RANGE)      # [K, 2]: p0, p3
    s = _affine(params[:, 1::3], *_S_RANGE)        # p1, p4
    k = _affine(params[:, 2::3], *_K_RANGE)        # p2, p5
    return inverse_cdf_channels(u, mu, s, k).reshape(K * E, C)

