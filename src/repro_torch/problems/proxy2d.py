"""2D proxy variant — correlated observables from a 10-parameter family.

Counterpart of `repro.problems.proxy2d`.  Three latent channels come from
the logistic location-scale + shear family of the 1D proxy app, (mu, s,
k) per channel from (p[3c], p[3c+1], p[3c+2]); a 10th parameter rho in
(0, 1) maps to a mixing coefficient r in (-0.9, 0.9) that chains the
channels into correlated observables:

    y0 = z0
    y1 = sqrt(1-r^2) z1 + r z0
    y2 = sqrt(1-r^2) z2 + r z1

All three channels are sampled by ONE call of the inverse-CDF sampler on
u [K, E, 3] (`kernels.inverse_cdf.inverse_cdf_channels`: one launch of
B1 on the card).  The truth and the ranges are the port's own copies of
the JAX module's.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..core import pipeline
from ..kernels.inverse_cdf import inverse_cdf_channels
from . import InverseProblem, register

N_CHANNELS = 3
_RHO_RANGE = (-0.9, 0.9)
TRUE_PARAMS = (0.42, 0.58, 0.33,      # channel 0 (mu, s, k)
               0.67, 0.21, 0.74,      # channel 1
               0.52, 0.39, 0.61,      # channel 2
               0.45)                  # correlation rho


class Proxy2D(InverseProblem):
    name = "proxy2d"
    n_params = 3 * N_CHANNELS + 1           # 10
    obs_dim = N_CHANNELS                    # (y0, y1, y2)
    noise_channels = N_CHANNELS

    def true_params(self, device=None):
        return torch.tensor(TRUE_PARAMS, dtype=torch.float32,
                            device=resolve_device(device))

    def sample_events(self, params, u):
        K, E, _ = u.shape
        mu = pipeline._affine(params[:, 0:9:3], *pipeline._MU_RANGE)  # [K, C]
        s = pipeline._affine(params[:, 1:9:3], *pipeline._S_RANGE)
        k = pipeline._affine(params[:, 2:9:3], *pipeline._K_RANGE)
        z = inverse_cdf_channels(u, mu.contiguous(), s.contiguous(),
                                 k.contiguous())                   # [K, E, C]
        r = pipeline._affine(params[:, 9], *_RHO_RANGE)[:, None]   # [K, 1]
        c_ = torch.sqrt(1.0 - r * r)
        y = torch.stack([z[..., 0],
                         c_ * z[..., 1] + r * z[..., 0],
                         c_ * z[..., 2] + r * z[..., 1]], dim=-1)
        return y.reshape(K * E, N_CHANNELS)


register(Proxy2D())
