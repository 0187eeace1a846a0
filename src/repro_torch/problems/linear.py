"""Linear-operator inverse problem — y = A x + eps with a generative prior.

Counterpart of `repro.problems.linear` (`linear_blur`).  An 8-pixel
source x (the generator's output mapped to (-1, 1)^8) is observed through
a fixed 4-row Gaussian blur A; each event is one noisy measurement

    y = A x + SIGMA * log(u / (1 - u)),     u ~ U(0,1)^4

drawn by the inverse-CDF sampler with mu = (A x)_c, s = SIGMA and k = 0:
one call on u [K, E, 4] (`kernels.inverse_cdf.inverse_cdf_channels`, one
launch of B1 on the card).  `x @ A.T` stays a `torch.matmul`, as the JAX
package computes it outside any Pallas kernel.  A maps 8 -> 4, so the
operator has a null space.  The truth keeps one near-zero pixel (0.002),
whose Eq. 6 residual divides by the clamped denominator: a good
reconstruction still carries an O(1) mean residual, hence the looser
`solve_threshold`.  A, SIGMA and the truth are the port's own copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..core import pipeline
from ..kernels.inverse_cdf import inverse_cdf_channels
from . import InverseProblem, register

N_PIXELS = 8
N_MEAS = 4
SIGMA = 0.05                     # measurement-noise scale
_X_RANGE = (-1.0, 1.0)           # physical source range
TRUE_PARAMS = (0.15, 0.85, 0.50, 0.30,
               0.70, 0.45, 0.60, 0.002)   # last pixel ~ 0


def _blur_operator() -> np.ndarray:
    """Fixed [N_MEAS, N_PIXELS] Gaussian blur: measurement i integrates a
    width-1.5 window centred at source position 2i + 0.5 (a stride-2
    downsampling blur); rows normalised to unit mass, computed in float64
    and stored as fp32, as the JAX module does."""
    j = np.arange(N_PIXELS)[None, :]
    centers = (2.0 * np.arange(N_MEAS) + 0.5)[:, None]
    a = np.exp(-((j - centers) ** 2) / (2.0 * 1.5 ** 2))
    return (a / a.sum(axis=1, keepdims=True)).astype(np.float32)


A = _blur_operator()


@functools.lru_cache(maxsize=None)
def _a_on(device: torch.device) -> torch.Tensor:
    """A as a tensor on `device`, copied there once."""
    return torch.tensor(A, device=device)


class LinearBlur(InverseProblem):
    name = "linear_blur"
    n_params = N_PIXELS
    obs_dim = N_MEAS
    noise_channels = N_MEAS
    solve_threshold = 2.5

    def true_params(self, device=None):
        return torch.tensor(TRUE_PARAMS, dtype=torch.float32,
                            device=resolve_device(device))

    def sample_events(self, params, u):
        K, E, _ = u.shape
        x = pipeline._affine(params, *_X_RANGE)                # [K, P]
        mean = torch.matmul(x, _a_on(params.device).T)         # [K, M]
        s = torch.full_like(mean, SIGMA)
        k = torch.zeros_like(mean)
        y = inverse_cdf_channels(u, mean.contiguous(), s, k)
        return y.reshape(K * E, N_MEAS)


register(LinearBlur())
