"""Imaging inverse problems — counterpart of `repro.problems.imaging`.

Two problems recover the same 32x32 = 1024-parameter image from pointwise
sensor readings of a structured linear observation of it:

    imaging        inpainting: the observed field is M ⊙ x, with a central
                   12x12 box occluded (`kernels.imaging.mask_apply`)
    imaging_blur   compressive blur: a separable 3-tap blur of x
                   (`kernels.imaging.blur2d`), subsampled with stride 2
                   onto a 16x16 grid (1024 -> 256 sites)

An event is a reading at a uniformly random site: its normalized (row,
col), 12 Fourier features of that position, and the field's value there
plus logistic noise drawn by the inverse-CDF sampler (mu = 0, s = SIGMA,
k = 0), so obs_dim = EVENT_DIM = 15.  Both declare `param_shape = (32,
32)`, which selects the conv generator (`models.convgen`).

The truth image, the mask, the Fourier frequencies and the blur taps are
the port's own copies of the JAX module's constants.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import resolve_device
from ..kernels.imaging import blur2d, mask_apply
from ..kernels.inverse_cdf import inverse_cdf
from . import InverseProblem, register

H = W = 32
SIGMA = 0.05                     # logistic measurement-noise scale
OCC_ROWS = slice(10, 22)         # occluded box (inpainting problem)
OCC_COLS = slice(8, 20)
BLUR_STRIDE = 2                  # subsampling stride (compressive blur)

# Fourier positional-feature frequencies (cycles across the image);
# obs_dim = 2 + 4 * len(PE_FREQS) + 1
PE_FREQS = (1.0, 2.0, 4.0)
EVENT_DIM = 3 + 4 * len(PE_FREQS)


def _truth_image() -> np.ndarray:
    """Deterministic smooth two-Gaussian-blob truth in [0.2, 0.85], flat
    [H·W] fp32 (computed in float64 as the JAX module does)."""
    r, c = np.mgrid[0:H, 0:W].astype(np.float64)
    g1 = np.exp(-(((r - 11.0) ** 2 + (c - 13.0) ** 2) / (2.0 * 4.0 ** 2)))
    g2 = np.exp(-(((r - 22.0) ** 2 + (c - 20.0) ** 2) / (2.0 * 5.5 ** 2)))
    img = 0.2 + 0.65 * np.clip(0.9 * g1 + 0.8 * g2, 0.0, 1.0)
    return img.reshape(-1).astype(np.float32)


def _observation_mask() -> np.ndarray:
    """Flat [H·W] 0/1 fp32 mask: 0 inside the occluded central box."""
    m = np.ones((H, W), np.float32)
    m[OCC_ROWS, OCC_COLS] = 0.0
    return m.reshape(-1)


TRUE_IMAGE = _truth_image()
MASK = _observation_mask()


@functools.lru_cache(maxsize=None)
def _mask_on(device: torch.device) -> torch.Tensor:
    """MASK as a tensor on `device`, copied there once."""
    return torch.tensor(MASK, device=device)


def site_index(u0, n_sites: int):
    """The site each event reads, from its selector uniforms u0 [K, E]:
    clamp(int32(u0·n_sites), 0, n_sites − 1), as the JAX readout."""
    return torch.clamp((u0 * n_sites).to(torch.int32), 0, n_sites - 1)


def _readout(field, u, grid_hw):
    """Pointwise sensor readout of a per-sample field.

    field [K, S] (S = grid_hw[0]·grid_hw[1] sites); u [K, E, 2] with
    u[..., 0] selecting the site and u[..., 1] driving the noise.  Returns
    events [K·E, EVENT_DIM] = (row, col, Fourier features, noisy value)."""
    K, E, _ = u.shape
    gh, gw = grid_hw
    idx = site_index(u[..., 0], gh * gw)
    value_mean = torch.gather(field, 1, idx.long())              # [K, E]
    zeros = torch.zeros((K,), dtype=field.dtype, device=field.device)
    s = torch.full((K,), SIGMA, dtype=field.dtype, device=field.device)
    # the sampler takes a contiguous u; u[..., 1] is a stride-2 view
    noise = inverse_cdf(u[..., 1].contiguous(), zeros, s, zeros)
    row = torch.div(idx, gw, rounding_mode="floor") / (gh - 1.0)
    col = (idx % gw) / (gw - 1.0)
    feats = [row, col]
    for f in PE_FREQS:
        for p in (row, col):
            feats.append(torch.sin(2.0 * math.pi * f * p))
            feats.append(torch.cos(2.0 * math.pi * f * p))
    feats.append(value_mean + noise)
    return torch.stack(feats, dim=-1).reshape(K * E, EVENT_DIM)


class _Imaging(InverseProblem):
    n_params = H * W
    obs_dim = EVENT_DIM            # (position features, value) readings
    noise_channels = 2             # site selector + measurement noise
    param_shape = (H, W)
    solve_threshold = 0.5

    def true_params(self, device=None):
        return torch.tensor(TRUE_IMAGE, device=resolve_device(device))


class Inpainting(_Imaging):
    name = "imaging"

    def sample_events(self, params, u):
        return _readout(mask_apply(params, _mask_on(params.device)), u,
                        (H, W))


class CompressiveBlur(_Imaging):
    name = "imaging_blur"

    def sample_events(self, params, u):
        K = params.shape[0]
        blurred = blur2d(params.reshape(K, H, W))
        field = blurred[:, ::BLUR_STRIDE, ::BLUR_STRIDE].reshape(K, -1)
        return _readout(field, u, (H // BLUR_STRIDE, W // BLUR_STRIDE))


register(Inpainting())
register(CompressiveBlur())
