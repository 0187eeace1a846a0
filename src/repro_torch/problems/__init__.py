"""Pluggable inverse problems — the workload layer of the port.

Counterpart of `repro.problems`: everything the solver stack needs to know
about a workload lives behind `InverseProblem`, and a registry maps names
to instances.  The five problems of the JAX registry (`available()`):

    proxy1d      the paper's 1D proxy app: 6 params, 2 observables
    proxy2d      10 params, 3 observables mixed by a learned correlation
    linear_blur  y = A x + eps: an 8-pixel source seen through a fixed
                 4-channel Gaussian blur, logistic measurement noise
    imaging      32x32 inpainting (the conv generator)
    imaging_blur 32x32 compressive blur (the conv generator)

The flat problems sample through one call of the inverse-CDF sampler on
u [K, E, C]; the imaging problems through the mask or the blur and the
sampler on the readout noise.  Each trains (`core.workflow
.train_stacked`) and is served (`serving.SolveService`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import resolve_device
from ..core.residuals import normalized_residuals


class InverseProblem:
    """Interface every SAGIPS workload implements."""

    name: str
    n_params: int
    obs_dim: int
    noise_channels: int

    # image-valued parameter spaces set this to their (H, W); None is a
    # flat parameter vector and the MLP generator
    param_shape: Tuple[int, int] | None = None

    # default events per parameter sample for reference data (Tab. III)
    events_per_sample: int = 100

    # serving-quality bar on mean|r̂| of a trained stack's solve
    solve_threshold: float = 0.5

    def true_params(self, device=None) -> torch.Tensor:
        """Loop-closure truth in (0,1)^n_params, fp32 on `device`."""
        raise NotImplementedError

    def sample_events(self, params, u):
        """params [K, n_params] in (0,1); u [K, E, noise_channels] uniform.

        Returns events [K*E, obs_dim]."""
        raise NotImplementedError

    # -- defaults ------------------------------------------------------------

    def make_reference_data(self, generator: torch.Generator, n_events: int,
                            params=None, device=None):
        """Toy measurement [n_events, obs_dim]: events generated from the
        truth (or `params`), `events_per_sample` per parameter sample, the
        uniforms drawn from `generator` on its own device, then moved to
        `device` (as `repro.problems.InverseProblem.make_reference_data`)."""
        dev = resolve_device(device)
        params = self.true_params(dev) if params is None else params.to(dev)
        E = self.events_per_sample
        K = -(-n_events // E)
        u = torch.rand((K, E, self.noise_channels), generator=generator,
                       device=generator.device).to(dev)
        return self.sample_events(params[None, :].repeat(K, 1),
                                  u)[:n_events]

    def residuals(self, pred_params, true_params=None):
        """Normalized parameter residuals (Eq. 6) against this problem's
        truth, with the safe denominator of `core.residuals`."""
        tp = (self.true_params(pred_params.device) if true_params is None
              else true_params)
        return normalized_residuals(pred_params, tp)

    def mean_abs_residual(self, pred_params, true_params=None):
        return self.residuals(pred_params, true_params).abs().mean()


def synthetic_events(problem: InverseProblem, gen_params, noise, u):
    """The generator -> forward-model pass of the GAN loop (counterpart of
    `repro.problems.synthetic_events`, lines 111–127), over R stacked
    generators with the draws handed in: noise [R, K, NOISE_DIM] and
    u [R, K, E, C] (the JAX function draws them from a key).

    Returns (events [R, K·E, obs_dim], params [R, K, n_params]).  The
    forward model runs once over all ranks, u as [R·K, E, C]: for proxy1d
    that is ONE launch of the inverse-CDF sampler."""
    from ..core import gan
    params = gan.generate_params(gen_params, noise)
    R, K, E, C = u.shape
    events = problem.sample_events(params.reshape((R * K,) + params.shape[2:]),
                                   u.reshape(R * K, E, C))
    return events.reshape(R, K * E, -1), params


# ----------------------------------------------------------------------------
# registry


_REGISTRY: Dict[str, InverseProblem] = {}


def register(problem: InverseProblem) -> InverseProblem:
    """Add a problem instance to the registry (idempotent per name)."""
    for attr in ("name", "n_params", "obs_dim", "noise_channels"):
        if getattr(problem, attr, None) is None:
            raise ValueError(f"problem is missing required attribute {attr!r}")
    _REGISTRY[problem.name] = problem
    return problem


def get_problem(name: str) -> InverseProblem:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown inverse problem {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _register_builtin():
    # each module registers its problem on import
    from . import imaging, linear, proxy1d, proxy2d  # noqa: F401


_register_builtin()

__all__ = ["InverseProblem", "available", "get_problem", "register",
           "synthetic_events"]
