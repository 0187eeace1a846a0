"""The paper's 1D proxy app as a registered `InverseProblem` — a thin
adapter over `core.pipeline` (counterpart of `repro.problems.proxy1d`)."""
from __future__ import annotations

from ..core import pipeline
from . import InverseProblem, register


class Proxy1D(InverseProblem):
    name = "proxy1d"
    n_params = pipeline.N_PARAMS            # 6
    obs_dim = 2                             # (y0, y1)
    noise_channels = 2
    events_per_sample = pipeline.EVENTS_PER_SAMPLE

    def true_params(self, device=None):
        return pipeline.true_params(device)

    def sample_events(self, params, u):
        return pipeline.sample_events(params, u)


register(Proxy1D())
