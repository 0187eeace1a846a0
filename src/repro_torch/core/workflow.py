"""Inference-time solving: invert a generator stack against observations.

Counterpart of the solve half of `repro.core.workflow` (`SolveConfig`,
`make_solver`, lines 209–306).  Each of the R stacked generators proposes
`n_candidates` parameter draws, each candidate is pushed through the
problem's forward model for `events_per_candidate` events, and candidates
are scored by how well their simulated event moments match the masked
moments of the submitted observations.  The estimate is the mean of the
best `top_frac` fraction of candidates.

The random draws (generator noise and sampler uniforms) are made once by
`solve_draws` and handed to `make_solver`, so the serving layer makes them
when it builds an executable and a test can hand in the JAX package's
draws instead.  The sampler route is not an option: it follows the
tensors' device (`kernels.inverse_cdf`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import gan


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """How a trained generator stack is inverted against a submitted
    observation batch.  `top_frac=1.0` degenerates to the unweighted
    ensemble prior mean, independent of the observations."""
    n_candidates: int = 128        # candidate draws PER generator rank
    events_per_candidate: int = 64
    top_frac: float = 0.25         # fraction of candidates kept (0, 1]
    seed: int = 0                  # solve is deterministic per config

    def __post_init__(self):
        if self.n_candidates < 1 or self.events_per_candidate < 1:
            raise ValueError(
                f"need n_candidates >= 1 and events_per_candidate >= 1, got "
                f"{self.n_candidates} / {self.events_per_candidate}")
        if not (0.0 < self.top_frac <= 1.0):
            raise ValueError(
                f"top_frac must be in (0, 1], got {self.top_frac}")


Draws = Tuple[torch.Tensor, torch.Tensor]


def solve_draws(cfg: SolveConfig, R: int, problem, device) -> Draws:
    """The solve's random draws for an R-rank stack, seeded by `cfg.seed`:
    noise [R, M, NOISE_DIM] standard normal and u [R·M, E, C] uniform.

    They are drawn by a CPU `torch.Generator` and moved to `device`, so
    one seed gives the same draws on every device.  (They are not the JAX
    package's draws: `jax.random` streams differ.)"""
    M, E = cfg.n_candidates, cfg.events_per_candidate
    g = torch.Generator(device="cpu").manual_seed(cfg.seed)
    noise = torch.randn((R, M, gan.NOISE_DIM), generator=g)
    u = torch.rand((R * M, E, problem.noise_channels), generator=g)
    return noise.to(device), u.to(device)


def _moments(events, w):
    """Masked per-dim mean/std of events [..., N, obs] with weights
    [..., N] -> [..., 2·obs] (population std, as `jnp` computes it)."""
    n = torch.clamp(w.sum(-1), min=1.0)[..., None]
    wt = w[..., None]
    mean = (events * wt).sum(-2) / n
    var = (((events - mean[..., None, :]) ** 2) * wt).sum(-2) / n
    return torch.cat([mean, torch.sqrt(var + 1e-12)], dim=-1)


class Solver:
    """`solve(gen_stack, ys, mask) -> {"params", "sigma", "score"}`:

      gen_stack   stacked generator `[R, ...]` (`core.gan` layout)
      ys          `[B, bucket, obs_dim]` padded observation batches
      mask        `[B, bucket]` bool, True on real event rows
      params      `[B, n_params]` posterior estimate per request
      sigma       `[B, n_params]` population std of the kept candidates
      score       `[B]` mean moment-match score of the kept candidates
                  (higher is better; 0 is a perfect moment match)

    Candidates and their simulated events depend only on the stack and
    the draws, so one call computes them once for all B requests.  The
    kept set is a `torch.topk`; the outputs are means over it, so the
    order of ties does not matter.
    """

    def __init__(self, problem, cfg: SolveConfig, draws: Draws):
        self.problem = problem
        self.cfg = cfg
        self.noise, self.u = draws

    def keep(self, R: int) -> int:
        """Candidates kept per request, with Python's rounding (as the JAX
        solver, `workflow.py:297`)."""
        return max(1, int(round(self.cfg.top_frac * R * self.cfg.n_candidates)))

    def scores(self, gen_stack, ys, mask):
        """(candidates [R·M, n_params], scores [B, R·M])."""
        R, M = self.noise.shape[:2]
        E = self.cfg.events_per_candidate
        cands = gan.generate_params(gen_stack, self.noise).reshape(R * M, -1)
        events = self.problem.sample_events(cands, self.u).reshape(R * M, E, -1)
        cand_mom = _moments(events, torch.ones(events.shape[:2],
                                               dtype=events.dtype,
                                               device=events.device))
        # scale-free scoring: normalize each moment dim by its spread
        # across candidates so no observable dominates the distance
        scale = cand_mom.std(dim=0, correction=0) + 1e-6
        y_mom = _moments(ys, mask.to(ys.dtype))                  # [B, 2·obs]
        d = (cand_mom[None, :, :] - y_mom[:, None, :]) / scale
        return cands, -(d * d).mean(dim=-1)

    def __call__(self, gen_stack, ys, mask):
        cands, scores = self.scores(gen_stack, ys, mask)
        top_scores, top_idx = torch.topk(scores, self.keep(self.noise.shape[0]),
                                         dim=1)
        kept = cands[top_idx]                                    # [B, k, n]
        return {
            "params": kept.mean(dim=1),
            "sigma": kept.std(dim=1, correction=0),
            "score": top_scores.mean(dim=1),
        }


def make_solver(problem, cfg: SolveConfig, draws: Draws) -> Solver:
    """Build the solve function for `problem` over fixed `draws` (from
    `solve_draws`, on the device the solve runs on)."""
    return Solver(problem, cfg, draws)
