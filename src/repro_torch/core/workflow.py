"""The SAGIPS workflow — counterpart of `repro.core.workflow`.

Two halves:

* the solve (`SolveConfig`, `make_solver`, JAX lines 209–306): a trained
  generator stack inverted against observations.  Each of the R stacked
  generators proposes `n_candidates` parameter draws, each candidate is
  pushed through the problem's forward model for `events_per_candidate`
  events, and candidates are scored by how well their simulated event
  moments match the masked moments of the submitted observations; the
  estimate is the mean of the best `top_frac` fraction.  The random draws
  are made once by `solve_draws` and handed to `make_solver`.

* the GAN training loop of the paper (`WorkflowConfig`, `train_stacked`,
  JAX lines 66–201 and 313–737), R = n_outer · n_inner simulated ranks
  stacked on one device.  Each epoch, every rank (§IV-B)
    1. bootstraps a batch from its share of the reference data,
    2. runs its generator and the forward model to make synthetic events,
    3. updates its own discriminator (never synchronized),
    4. takes generator gradients through the forward model and the
       discriminator from before step 3,
    5. exchanges the generator's weight gradients as the `SyncConfig`
       mode says (`core.sync`),
    6. applies its Adam update.
  The fake events of steps 3 and 4 are computed once an epoch (the JAX
  package samples twice with one key, so both see the same events): step
  3 reads them detached, step 4 backpropagates through them, so each
  kernel of the forward model (B1 for the flat problems; B1 on the
  readout noise and B2 or B3 for the imaging ones) runs forward once an
  epoch, and backward once where the gradient reaches it.  An
  image-valued problem trains the conv generator (`models.convgen`).

`train_proc` runs the same loop with each rank a worker process of its
own (`runtime.launch`), the exchange crossing mmap mailboxes.

The epoch's random draws (`make_draws`: generator noise, sampler
uniforms, bootstrap indices) come from one `torch.Generator` on the run's
device; `make_epoch_fn` takes them from the caller instead, which is how
the tests hand in the JAX package's draws.  The sampler route is not an
option: it follows the tensors' device (`kernels.inverse_cdf`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..models import convgen
from ..optim import adam
from . import gan, pipeline, sync as sync_lib
from .ring import VmapComm
from .tree import tree_from_paths, tree_leaves, tree_map, tree_unflatten


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


# ----------------------------------------------------------------------------
# the GAN training loop


@dataclasses.dataclass(frozen=True)
class WorkflowConfig:
    """The training loop's settings, as `repro.core.workflow.WorkflowConfig`
    (line 66) has them.  There is no `sampler_impl`: the device picks the
    sampler's route.  Update cadences other than every epoch (queue A
    item 3c) and the telemetry channel (`obs`) raise: ROADMAP.md queue A
    item 3."""
    sync: sync_lib.SyncConfig = sync_lib.SyncConfig()
    n_param_samples: int = pipeline.PARAM_SAMPLES       # Tab. III
    events_per_sample: int = pipeline.EVENTS_PER_SAMPLE
    data_fraction: float = 0.5                          # §VI-C2
    gen_lr: float = 1e-5                                # §V-A
    disc_lr: float = 1e-4
    problem: str = "proxy1d"                            # registry key
    disc_every: int = 1
    gen_every: int = 1
    disc_compute: str = "fp32"     # discriminator forward: 'fp32' | 'bf16'
    obs: bool = False              # the JAX package's metrics channel

    def __post_init__(self):
        if self.disc_every < 1 or self.gen_every < 1:
            raise ValueError(
                "disc_every/gen_every are update cadences (update when "
                f"epoch %% N == 0) and must be >= 1; got "
                f"disc_every={self.disc_every}, gen_every={self.gen_every}")
        if self.disc_compute not in gan.DISC_COMPUTE:
            raise ValueError(
                f"disc_compute must be one of {gan.DISC_COMPUTE}, got "
                f"{self.disc_compute!r}")
        if self.disc_every != 1 or self.gen_every != 1:
            raise NotImplementedError(
                f"update cadences disc_every={self.disc_every}, gen_every="
                f"{self.gen_every} are not ported yet: ROADMAP.md queue A "
                f"item 3c (the schedule layer's update cadences)")
        if self.obs:
            raise NotImplementedError(
                f"the telemetry channel (obs) is not ported yet: "
                f"{sync_lib.SCHEDULE_ITEM}")

    @property
    def disc_batch(self) -> int:
        return self.n_param_samples * self.events_per_sample

    @property
    def problem_obj(self):
        from ..problems import get_problem
        return get_problem(self.problem)


def _gen_example(wcfg: WorkflowConfig):
    """The per-rank generator's shapes ("meta" tensors, nothing drawn):
    the conv generator's for an image-valued problem, else the MLP's."""
    prob = wcfg.problem_obj
    if prob.param_shape is not None:
        shapes = convgen.leaf_shapes(prob.param_shape, gan.NOISE_DIM)
        return tree_from_paths({k: torch.empty(shape, device="meta")
                                for k, shape in shapes.items()})
    widths = gan.gen_widths(prob.n_params)
    return [{"w": torch.empty((a, b), device="meta"),
             "b": torch.empty((b,), device="meta")}
            for a, b in zip(widths[:-1], widths[1:])]


def make_schedule(wcfg: WorkflowConfig) -> sync_lib.SyncSchedule:
    """The configured `SyncSchedule`: weight mask and FusionSpec built once
    from the problem's generator shapes."""
    example = _gen_example(wcfg)
    mask = gan.weight_mask(example)
    spec = sync_lib.FusionSpec.build(
        example, mask,
        payload_dtype=sync_lib.payload_dtype_of(wcfg.sync.payload_precision),
        chunk_bytes=wcfg.sync.ring_chunking)
    return sync_lib.make_schedule(wcfg.sync, mask, spec)


def init_rank_state(generator: torch.Generator, wcfg: WorkflowConfig,
                    schedule=None, device=None):
    """The state of ONE rank (no leading rank axis): generator (the conv
    generator for an image-valued problem) and discriminator
    (Kaiming-normal from `generator`, in that order), their Adam states,
    the schedule's SyncState and the epoch counter."""
    prob = wcfg.problem_obj
    dev = resolve_device(device)
    gen_p = gan.init_generator(generator, n_params=prob.n_params, device=dev,
                               param_shape=prob.param_shape)
    disc_p = gan.init_discriminator(generator, obs_dim=prob.obs_dim,
                                    device=dev)
    schedule = make_schedule(wcfg) if schedule is None else schedule
    return {
        "gen": gen_p, "disc": disc_p,
        "gen_opt": adam(wcfg.gen_lr).init(gen_p),
        "disc_opt": adam(wcfg.disc_lr).init(disc_p),
        "sync": schedule.init_state(None, dev),
        "epoch": torch.zeros((), dtype=torch.int32, device=dev),
    }


def init_state(generator: torch.Generator, n_ranks: int,
               wcfg: WorkflowConfig, same_generator=True, device=None):
    """Stacked state [R, ...] of `n_ranks` ranks, drawn rank after rank.
    Generators start as copies of rank 0's (the paper sends "initial
    copies of the generator weights to each rank"); discriminators are
    independent."""
    schedule = make_schedule(wcfg)
    states = [init_rank_state(generator, wcfg, schedule, device)
              for _ in range(n_ranks)]
    if same_generator:
        for s in states[1:]:
            s["gen"] = states[0]["gen"]
    return tree_map(lambda *xs: torch.stack(xs), *states)


def rank_rows(tree, rank: int):
    """Rank `rank`'s rows of a stacked tree, each leaf [1, ...] and a
    fresh contiguous copy: a proc worker's tensors own their storage, as
    those of its in-process reference do (`runtime.launch
    .lockstep_reference`)."""
    return tree_map(lambda x: x[rank:rank + 1].clone(), tree)


def init_run(generator: torch.Generator, n_ranks: int, wcfg: WorkflowConfig,
             data, device=None, rank: Optional[int] = None):
    """(stacked initial state, per-rank data [R, n_sub, obs]): each rank
    keeps a random `data_fraction` of the reference data (§VI-C2), a
    permutation drawn from `generator` after the state's weights.

    An int `rank` returns that rank's state and data with a leading [1]
    (`rank_rows`), bitwise the rows of the stacked result, and leaves
    `generator` where the stacked call leaves it.  Every rank is drawn
    from the one generator in stacked order, so a rank cannot derive its
    own draws as the JAX package's key split does (`init_run`, lines
    166–178): the stacked result is built and its rows kept, O(R) work in
    each proc worker."""
    dev = resolve_device(device)
    state = init_state(generator, n_ranks, wcfg, device=dev)
    n_sub = max(1, int(wcfg.data_fraction * data.shape[0]))
    data = data.to(dev)
    split = torch.stack([
        data[torch.randperm(data.shape[0], generator=generator,
                            device=generator.device).to(dev)[:n_sub]]
        for _ in range(n_ranks)])
    if rank is None:
        return state, split
    return rank_rows(state, rank), rank_rows(split, rank)


EpochDraws = Dict[str, torch.Tensor]


def make_draws(generator: torch.Generator, wcfg: WorkflowConfig,
               n_ranks: int, n_sub: int) -> EpochDraws:
    """One epoch's draws for R ranks, from `generator` on its own device:
    noise [R, K, NOISE_DIM] standard normal, u [R, K, E, C] uniform and
    the bootstrap's indices idx [R, K·E] into each rank's n_sub events
    (with replacement, §IV-B).  The JAX package draws the same
    distributions from each rank's key (`workflow.py:336`, `:315` and
    `problems/__init__.py:121–125`).  A proc worker draws all R ranks'
    and keeps its rows (`rank_rows`): at `PAPER` ~17 MB an epoch, made on
    the card."""
    K, E = wcfg.n_param_samples, wcfg.events_per_sample
    dev = generator.device
    return {
        "noise": torch.randn((n_ranks, K, gan.NOISE_DIM), generator=generator,
                             device=dev),
        "u": torch.rand((n_ranks, K, E, wcfg.problem_obj.noise_channels),
                        generator=generator, device=dev),
        "idx": torch.randint(0, n_sub, (n_ranks, wcfg.disc_batch),
                             generator=generator, device=dev),
    }


def _bootstrap(idx, data_per_rank):
    """Rank r's rows idx[r] of its data: [R, n_draw, obs]."""
    ranks = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return data_per_rank[ranks, idx]


def _grad(loss, tree):
    """d(loss)/d(leaves of `tree`), in `tree`'s structure."""
    return tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))


def rank_grads(state, data_per_rank, draws: EpochDraws,
               wcfg: WorkflowConfig):
    """Steps 1–4 for every rank at once.  Returns (partial_state,
    gen_grads, metrics), as `repro.core.workflow.rank_grads` (:319–387)
    under `jax.vmap`; metrics hold d_loss and g_loss [R] and the mean
    predicted parameters and their residuals [R, n_params].

    Each loss is a mean over its rank's events, and rank r's loss depends
    on rank r's parameters alone, so the gradient of the sum over ranks
    is every rank's own gradient."""
    from ..problems import synthetic_events
    prob = wcfg.problem_obj
    cdt = gan.compute_dtype_of(wcfg.disc_compute)
    real = _bootstrap(draws["idx"], data_per_rank)
    with torch.enable_grad():
        gen = tree_map(lambda t: t.detach().requires_grad_(), state["gen"])
        disc = tree_map(lambda t: t.detach().requires_grad_(), state["disc"])
        fake, pred = synthetic_events(prob, gen, draws["noise"], draws["u"])
        # the discriminator's step sees the fake events as data ...
        d_loss = gan.disc_loss(disc, real, fake.detach(), cdt)
        d_grads = _grad(d_loss.sum(), disc)
        # ... and the generator's objective reads the discriminator from
        # before that step, differentiated for the generator's leaves only
        g_loss = gan.gen_loss(state["disc"], fake, cdt)
        g_grads = _grad(g_loss.sum(), gen)
    with torch.no_grad():
        d_upd, disc_opt = adam(wcfg.disc_lr).update(d_grads,
                                                    state["disc_opt"])
        new_disc = tree_map(lambda p, u: p + u, state["disc"], d_upd)
        pred_mean = pred.detach().mean(1)
    metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
               "pred_params": pred_mean,
               "residuals": prob.residuals(pred_mean)}
    return dict(state, disc=new_disc, disc_opt=disc_opt), g_grads, metrics


@torch.no_grad()
def rank_apply(state, synced_grads, new_sync, wcfg: WorkflowConfig):
    """Steps 5–6: apply the synchronized generator update (:390–396)."""
    g_upd, gen_opt = adam(wcfg.gen_lr).update(synced_grads, state["gen_opt"])
    gen = tree_map(lambda p, u: p + u, state["gen"], g_upd)
    return dict(state, gen=gen, gen_opt=gen_opt, sync=new_sync,
                epoch=state["epoch"] + 1)


def make_epoch_fn(n_outer: int, n_inner: int, wcfg: WorkflowConfig):
    """One stacked epoch, `fn(state, data_per_rank, draws) -> (state,
    metrics)` (the JAX `_epoch_body_vmap` at cadence 1, :446–494).  The
    exchange's epoch is the device's own counter, so nothing is read
    back to the host."""
    comm = VmapComm(n_outer, n_inner)
    schedule = make_schedule(wcfg)

    def epoch(state, data_per_rank, draws: EpochDraws):
        new_state, g_grads, metrics = rank_grads(state, data_per_rank,
                                                 draws, wcfg)
        synced, new_sync = schedule.exchange(comm, g_grads,
                                             new_state["sync"],
                                             new_state["epoch"][0])
        return rank_apply(new_state, synced, new_sync, wcfg), metrics
    return epoch


def chunk_schedule(n_epochs: int, chunk: int):
    """Yield (start_epoch, n) per chunk covering [0, n_epochs)."""
    e = 0
    while e < n_epochs:
        n = min(chunk, n_epochs - e)
        yield e, n
        e += n


def train_stacked(seed: int, wcfg: WorkflowConfig, n_outer: int,
                  n_inner: int, n_epochs: int, data,
                  checkpoint_every: int = 0, chunk: int = 0,
                  checkpoint_dir: Optional[str] = None, resume: bool = False,
                  device=None, on_epoch: Optional[Callable] = None):
    """R = n_outer·n_inner simulated ranks trained on one device, the
    counterpart of `repro.core.workflow.train_vmap` (:645–737).

    `data` [N, obs_dim] is the reference set; `init_run` gives each rank
    its share.  Everything random comes from one `torch.Generator` on the
    run's device, seeded by `seed`: the initial state, the data split and
    every epoch's draws (`make_draws`).  Returns (final_state, history):
    history maps each metric to [T, R, ...], recorded at the epochs with
    `e % checkpoint_every == 0` and at the last one (always recorded, so
    the history is never empty).  Nothing is read back to the host inside
    the loop: the history stays on the device.

    Epochs run in chunks of `chunk` (default `checkpoint_every`, else
    min(n_epochs, 64)); `checkpoint_dir` saves the full state, with the
    generator's state under "rng", at each chunk boundary on the
    `checkpoint_every` cadence and at the end, and `resume=True` restores
    the newest step and continues from it: a resume from a chunk-aligned
    step is bitwise the uninterrupted run.  `on_epoch(e, metrics)` is
    called after each epoch's work is enqueued."""
    from ..checkpoint.store import restore_latest, save_checkpoint
    dev = resolve_device(device)
    R = n_outer * n_inner
    generator = torch.Generator(device=dev).manual_seed(seed)
    state, data_per_rank = init_run(generator, R, wcfg, data, dev)
    n_sub = data_per_rank.shape[1]
    epoch = make_epoch_fn(n_outer, n_inner, wcfg)

    if chunk <= 0:
        chunk = checkpoint_every if checkpoint_every > 0 \
            else min(n_epochs, 64)
    chunk = max(1, min(chunk, n_epochs))

    start = 0
    if checkpoint_dir and resume:
        restored, step = restore_latest(
            checkpoint_dir, dict(state, rng=generator.get_state()))
        if restored is not None:
            generator.set_state(restored.pop("rng"))
            state, start = restored, step

    hist = []
    for e0, n in chunk_schedule(n_epochs, chunk):
        done = e0 + n
        if done <= start:          # chunk fully covered by the checkpoint
            continue
        for e in range(max(e0, start), done):
            state, metrics = epoch(state, data_per_rank,
                                   make_draws(generator, wcfg, R, n_sub))
            if on_epoch is not None:
                on_epoch(e, metrics)
            if (checkpoint_every and e % checkpoint_every == 0) \
                    or e == n_epochs - 1:
                hist.append(metrics)
        if checkpoint_dir and (done == n_epochs or (
                checkpoint_every and done % checkpoint_every == 0)):
            save_checkpoint(checkpoint_dir, done,
                            dict(state, rng=generator.get_state()),
                            metadata={"epochs": done,
                                      "problem": wcfg.problem})
    history = tree_map(lambda *xs: torch.stack(xs), *hist) if hist else {}
    return state, history


def train_proc(seed: int, wcfg: WorkflowConfig, n_outer: int, n_inner: int,
               n_epochs: int, data, **kw):
    """R = n_outer·n_inner ranks as R worker processes on this host, the
    counterpart of `repro.core.workflow.train_proc` (:740–768): each
    worker holds one rank's state and runs its epochs, exchanging
    generator gradients through the mmap mailboxes of `runtime`
    (`ProcComm`) under the unchanged schedule layer.

    `seed` seeds what `train_stacked` seeds: every worker rebuilds the
    stacked initial state, data split and epoch draws from it and keeps
    its own rows.  Keyword args pass through to `runtime.launch.run_proc`:
    `device` (None: CUDA), `lockstep` (default True: a zero-jitter run is
    bitwise `runtime.launch.lockstep_reference`), `jitter` (a
    `runtime.JitterConfig`; implies free-running), `ckpt_every`/`resume`
    (per-process checkpoints), `run_dir`, `timeout`.

    Returns (state, history): `state` is the workers' final states stacked
    into the `[R, ...]` layout, `history` maps each metric to `[T, R,
    ...]` over every epoch run.  Use `run_proc` itself for the per-worker
    summaries (devices, wall times, kernel counts)."""
    from ..runtime.launch import run_proc
    if kw.get("jitter") is not None and "lockstep" not in kw:
        kw["lockstep"] = False         # jitter only bites when free-running
    out = run_proc(wcfg, n_outer, n_inner, n_epochs, data, seed=seed, **kw)
    return out["state"], out["history"]
