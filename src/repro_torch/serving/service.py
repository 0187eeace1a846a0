"""The batched solve service — SAGIPS inference as a request surface.

Counterpart of `repro.serving.service`.  Request lifecycle:

    client.submit(problem, y)
        -> bucket_for(n_events)        smallest admitting bucket, or
                                       RequestTooLarge
        -> pad_events                  zero-pad + mask
        -> BoundedRequestQueue.submit  admitted, or Backpressure
                                       (retry-after, never blocks)
    drainer.step()
        -> queue.next_key / drain      oldest-head lane, FIFO batch
        -> CompileCache.get            warm per-(problem, bucket) solver
                                       (LRU; a miss builds one)
        -> solve(gen_stack, ys, mask)  `core.workflow.make_solver` output
        -> Ticket.resolve              client unblocks with params/sigma

The service runs on one device (`device=`, CUDA unless the caller asks for
the CPU).  The generator stack, the solve draws and every batch live
there; on CUDA the forward model's kernels are the hand-written ones.

A generator stack comes in either layout of `core.gan`: the MLP (a list,
checked against `gen_widths`) or, for a problem with an image-valued
`param_shape`, the conv generator (a dict, checked leaf by leaf against
`models.convgen.leaf_shapes`).  As in the JAX package, the checkpoint
route restores the MLP only; a conv stack is registered with `gen_stack=`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.store import load_generator_stack
from ..core import gan
from ..core.workflow import SolveConfig, make_solver, solve_draws
from ..models import convgen
from ..obs.counters import Counters
from ..problems import get_problem
from .bucketing import bucket_for, pad_events, validate_buckets
from .cache import CompileCache
from .queue import BoundedRequestQueue


class ServingError(RuntimeError):
    """Service-level failure with a client-actionable message (unknown
    problem, missing checkpoint, ...) — never a raw stack trace."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the serving surface:

    buckets         event-count ladder; a request pads up to the smallest
                    admitting bucket (one warm solver per (problem, bucket))
    max_batch       requests fused per drain; the batch axis is padded to
                    exactly this, so B never changes the shapes
    queue_capacity  global admission bound; a full queue REJECTS
                    (`Backpressure` with `retry_after_s`), never blocks
    cache_capacity  warm solvers kept (LRU over (problem, bucket))
    solve           what each solver computes (`core.workflow.SolveConfig`)
    """
    buckets: Tuple[int, ...] = (64, 256, 1024)
    max_batch: int = 8
    queue_capacity: int = 64
    cache_capacity: int = 8
    retry_after_s: float = 0.05
    solve: SolveConfig = SolveConfig()

    def __post_init__(self):
        validate_buckets(self.buckets)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")


class Ticket:
    """A submitted request's handle: `result(timeout)` blocks until the
    drainer resolves it, then returns {params, sigma, score} (numpy)."""

    def __init__(self, problem: str, bucket: int, n_events: int):
        self.problem = problem
        self.bucket = bucket
        self.n_events = n_events
        self.t_submit = time.perf_counter()   # queue-inclusive latency base
        self._done = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def resolve(self, result: dict):
        self._result = result
        self._done.set()

    def fail(self, exc: BaseException):
        self._error = exc
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"solve request ({self.problem}, bucket {self.bucket}) "
                f"not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


def _train_hint(problem, checkpoint_dir) -> str:
    return (f"Train one with the port: python -m repro_torch.launch.train_gan "
            f"--problem {problem.name} --checkpoint-dir {checkpoint_dir}, or "
            f"with the JAX package: examples/train_sagips_gan.py --problem "
            f"{problem.name} --checkpoint-dir {checkpoint_dir}")


def _check_stack(name, problem, gen_stack):
    """Raise `ServingError` unless `gen_stack` is an [R, ...] stack of a
    generator that `problem` can be served with."""
    if isinstance(gen_stack, dict):
        if problem.param_shape is None:
            raise ServingError(
                f"{name!r} has a flat parameter vector and is served by the "
                f"MLP generator; got a conv generator stack")
        want = convgen.leaf_shapes(problem.param_shape, gan.NOISE_DIM)
        got = {k: tuple(v.shape[1:])
               for k, v in convgen.flatten(gen_stack).items()}
        if got != want:
            widths = convgen.conv_gen_widths(problem.param_shape,
                                             gan.NOISE_DIM)
            raise ServingError(
                f"conv generator leaves {got} do not make {name!r}'s "
                f"param_shape {problem.param_shape}: expected {want} (layer "
                f"widths {widths})")
    else:
        widths = (gen_stack[0]["w"].shape[-2], gen_stack[-1]["w"].shape[-1])
        if widths != (gan.NOISE_DIM, problem.n_params):
            raise ServingError(
                f"generator maps {widths[0]} -> {widths[1]}, but {name!r} "
                f"needs {gan.NOISE_DIM} -> {problem.n_params}")
    ranks = {t.shape[0] for t in gan.leaves(gen_stack)}
    if len(ranks) != 1:
        raise ServingError(f"generator leaves disagree on the rank axis: "
                           f"{sorted(ranks)}")


class SolveService:
    """Batched solve server over registered `InverseProblem`s.

    Thread model: any number of submitter threads call `submit`; ONE
    drainer thread calls `step` in a loop (`run_until_empty`).  The queue
    and cache are themselves thread-safe.
    """

    def __init__(self, cfg: ServingConfig = ServingConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.counters = Counters()     # the queue records admit/reject
        #                                into it; `step` records per-bucket
        #                                latencies
        self.queue = BoundedRequestQueue(cfg.queue_capacity,
                                         cfg.retry_after_s,
                                         counters=self.counters)
        self.cache = CompileCache(cfg.cache_capacity)
        self._problems: Dict[str, tuple] = {}   # name -> (problem, gen_stack)
        self.served = 0

    # -- registration --------------------------------------------------------

    def register_problem(self, name: str, checkpoint_dir: Optional[str] = None,
                         gen_stack=None, step: Optional[int] = None):
        """Make `name` servable.  Provide a trained generator stack either
        directly (`gen_stack`, an `[R, ...]` stack in either `core.gan`
        layout) or via `checkpoint_dir` (the newest step of the JAX
        package's store; the MLP only, as in the JAX service)."""
        try:
            problem = get_problem(name)
        except KeyError as e:
            raise ServingError(str(e)) from None
        if gen_stack is None:
            if checkpoint_dir is None:
                raise ServingError(
                    f"registering {name!r} needs a trained generator: pass "
                    f"gen_stack or checkpoint_dir")
            try:
                gen_stack, step = load_generator_stack(checkpoint_dir,
                                                       self.device)
            except (KeyError, ValueError, OSError) as e:
                raise ServingError(
                    f"checkpoint store at {checkpoint_dir!r} is unusable for "
                    f"problem {name!r}: {e}.  "
                    f"{_train_hint(problem, checkpoint_dir)}") from None
            if gen_stack is None:
                raise ServingError(
                    f"no trained generator checkpoint for problem {name!r} "
                    f"under {checkpoint_dir!r}.  "
                    f"{_train_hint(problem, checkpoint_dir)}")
        try:
            gen_stack = gan.map_leaves(
                lambda t: t.to(self.device, torch.float32), gen_stack)
        except (KeyError, AttributeError, TypeError) as e:
            raise ServingError(
                f"gen_stack for {name!r} is neither an MLP (a list of "
                f"{{'w', 'b'}} layers) nor a conv generator ({{'proj', "
                f"'convs'}}): {type(e).__name__}: {e}") from None
        _check_stack(name, problem, gen_stack)
        self._problems[name] = (problem, gen_stack)
        return step

    def problems(self):
        return tuple(sorted(self._problems))

    # -- client side ---------------------------------------------------------

    def submit(self, problem_name: str, y) -> Ticket:
        """Submit observations `y` [n_events, obs_dim] for `problem_name`.

        Raises `ServingError` (unknown/unregistered problem, wrong obs
        dim), `RequestTooLarge` (n_events above the bucket ladder) or
        `Backpressure` (queue full — retry after `.retry_after_s`).
        Returns a `Ticket`; block on `.result()` for the solve."""
        if problem_name not in self._problems:
            raise ServingError(
                f"problem {problem_name!r} is not registered with this "
                f"service (registered: {list(self.problems())}); call "
                f"register_problem first")
        problem, _ = self._problems[problem_name]
        y = np.asarray(y, dtype=np.float32)
        if y.ndim != 2 or y.shape[1] != problem.obs_dim:
            raise ServingError(
                f"{problem_name!r} observations must be [n_events, "
                f"{problem.obs_dim}], got shape {y.shape}")
        bucket = bucket_for(y.shape[0], self.cfg.buckets)
        padded, mask = pad_events(y, bucket)
        ticket = Ticket(problem_name, bucket, y.shape[0])
        self.queue.submit((problem_name, bucket), (padded, mask, ticket))
        return ticket

    # -- server side ---------------------------------------------------------

    def _executable(self, problem_name: str, bucket: int):
        """The warm per-(problem, bucket) solver, built on a miss.

        The builder makes the solve draws on the device and runs one dummy
        batch, so the kernels are built and launched before the first
        request, and a hit costs the solve only."""
        problem, gen_stack = self._problems[problem_name]

        def builder():
            R = next(gan.leaves(gen_stack)).shape[0]
            fn = make_solver(problem, self.cfg.solve,
                             solve_draws(self.cfg.solve, R, problem,
                                         self.device))
            B = self.cfg.max_batch
            fn(gen_stack,
               torch.zeros((B, bucket, problem.obs_dim), device=self.device),
               torch.zeros((B, bucket), dtype=torch.bool, device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return fn

        return self.cache.get((problem_name, bucket), builder)

    def warm(self, problem_name: str, buckets: Optional[Tuple[int, ...]] = None):
        """Build solvers for `problem_name` (default: the whole ladder), so
        the first client request hits a warm pool."""
        for b in (buckets or self.cfg.buckets):
            self._executable(problem_name, b)

    def step(self) -> int:
        """Drain and serve ONE batch.  Returns the number of requests
        served (0 = queue empty)."""
        key = self.queue.next_key()
        if key is None:
            return 0
        items = self.queue.drain(key, self.cfg.max_batch)
        if not items:
            return 0
        problem_name, bucket = key
        B = self.cfg.max_batch
        tickets = [t for (_, _, t) in items]
        try:
            fn = self._executable(problem_name, bucket)
            problem, gen_stack = self._problems[problem_name]
            ys = np.zeros((B, bucket, problem.obs_dim), np.float32)
            mask = np.zeros((B, bucket), bool)   # padding rows: all-False
            for i, (py, pm, _) in enumerate(items):
                ys[i], mask[i] = py, pm
            out = fn(gen_stack, torch.from_numpy(ys).to(self.device),
                     torch.from_numpy(mask).to(self.device))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            now = time.perf_counter()
            for i, t in enumerate(tickets):
                t.resolve({k: v[i] for k, v in out.items()})
                # queue-inclusive request latency, bucketed per lane
                self.counters.observe(f"{problem_name}/b{bucket}",
                                      now - t.t_submit)
        except Exception as e:       # noqa: BLE001 — tickets must unblock
            for t in tickets:
                t.fail(e)
            raise
        self.served += len(tickets)
        return len(tickets)

    def run_until_empty(self) -> int:
        """Drain everything queued; returns total requests served."""
        total = 0
        while True:
            n = self.step()
            if n == 0 and len(self.queue) == 0:
                return total
            total += n

    def stats(self) -> dict:
        return {
            "served": self.served,
            "queued": len(self.queue),
            "queue": dict(self.queue.stats),
            "cache": dict(self.cache.stats),
            "warm": self.cache.keys(),
        }

    def snapshot(self) -> dict:
        """`stats()` plus derived serving counters: queue depth,
        reject/retry-after rate, warm-cache hit ratio and the
        per-(problem, bucket) queue-inclusive latency histograms (what
        `launch/serve.py --stats` prints)."""
        s = self.stats()
        q, c = s["queue"], s["cache"]
        submits = q["admitted"] + q["rejected"]
        lookups = c["hits"] + c["misses"]
        obs = self.counters.snapshot()
        return dict(s, **{
            "queue_depth": s["queued"],
            "reject_rate": q["rejected"] / submits if submits else 0.0,
            "retry_after_s": self.cfg.retry_after_s,
            "cache_hit_rate": c["hits"] / lookups if lookups else 0.0,
            "counters": obs["counters"],
            "latency": obs["latency"],
        })
