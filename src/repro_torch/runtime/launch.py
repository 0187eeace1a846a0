"""Multi-process launcher and worker of the proc runtime — the counterpart
of `repro.runtime.launch`.

`run_proc` (parent side) spawns R = n_outer · n_inner fresh interpreters
running this module (`python -m repro_torch.runtime.launch --worker
--rank r --run-dir d`), each of which

  1. builds the stacked initial state and data split of `train_stacked`
     from the run seed and keeps its own rows (`workflow.init_run(...,
     rank=r)`), so every rank starts where the stacked run starts,
  2. runs its epochs: the jitter sleep, the epoch's stacked draws
     (`workflow.make_draws`) cut to its rows, `rank_grads` on its [1]
     state with the halves due at that epoch (`workflow.due`), the
     schedule's exchange over `ProcComm` and `rank_apply` when the
     generator is due (else only the epoch counter advances, and no
     transfer is made: every rank skips the same epochs, so the lock-step
     pairing stays aligned), and a `torch.cuda.synchronize()` before the
     epoch's host time is taken,
  3. checkpoints its own state, with its generator's state under "rng",
     every `ckpt_every` epochs under `<run_dir>/ckpt/rank_<r>`,
  4. saves its final state under `<run_dir>/final/rank_<r>` and a JSON
     summary (history, device, start-up and wall times, peak memory, the
     GAN kernels' counts) for the parent to aggregate.

Telemetry (`wcfg.obs`, the JAX worker's :309–323 and :370–458): with
`trace_dir` each worker installs an `obs.trace.Tracer` writing
`trace_rank<r>.jsonl` (a relative dir lands under the run directory),
and its epoch records the spans `epoch`, `compute.grads`, `exchange` and
`compute.apply` around the mailbox, jitter and `ProcComm` spans beneath;
on the card `compute.grads` then ends in a `torch.cuda.synchronize()`,
so the span covers the compute and not its dispatch.  With `metrics` the
exchange is `exchange_with_obs`, the state carries the obs tree, the
history keeps `deposit_age` and `shipped` (the tracer gets the
`deposit_age` counter) and the summary an "obs" entry (payload_bytes,
ship_count, exchange_count, max_deposit_age).  Under the adaptive
schedule the history also keeps each epoch's `skew_ema` and `k_eff`
(rank 0's copy of the controller, as the JAX worker reads it; the
tracer gets counters of those names), and every summary has
`max_skew_ema` and `max_k_eff` (0 and 1 when the schedule is not
adaptive).

The parent stacks the final states into the `[R, ...]` layout and the
histories into `[T, R, ...]`, so what reads a `train_stacked` result reads
this one.  `workflow.train_proc` wraps it for the training loop.

Where it differs from the JAX launcher: no `jax.distributed` and no
process group — the mailbox fabric and the file `Barrier` are all the
workers share.  `device=None` means CUDA; the runconfig carries the
device, the CPU thread count, the TF32 flags and cuDNN's deterministic
flag, so a worker computes as
its parent does.  A lock-step run on the CPU fixes the intra-op thread
count at `LOCKSTEP_CPU_THREADS` in the workers (`torch.set_num_threads`
and `MKL_NUM_THREADS`) and in `lockstep_reference` (`cpu_threads`, which
restores the caller's count): threaded MKL GEMMs are not reproducible
from run to run, so at another count a rank now and then differs from
its reference by an ulp (`scripts/proc_lockstep_repeat.py` counts it).
A lock-step run on the card restricts cuDNN to deterministic algorithms
(`torch.backends.cudnn.deterministic`) in the workers and in
`lockstep_reference` (`cudnn_deterministic`, which restores the
caller's flag): a backward algorithm that accumulates with atomics would
let the image problems' conv generator differ by an ulp from run to run.
On a CUDA run the parent builds the kernels before it spawns, so no
worker runs `nvcc`;
each worker opens its own CUDA context on the card (R contexts
time-slice it).  Workers are fresh interpreters, never forks.

A lock-step run with no jitter is bitwise `lockstep_reference`: the same
per-rank computation in one process, exchanged through `VmapComm`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

RUNCONFIG = "runconfig.json"
DATA_FILE = "data.npz"
# the kernels a GAN epoch may launch, as the summaries count them
GAN_KERNELS = ("inverse_cdf", "mask_apply", "blur2d")
# intra-op threads of a lock-step CPU run, workers and reference alike
LOCKSTEP_CPU_THREADS = 1


# ----------------------------------------------------------------------------
# config (de)serialization — workers rebuild WorkflowConfig from JSON


def wcfg_to_dict(wcfg) -> dict:
    return dataclasses.asdict(wcfg)


def wcfg_from_dict(d: dict):
    from ..core.sync import SyncConfig
    from ..core.workflow import WorkflowConfig
    from ..obs.config import ObsConfig
    d = dict(d)
    sync = SyncConfig(**d.pop("sync"))
    obs = ObsConfig(**d.pop("obs", {}))
    return WorkflowConfig(sync=sync, obs=obs, **d)


def _kernel_counts():
    from ..kernels.imaging import blur_counts, mask_counts
    from ..kernels.inverse_cdf import counts
    return dict(zip(GAN_KERNELS, (counts, mask_counts, blur_counts)))


def lockstep_threads(lockstep: bool, device) -> Optional[int]:
    """The fixed intra-op thread count of a run on `device`, or None
    where the run keeps the caller's: free-running and CUDA runs."""
    if lockstep and device.type == "cpu":
        return LOCKSTEP_CPU_THREADS
    return None


def lockstep_cudnn_deterministic(lockstep: bool, device) -> bool:
    """Whether a run on `device` restricts cuDNN to deterministic
    algorithms: lock-step CUDA runs do, the others keep the caller's."""
    return lockstep and device.type == "cuda"


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    """Inside, cuDNN picks deterministic algorithms when `on` (False:
    unchanged); the caller's flag is restored on the way out."""
    import torch
    old = torch.backends.cudnn.deterministic
    if on:
        torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@contextlib.contextmanager
def cpu_threads(n: Optional[int]):
    """Inside, torch computes at `n` intra-op threads (None: unchanged);
    the caller's count is restored on the way out."""
    import torch
    old = torch.get_num_threads()
    if n is not None:
        torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _rank_like(wcfg, device):
    """A one-rank state template [1, ...] on `device` (uninitialised: only
    its structure, shapes and dtypes are read)."""
    import torch

    from ..core import workflow
    from ..core.tree import tree_map
    one = workflow.init_rank_state(torch.Generator().manual_seed(0), wcfg,
                                   device="cpu")
    return tree_map(lambda t: torch.empty((1,) + tuple(t.shape),
                                          dtype=t.dtype, device=device), one)


# ----------------------------------------------------------------------------
# parent side


def run_proc(wcfg, n_outer: int, n_inner: int, n_epochs: int, data, *,
             seed: int = 0, run_dir: Optional[str] = None,
             lockstep: bool = True, jitter=None, ckpt_every: int = 0,
             resume: bool = False, timeout: float = 900.0, device=None):
    """Launch the multi-process run and aggregate the results.

    Returns a dict with `state` (the final states stacked into `[R, ...]`
    on the run's device), `history` (per-epoch d_loss, g_loss and epoch_s
    `[T, R]`, residuals and pred_params `[T, R, n_params]`, CPU tensors),
    `summaries` (the raw per-rank JSON), `counts` (each GAN kernel's
    (launches, plain calls, backward launches, backward plain) summed over
    the workers), `wall_s` (spawn to result), `startup_s` (spawn to the
    last worker through the run-start barrier) and `run_dir`.  `data` is
    the full reference set, as for `train_stacked`.  A caller-supplied
    `run_dir` keeps mailboxes, checkpoints and logs (needed for
    `resume=True`); the default is a temporary directory removed after
    aggregation.  A worker that fails makes the run raise with the
    workers' log tails."""
    import numpy as np
    import torch

    from .. import resolve_device
    from ..kernels import build

    if resume and not ckpt_every:
        raise ValueError(
            "resume=True needs ckpt_every > 0: resuming negotiates a "
            "common step from the per-rank ckpt/ directories, and "
            "silently retraining from epoch 0 would overwrite the very "
            "results the caller asked to continue from")
    dev = resolve_device(device)
    R = n_outer * n_inner
    cleanup = run_dir is None
    if run_dir is None:
        run_dir = tempfile.mkdtemp(prefix="sagips_proc_")
    os.makedirs(run_dir, exist_ok=True)
    _clear_comm_files(run_dir)
    np.savez(os.path.join(run_dir, DATA_FILE), data=data.cpu().numpy())

    like = _rank_like(wcfg, dev)
    # resume negotiation: every worker must restart from the SAME epoch,
    # so pick the newest step loadable by ALL ranks and pin it
    resume_step = None
    if resume:
        rng_like = torch.Generator(device=dev).get_state()
        resume_step = _common_resume_step(run_dir, dict(like, rng=rng_like),
                                          R, max_epoch=n_epochs)
    if dev.type == "cuda":          # one build for all workers
        build.build_all(("inverse_cdf", "imaging")
                        if wcfg.problem_obj.param_shape else ("inverse_cdf",))
    threads = lockstep_threads(lockstep, dev)
    cfg = {
        "wcfg": wcfg_to_dict(wcfg),
        "n_outer": n_outer, "n_inner": n_inner, "n_epochs": n_epochs,
        "seed": seed, "lockstep": lockstep,
        "jitter": jitter.to_dict() if jitter is not None else None,
        "ckpt_every": ckpt_every, "resume_step": resume_step,
        "timeout": timeout, "device": str(dev),
        "num_threads": threads or torch.get_num_threads(),
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "cudnn_deterministic": (
            lockstep_cudnn_deterministic(lockstep, dev)
            or torch.backends.cudnn.deterministic),
    }
    with open(os.path.join(run_dir, RUNCONFIG), "w") as f:
        json.dump(cfg, f, indent=1)

    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # the workers share the host's cores: an OpenMP thread that spins
    # while it waits starves the other workers (2 CPU workers on 8 cores
    # ran many times slower an epoch); the wait policy changes no result
    env.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    if threads is not None:        # MKL reads it when it starts
        env["MKL_NUM_THREADS"] = str(threads)

    t_spawn = time.time()
    procs, logs, failure = [], [], None
    try:
        for r in range(R):
            logs.append(os.path.join(run_dir, f"worker_{r}.log"))
            with open(logs[-1], "w") as lf:   # Popen dups the fd
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.runtime.launch",
                     "--worker", "--rank", str(r), "--run-dir", run_dir],
                    stdout=lf, stderr=subprocess.STDOUT, env=env))
        _wait_workers(procs, timeout)
    except RuntimeError as e:
        failure = e
    finally:
        _stop(procs)
    if failure is not None:
        raise RuntimeError(f"proc runtime failed: {failure}\n"
                           + _log_tails(logs))

    out = _aggregate(run_dir, like, R, n_epochs)
    out["wall_s"] = time.time() - t_spawn
    out["startup_s"] = max(s["t_start"] for s in out["summaries"]) - t_spawn
    if cleanup:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
        out["run_dir"] = None
    return out


def _wait_workers(procs, timeout: float):
    """Return when every worker exited 0; raise RuntimeError as soon as one
    exits otherwise, or at the timeout."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = {r: c for r, c in enumerate(codes) if c not in (None, 0)}
        if bad:
            raise RuntimeError(f"worker(s) exited nonzero (rank: code) {bad}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out after {timeout:.0f}s")
        time.sleep(0.05)


def _stop(procs):
    """Kill and reap every worker still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _log_tails(logs) -> str:
    tails = []
    for r, path in enumerate(logs):
        try:
            with open(path) as f:
                tails.append(f"--- worker {r} ---\n" + f.read()[-3000:])
        except OSError:
            pass
    return "\n".join(tails)


def _clear_comm_files(run_dir: str):
    """Mailboxes, boards and the barrier are launch-scoped (their sequence
    counters restart at 0 with every launch): stale ones from an earlier
    launch in a persistent run_dir would corrupt the lock-step pairing.
    Summaries, logs and final states are per-launch too.  Checkpoints
    survive: they are the resume contract."""
    import glob
    import shutil
    for pat in ("mbx_*.bin", "board_*.bin", "barrier.bin",
                "summary_rank*.json", "worker_*.log"):
        for p in glob.glob(os.path.join(run_dir, pat)):
            os.remove(p)
    shutil.rmtree(os.path.join(run_dir, "final"), ignore_errors=True)


def _common_resume_step(run_dir: str, like, R: int, max_epoch: int):
    """Newest checkpoint step, at most `max_epoch`, that EVERY rank can
    load into `like` (None: a fresh start).  A step some rank's copy of
    which a killed process left half-written is passed over with a
    warning; a structural mismatch raises."""
    import warnings

    from ..checkpoint.store import (CORRUPT_ERRORS, list_steps,
                                    restore_checkpoint)
    dirs = [os.path.join(run_dir, "ckpt", f"rank_{r}") for r in range(R)]
    step_sets = [set(s for s in list_steps(d) if s <= max_epoch)
                 for d in dirs]
    if not all(step_sets):
        return None
    for s in sorted(set.intersection(*step_sets), reverse=True):
        try:
            for d in dirs:
                restore_checkpoint(d, s, like)
        except CORRUPT_ERRORS as e:
            warnings.warn(f"checkpoint step_{s} unreadable in {d} "
                          f"({type(e).__name__}); excluded from resume")
            continue
        return s
    return None


def _aggregate(run_dir: str, like, R: int, n_epochs: int) -> dict:
    import numpy as np
    import torch

    from ..checkpoint.store import restore_checkpoint
    from ..core.tree import tree_map

    summaries = []
    for r in range(R):
        with open(os.path.join(run_dir, f"summary_rank{r}.json")) as f:
            summaries.append(json.load(f))
    # the exact step this launch wrote — never a stale survivor
    states = [restore_checkpoint(os.path.join(run_dir, "final", f"rank_{r}"),
                                 n_epochs, like) for r in range(R)]
    state = tree_map(lambda *xs: torch.cat(xs), *states)
    history = {}
    for k in summaries[0]["history"]:
        rows = [s["history"][k] for s in summaries]
        n = min(len(v) for v in rows)
        dtype = np.float64 if k == "epoch_s" else np.float32
        history[k] = torch.from_numpy(
            np.stack([np.asarray(v[:n], dtype) for v in rows], axis=1))
    counts = {k: tuple(int(sum(s["counts"][k][i] for s in summaries))
                       for i in range(4)) for k in GAN_KERNELS}
    return {"state": state, "history": history, "summaries": summaries,
            "counts": counts, "run_dir": run_dir}


def lockstep_reference(seed: int, wcfg, n_outer: int, n_inner: int,
                       n_epochs: int, data, device=None):
    """The bitwise twin of a zero-jitter lock-step `run_proc`, in one
    process: every rank's `rank_grads` and `rank_apply` run on its own
    [1] rows, as its worker runs them, and the exchange runs through
    `VmapComm` on their [R] stack.  Returns the final `[R, ...]` state.
    (`train_stacked` computes all ranks in one batched call, which may
    round differently.)  On the CPU it computes at the workers' fixed
    thread count (`lockstep_threads`), on the card with the workers'
    deterministic cuDNN (`lockstep_cudnn_deterministic`), and restores
    the caller's settings."""
    import torch

    from .. import resolve_device
    from ..core import workflow
    from ..core.ring import VmapComm
    from ..core.tree import tree_map

    dev = resolve_device(device)
    R = n_outer * n_inner
    comm = VmapComm(n_outer, n_inner)
    schedule = workflow.make_schedule(wcfg)

    def stack(trees):
        return tree_map(lambda *xs: torch.cat(xs), *trees)
    with cpu_threads(lockstep_threads(True, dev)), cudnn_deterministic(
            lockstep_cudnn_deterministic(True, dev)):
        generator = torch.Generator(device=dev).manual_seed(seed)
        state, data_per_rank = workflow.init_run(generator, R, wcfg, data,
                                                 dev)
        n_sub = data_per_rank.shape[1]
        per = [workflow.rank_rows(state, r) for r in range(R)]
        datas = [workflow.rank_rows(data_per_rank, r) for r in range(R)]
        for e in range(n_epochs):
            draws = workflow.make_draws(generator, wcfg, R, n_sub)
            disc_due, gen_due = workflow.due(wcfg, e)
            outs = [workflow.rank_grads(per[r], datas[r],
                                        workflow.rank_rows(draws, r), wcfg,
                                        disc_due, gen_due)
                    for r in range(R)]
            if not gen_due:
                per = [workflow.bump_epoch(o[0]) for o in outs]
                continue
            ns, g = stack([o[0] for o in outs]), stack([o[1] for o in outs])
            if wcfg.obs.metrics:
                synced, new_sync, row = schedule.exchange_with_obs(
                    comm, g, ns["sync"], ns["epoch"][0])
                ns["obs"] = schedule.accumulate_obs(ns["obs"], row)
            else:
                synced, new_sync = schedule.exchange(comm, g, ns["sync"],
                                                     ns["epoch"][0])
            per = [workflow.rank_apply(
                workflow.rank_rows(ns, r), workflow.rank_rows(synced, r),
                workflow.rank_rows(new_sync, r), wcfg) for r in range(R)]
        return stack(per)


# ----------------------------------------------------------------------------
# worker side


def _worker_main(rank: int, run_dir: str) -> int:
    with open(os.path.join(run_dir, RUNCONFIG)) as f:
        cfg = json.load(f)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..checkpoint.store import restore_checkpoint, save_checkpoint
    from ..core import workflow
    from ..obs import trace as obs_trace
    from .jitter import JitterConfig
    from .mailbox import Barrier
    from .proccomm import ProcComm

    dev = resolve_device(cfg["device"])  # no CUDA when asked for: exit 1
    torch.set_num_threads(cfg["num_threads"])
    torch.backends.cuda.matmul.allow_tf32 = cfg["allow_tf32"]["matmul"]
    torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]["cudnn"]
    torch.backends.cudnn.deterministic = cfg["cudnn_deterministic"]
    wcfg = wcfg_from_dict(cfg["wcfg"])
    n_outer, n_inner = cfg["n_outer"], cfg["n_inner"]
    R = n_outer * n_inner
    n_epochs, lockstep = cfg["n_epochs"], cfg["lockstep"]
    jitter = JitterConfig.from_dict(cfg["jitter"])
    timeout = float(cfg["timeout"])

    # the host-side span tracer: every mailbox wait, window read and
    # write, barrier, jitter sleep and ProcComm exchange from here on
    # records into trace_rank<rank>.jsonl (merge with scripts/obsview.py);
    # a relative trace dir lands inside run_dir, beside the summaries
    tracer = None
    if wcfg.obs.trace_dir:
        tdir = wcfg.obs.trace_dir
        if not os.path.isabs(tdir):
            tdir = os.path.join(run_dir, tdir)
        os.makedirs(tdir, exist_ok=True)
        tracer = obs_trace.Tracer(
            os.path.join(tdir, f"trace_rank{rank}.jsonl"), rank=rank)
        obs_trace.install(tracer)

    with np.load(os.path.join(run_dir, DATA_FILE)) as z:
        data = torch.from_numpy(z["data"]).to(dev)
    generator = torch.Generator(device=dev).manual_seed(cfg["seed"])
    state, data_local = workflow.init_run(generator, R, wcfg, data, dev,
                                          rank=rank)
    n_sub = data_local.shape[1]
    schedule = workflow.make_schedule(wcfg)
    comm = ProcComm(n_outer, n_inner, rank, run_dir, lockstep=lockstep,
                    timeout=timeout, window_bytes=wcfg.sync.ring_chunking)
    barrier = Barrier(run_dir, rank, R, timeout=timeout)

    start = 0
    ckpt_dir = os.path.join(run_dir, "ckpt", f"rank_{rank}")
    if cfg["resume_step"] is not None:
        # the launcher negotiated the newest step loadable by EVERY rank;
        # restarting anywhere else would desync the lock-step pairing
        start = cfg["resume_step"]
        restored = restore_checkpoint(ckpt_dir, start,
                                      dict(state, rng=generator.get_state()))
        generator.set_state(restored.pop("rng"))
        state = restored
        print(f"rank {rank}: resumed from epoch {start}", flush=True)

    counts = _kernel_counts()
    for c in counts.values():
        c.reset()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_ready = time.time()
    barrier.arrive_and_wait("run start")
    t_start = time.time()
    obs_on = wcfg.obs.metrics
    adaptive = wcfg.sync.adaptive
    hist = {"d_loss": [], "g_loss": [], "epoch_s": [], "residuals": [],
            "pred_params": []}
    if adaptive:
        hist["skew_ema"], hist["k_eff"] = [], []
    if obs_on:
        hist["deposit_age"], hist["shipped"] = [], []
    span = obs_trace.span
    for e in range(start, n_epochs):
        with span("epoch", cat="epoch", epoch=e):
            jitter.apply(rank, e)
            t0 = time.perf_counter()
            disc_due, gen_due = workflow.due(wcfg, e)
            with span("compute.grads", cat="compute", epoch=e):
                draws = workflow.rank_rows(
                    workflow.make_draws(generator, wcfg, R, n_sub), rank)
                new_state, g_grads, metrics = workflow.rank_grads(
                    state, data_local, draws, wcfg, disc_due, gen_due)
                if tracer is not None and cuda:   # the span covers the
                    torch.cuda.synchronize(dev)   # compute, not its dispatch
            if gen_due:
                comm.begin_epoch(e)
                with span("exchange", cat="wire", epoch=e):
                    if obs_on:
                        synced, new_sync, row = schedule.exchange_with_obs(
                            comm, g_grads, new_state["sync"],
                            new_state["epoch"][0])
                    else:
                        synced, new_sync = schedule.exchange(
                            comm, g_grads, new_state["sync"],
                            new_state["epoch"][0])
                with span("compute.apply", cat="compute", epoch=e):
                    state = workflow.rank_apply(new_state, synced, new_sync,
                                                wcfg)
                if obs_on:
                    state["obs"] = schedule.accumulate_obs(new_state["obs"],
                                                           row)
            else:           # no exchange and no Adam step: every rank
                state = workflow.bump_epoch(new_state)  # skips this epoch
            if cuda:
                torch.cuda.synchronize(dev)
        hist["epoch_s"].append(time.perf_counter() - t0)
        for k in ("d_loss", "g_loss"):
            hist[k].append(float(metrics[k][0]))
        for k in ("residuals", "pred_params"):
            hist[k].append(metrics[k][0].tolist())
        if adaptive:
            ctrl = state["sync"]["ctrl"]
            hist["skew_ema"].append(float(ctrl["skew_ema"][0]))
            hist["k_eff"].append(int(ctrl["k_eff"][0]))
            if tracer is not None:
                tracer.counter("skew_ema", hist["skew_ema"][-1])
                tracer.counter("k_eff", hist["k_eff"][-1])
        if obs_on:
            hist["deposit_age"].append(float(state["obs"]["deposit_age"][0]))
            hist["shipped"].append(int(state["obs"]["shipped"][0]))
            if tracer is not None:
                tracer.counter("deposit_age", hist["deposit_age"][-1])
        if cfg["ckpt_every"] and (e + 1) % cfg["ckpt_every"] == 0:
            save_checkpoint(ckpt_dir, e + 1,
                            dict(state, rng=generator.get_state()),
                            metadata={"rank": rank, "epochs": e + 1})
    wall_s = time.time() - t_start

    save_checkpoint(os.path.join(run_dir, "final", f"rank_{rank}"),
                    n_epochs, state, metadata={"rank": rank})
    summary = {
        "rank": rank, "n_epochs": n_epochs, "start_epoch": start,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "lockstep": lockstep, "jitter": jitter.to_dict(),
        "t_ready": t_ready, "t_start": t_start, "wall_s": wall_s,
        "num_threads": torch.get_num_threads(),
        "mkl_num_threads": os.environ.get("MKL_NUM_THREADS"),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else None),
        "counts": {k: [c.launches, c.plain_calls, c.backward_launches,
                       c.backward_plain] for k, c in counts.items()},
        "max_skew_ema": max(hist.get("skew_ema") or [0.0]),
        "max_k_eff": max(hist.get("k_eff") or [1]),
        "history": hist,
    }
    if obs_on:
        summary["obs"] = {
            "payload_bytes": schedule.payload_bytes,
            "ship_count": int(state["obs"]["ship_count"][0]),
            "exchange_count": int(state["obs"]["exchange_count"][0]),
            "max_deposit_age": max(hist["deposit_age"] or [0.0]),
        }
    with open(os.path.join(run_dir, f"summary_rank{rank}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    barrier.arrive_and_wait("run end")
    if tracer is not None:
        obs_trace.uninstall()
        tracer.close()
    comm.close()
    barrier.close()
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="SAGIPS proc-runtime worker entry point (spawned by "
                    "repro_torch.runtime.launch.run_proc; see also "
                    "python -m repro_torch.launch.train_gan --backend proc)")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--run-dir", required=True)
    args = ap.parse_args(argv)
    return _worker_main(args.rank, args.run_dir)


if __name__ == "__main__":
    sys.exit(main())
