"""Train the paper's GAN inverse-problem solver across simulated ranks.

Counterpart of `examples/train_sagips_gan.py` with its `vmap` backend:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --preset paper \\
        --epochs 200
    PYTHONPATH=src python -m repro_torch.launch.train_gan --device cpu \\
        --preset reduced --ranks 4 --epochs 12 --events 2000

R = --ranks ranks in groups of --inner (GPUs a node, Tab. I) are stacked
on one device (CUDA unless `--device cpu`).  --problem is any of the five
registered problems; the image-valued ones (imaging, imaging_blur) train
the conv generator at the JAX package's image batch shape and capped
generator step (`configs.sagips_gan.for_problem`).  `--preset reduced` (the
default) is `configs.sagips_gan.REDUCED`, the JAX example's settings (64
samples x 25 events a rank, gen lr 2e-4, disc lr 5e-4, h 50); `--preset
paper` is Tab. III (`PAPER`: 1024 x 100 events, lr 1e-5 / 1e-4, h 1000).
--mode, --h and --param-samples given explicitly override the preset.
Full-state checkpoints land in --checkpoint-dir every --ckpt-every
epochs (the JAX store's layout) and --resume continues bitwise from the
newest one.

`--backend proc` runs the R ranks as R real worker processes
(`core.workflow.train_proc`, `runtime/`) exchanging gradients through
mmap mailboxes, all on the one device:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --backend proc \
        --num-procs 2 --device cpu --epochs 12 --param-samples 16

--num-procs overrides --ranks; the ring is (N / --inner) x --inner when
--inner divides N, else 1 x N.  The run is lock-step (bitwise the
per-rank computation in one process) unless --free-run or a --jitter-*
flag lets the ranks drift apart.  --checkpoint-dir is then the run
directory: per-process checkpoints under ckpt/rank_<r>, and --resume
continues from the newest step every rank can load.  It ends with one
line per rank (device, epochs, epoch p50, wall time) and the workers'
summed kernel counts.

`--payload-precision bf16` sends the fused ring payload as bf16 against
fp32 master state, and `--ring-chunking BYTES` sends it as
ceil(payload / BYTES) segments (one `torch.roll` each stacked, one mmap
window each with `--backend proc`), on either backend and with every
--problem (the ring modes with a fused payload only: `SyncConfig`
refuses the rest with the JAX package's message):

    PYTHONPATH=src python -m repro_torch.launch.train_gan --device cpu \
        --problem imaging_blur --ranks 4 --epochs 4 --param-samples 8 \
        --ring-chunking 524288

`--disc-every D` updates the discriminator only on epochs e with e % D
== 0, and `--gen-every G` the generator, with its exchange and Adam
step, only on epochs with e % G == 0 (`core.workflow.due`); a skipped
half launches nothing, and its loss is NaN in the history.  They work
on both backends and with every --problem:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --device cpu \
        --ranks 4 --epochs 12 --disc-every 2 --gen-every 3

`--staleness K` (`--mode rma_arar_arar` only, as in the JAX example)
makes the RMA mailbox K deep: each epoch reads the deposit made K
epochs before.  It works on both backends, with every --problem, payload
and cadence:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --device cpu \
        --mode rma_arar_arar --staleness 3 --ranks 4 --epochs 12

The telemetry flags work as in the JAX example: `--obs-metrics` carries
the metrics tree (k_eff, skew, ship and exchange counts) in the epoch
state, `--metrics-out FILE.jsonl` (stacked; implies --obs-metrics)
writes a header and one row a chunk, `--profile-dir DIR` (stacked)
writes a `torch.profiler` Chrome trace of the epoch loop, and
`--trace-dir DIR` (proc) has each worker write its span trace
`trace_rank<r>.jsonl`, which `python scripts/obsview.py DIR` merges:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --backend proc \
        --num-procs 2 --device cpu --epochs 12 --jitter-rank-lag-ms 20 \
        --obs-metrics --trace-dir trace

The progress lines show the mean over ranks of the last epoch's losses,
or of the report interval's finite ones where the last epoch skipped
that half.

`--sync-schedule` takes `sync` (the default: a due outer epoch waits on
the pod-boundary hop) and `overlap` (the grouped modes: the epoch
before a due one ships its inner-synced payload across the pod
boundary, and the due epoch adds it from the outer mailbox, one epoch
old), on both backends and with every --problem, payload, cadence and
--staleness:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --device cpu \
        --mode rma_arar_arar --sync-schedule overlap --h 3 --ranks 4 \
        --inner 2 --epochs 12

`adaptive` (rma_arar_arar only, as in the JAX example) reads the RMA
mailbox k_eff epochs old, k_eff in [1, --max-staleness] moved by a
controller on the skew the deposits' epoch tags show, and
`adaptive-overlap` adds the overlapped pod boundary with its ship gate
stretched by k_eff.  Stacked, every rank deposits at the same epoch, so
k_eff stays 1; free-running workers measure the skew, and each rank's
line then shows its max_skew_ema and max_k_eff:

    PYTHONPATH=src python -m repro_torch.launch.train_gan --backend proc \
        --num-procs 2 --device cpu --mode rma_arar_arar --sync-schedule \
        adaptive --max-staleness 4 --jitter-rank-lag-ms 40 --epochs 25 \
        --param-samples 16 --events 2000

The run ends with the ensemble against the truth, the serving-path solve
(`core.workflow.make_solver`) on the reference events, and the kernels'
launches and plain calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import sagips_gan
from repro_torch.core import gan, workflow
from repro_torch.core.ensemble import ensemble_response
from repro_torch.core.sync import MODES, PAYLOAD_PRECISIONS
from repro_torch.kernels import build
from repro_torch.kernels.imaging import blur_counts, mask_counts
from repro_torch.kernels.inverse_cdf import counts as icdf_counts
from repro_torch.obs.config import ObsConfig
from repro_torch.problems import available, get_problem


def report_final(problem, gen_stack, data, device):
    """The ensemble prediction (§VI-A) and the serving-path solve of the
    trained stack against the reference events."""
    noise = torch.randn((256, gan.NOISE_DIM),
                        generator=torch.Generator().manual_seed(7)
                        ).to(device)
    p_hat, sigma = ensemble_response(gen_stack, noise)
    truth = problem.true_params(device)
    print("\nfinal ensemble prediction vs truth:")
    if problem.param_shape is not None:     # an image: a summary, not 1024
        print(f"  {problem.n_params} pixels: mean|p̂ - truth| "
              f"{float((p_hat - truth).abs().mean()):.4f}, mean σ "
              f"{float(sigma.mean()):.4f}")
    else:
        for i in range(problem.n_params):
            print(f"  p{i}: {float(p_hat[i]):.4f} ± {float(sigma[i]):.4f} "
                  f"(truth {float(truth[i]):.4f})")
    cfg = workflow.SolveConfig()
    R = next(gan.leaves(gen_stack)).shape[0]
    solve = workflow.make_solver(problem, cfg,
                                 workflow.solve_draws(cfg, R, problem, device))
    n = min(int(data.shape[0]), 1024)
    out = solve(gen_stack, data[None, :n],
                torch.ones((1, n), dtype=torch.bool, device=device))
    r_ens = float(problem.mean_abs_residual(p_hat))
    r_sol = float(problem.mean_abs_residual(out["params"][0]))
    print(f"serving-path solve (make_solver, {n} events): "
          f"mean|r̂|={r_sol:.4f} vs ensemble {r_ens:.4f} "
          f"(score {float(out['score'][0]):.3f})")
    return r_ens, r_sol


def interval_loss(rows, key):
    """The NaN-aware mean over ranks of the last row's `key`, or of every
    row's where the last is all NaN (its half was skipped under
    --disc-every/--gen-every), as the JAX example reads them; NaN when no
    row ran that half."""
    last = rows[-1][key].float()
    if bool(last.isnan().all()):
        last = torch.stack([r[key].float() for r in rows])
    return float(last.nanmean()) if not bool(last.isnan().all()) \
        else float("nan")


def proc_backend(args, wcfg, n_outer, n_inner, data, dev):
    """The proc backend: one worker process a rank, then one line per rank
    and the workers' summed kernel counts.  Returns the stacked state."""
    from repro_torch.runtime import JitterConfig, run_proc
    jitter = None
    if args.jitter_rank_lag_ms > 0 or args.jitter_noise_ms > 0:
        jitter = JitterConfig(seed=args.seed,
                              rank_lag_ms=args.jitter_rank_lag_ms,
                              noise_ms=args.jitter_noise_ms)
    lockstep = not (args.free_run or jitter is not None)
    print(f"backend=proc: {n_outer * n_inner} worker processes "
          f"({n_outer} x {n_inner}), "
          f"{'lock-step' if lockstep else 'free-running'}, jitter {jitter}",
          flush=True)
    out = run_proc(wcfg, n_outer, n_inner, args.epochs, data,
                   seed=args.seed, lockstep=lockstep, jitter=jitter,
                   run_dir=args.checkpoint_dir,
                   ckpt_every=args.ckpt_every if args.checkpoint_dir else 0,
                   resume=args.resume, device=dev)
    for s in out["summaries"]:
        n = s["n_epochs"] - s["start_epoch"]
        p50 = (f"epoch p50 {1e3 * np.median(s['history']['epoch_s']):.2f} "
               f"ms" if n else "no new epochs")
        obs = s.get("obs")
        obs = (f"; obs: {obs['exchange_count']} exchanges of "
               f"{obs['payload_bytes']:,} B, {obs['ship_count']} ships, max "
               f"deposit age {obs['max_deposit_age']:g}" if obs else "")
        skew = (f" max_skew_ema={s['max_skew_ema']:.2f} "
                f"max_k_eff={s['max_k_eff']}" if wcfg.sync.adaptive else "")
        print(f"  rank {s['rank']} on {s['device']}: {n} epochs from "
              f"{s['start_epoch']}, {p50}, {s['wall_s']:.2f} s{obs}{skew}")
    h = out["history"]
    if len(h["d_loss"]):
        rows = [{k: h[k][i] for k in ("d_loss", "g_loss")}
                for i in range(len(h["d_loss"]))]
        print(f"last epoch: d_loss {interval_loss(rows, 'd_loss'):.3f} "
              f"g_loss {interval_loss(rows, 'g_loss'):.3f} (mean over "
              f"ranks; the run's where the last epoch skipped that half); "
              f"{out['wall_s']:.1f} s from spawn to result, start-up "
              f"{out['startup_s']:.1f} s")
    if wcfg.obs.trace_dir:
        tdir = wcfg.obs.trace_dir
        if out["run_dir"] is not None and not os.path.isabs(tdir):
            tdir = os.path.join(out["run_dir"], tdir)
        print(f"span traces: {tdir}/trace_rank<r>.jsonl (merge with "
              f"python scripts/obsview.py {tdir})")
    launches, plain, _, bwd_plain = out["counts"]["inverse_cdf"]
    print(f"inverse-CDF sampler (B1), summed over the workers: {launches} "
          f"kernel launches, {plain} plain calls, {bwd_plain} backward "
          f"passes (closed form in PyTorch)")
    if wcfg.problem_obj.param_shape is not None:
        for name, tag in (("mask_apply", "mask (B2)"),
                          ("blur2d", "blur (B3)")):
            c = out["counts"][name]
            print(f"{tag}, summed over the workers: {c[0]} kernel "
                  f"launches, {c[1]} plain calls, {c[2] + c[3]} backward "
                  f"passes")
    return out["state"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("paper", "reduced"),
                    default="reduced")
    ap.add_argument("--mode", choices=MODES, default=None)
    ap.add_argument("--problem", choices=available(), default="proxy1d")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--inner", type=int, default=4,
                    help="inner group size (GPUs per node, Tab. I)")
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--h", type=int, default=None)
    ap.add_argument("--events", type=int, default=50_000,
                    help="reference events")
    ap.add_argument("--param-samples", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--staleness", type=int, default=1,
                    help="RMA mailbox depth k (rma_arar_arar only)")
    ap.add_argument("--sync-schedule",
                    choices=("sync", "overlap", "adaptive",
                             "adaptive-overlap"), default="sync",
                    help="sync; overlap: ship the pod-boundary payload "
                         "at epoch t, add it at t+1; adaptive: a controller "
                         "moves the RMA read depth k_eff in [1, "
                         "--max-staleness] on the measured skew "
                         "(rma_arar_arar only); adaptive-overlap: both")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="the adaptive schedules' widest read depth k_max")
    ap.add_argument("--payload-precision", choices=PAYLOAD_PRECISIONS,
                    default="fp32",
                    help="wire dtype of the fused ring payload")
    ap.add_argument("--ring-chunking", type=int, default=0,
                    help="ring segment size in bytes (0: one payload)")
    ap.add_argument("--disc-every", type=int, default=1)
    ap.add_argument("--gen-every", type=int, default=1)
    ap.add_argument("--backend", choices=("vmap", "proc"), default="vmap",
                    help="vmap: the ranks stacked in one process; proc: "
                         "one worker process a rank")
    ap.add_argument("--num-procs", type=int, default=None,
                    help="proc backend: worker processes (overrides "
                         "--ranks)")
    ap.add_argument("--free-run", action="store_true",
                    help="proc backend: no lock-step rendezvous; reads "
                         "take the latest deposit (implied by --jitter-*)")
    ap.add_argument("--jitter-rank-lag-ms", type=float, default=0.0,
                    help="proc backend: rank r sleeps r * LAG ms an epoch")
    ap.add_argument("--jitter-noise-ms", type=float, default=0.0,
                    help="proc backend: a seeded uniform [0, NOISE) ms "
                         "sleep an epoch")
    ap.add_argument("--obs-metrics", action="store_true",
                    help="carry the metrics tree (k_eff, skew, ship and "
                         "exchange counts) through the epoch state; implied "
                         "by --metrics-out")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.jsonl",
                    help="stacked backend: flush chunk-boundary metrics as "
                         "JSONL (schema-versioned header, one row a chunk)")
    ap.add_argument("--trace-dir", default=None,
                    help="proc backend: per-rank host span traces "
                         "(trace_rank<r>.jsonl; merge with "
                         "scripts/obsview.py)")
    ap.add_argument("--profile-dir", default=None,
                    help="stacked backend: a torch.profiler Chrome trace "
                         "of the epoch loop (trace.json) in this directory")
    args = ap.parse_args(argv)

    adaptive = args.sync_schedule.startswith("adaptive")
    base = {"paper": sagips_gan.PAPER,
            "reduced": sagips_gan.REDUCED}[args.preset]
    if adaptive and (args.mode or base.sync.mode) != "rma_arar_arar":
        ap.error("--sync-schedule adaptive needs --mode rma_arar_arar "
                 "(the only mode with an RMA mailbox)")
    dev = resolve_device(args.device)
    sync = dataclasses.replace(
        base.sync, fuse_tensors=not args.no_fuse,
        payload_precision=args.payload_precision,
        ring_chunking=args.ring_chunking,
        staleness=args.max_staleness if adaptive else args.staleness,
        overlap=args.sync_schedule.endswith("overlap"), adaptive=adaptive,
        **{k: v for k, v in (("mode", args.mode), ("h", args.h))
           if v is not None})
    trace_dir = args.trace_dir
    if trace_dir and not args.checkpoint_dir:
        # without --checkpoint-dir the run directory is temporary: a
        # relative trace dir is taken from here instead
        trace_dir = os.path.abspath(trace_dir)
    obs = ObsConfig(metrics=args.obs_metrics or bool(args.metrics_out),
                    metrics_out=args.metrics_out, trace_dir=trace_dir,
                    profile_dir=args.profile_dir)
    wcfg = dataclasses.replace(base, sync=sync, problem=args.problem,
                               disc_every=args.disc_every,
                               gen_every=args.gen_every, obs=obs)
    if args.param_samples is not None:
        wcfg = dataclasses.replace(wcfg, n_param_samples=args.param_samples)
    wcfg = sagips_gan.for_problem(args.problem, wcfg)
    problem = get_problem(args.problem)
    if args.backend == "proc":
        R = args.num_procs or args.ranks
        n_inner = args.inner if R % args.inner == 0 else R
    else:
        R, n_inner = args.ranks, min(args.inner, args.ranks)
        if R % n_inner:
            ap.error(f"--ranks {R} must be divisible by --inner {n_inner}")
    n_outer = R // n_inner
    if dev.type == "cuda":          # the kernels' first-use build
        build.build_all(("inverse_cdf", "imaging")
                        if problem.param_shape else ("inverse_cdf",))
    data = problem.make_reference_data(
        torch.Generator(device=dev).manual_seed(99), args.events, device=dev)
    schedule = workflow.make_schedule(wcfg)
    spec = schedule.spec
    print(f"problem={args.problem} ({problem.n_params} params -> "
          f"{problem.obs_dim} observables) mode={wcfg.sync.mode} "
          f"h={wcfg.sync.h} schedule={schedule.name} "
          f"staleness={wcfg.sync.staleness} "
          f"payload={wcfg.sync.payload_precision} ring_chunking="
          f"{wcfg.sync.ring_chunking} ({spec.n_segments} segments) "
          f"ranks={n_outer}x{n_inner} "
          f"samples={wcfg.n_param_samples}x{wcfg.events_per_sample} "
          f"disc_batch={wcfg.disc_batch} lr gen {wcfg.gen_lr} disc "
          f"{wcfg.disc_lr} disc_every={wcfg.disc_every} "
          f"gen_every={wcfg.gen_every} on {dev}")
    if args.backend == "proc":
        state = proc_backend(args, wcfg, n_outer, n_inner, data, dev)
        report_final(problem, state["gen"], data, dev)
        return state

    report_every = max(args.epochs // 10, 1)
    chunk = args.chunk if args.chunk > 0 else report_every
    if args.checkpoint_dir:
        # chunk boundaries land on the checkpoint cadence, as in the JAX
        # example: the largest divisor of --ckpt-every that fits
        chunk = max(d for d in range(1, min(chunk, args.ckpt_every) + 1)
                    if args.ckpt_every % d == 0)
    t0 = time.time()
    since = []                  # the report interval's metrics, on device

    def on_epoch(e, metrics):
        since.append(metrics)
        if (e + 1) % report_every == 0 or e + 1 == args.epochs:
            res = next((m["residuals"] for m in reversed(since)
                        if not bool(m["residuals"].isnan().all())),
                       metrics["residuals"])
            print(f"epoch {e:6d}  mean|r̂|={float(res.abs().mean()):.4f}  "
                  f"d_loss={interval_loss(since, 'd_loss'):.3f}  g_loss="
                  f"{interval_loss(since, 'g_loss'):.3f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
            since.clear()
    for c in (icdf_counts, mask_counts, blur_counts):
        c.reset()
    state, _ = workflow.train_stacked(
        args.seed, wcfg, n_outer, n_inner, args.epochs, data,
        checkpoint_every=args.ckpt_every if args.checkpoint_dir else 0,
        chunk=chunk, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, device=dev, on_epoch=on_epoch)
    if wcfg.obs.metrics_out:
        print(f"metrics: a header and one row a chunk in "
              f"{wcfg.obs.metrics_out}")
    if wcfg.obs.profile_dir:
        print(f"profile: {os.path.join(wcfg.obs.profile_dir, 'trace.json')}")
    c = icdf_counts
    print(f"inverse-CDF sampler (B1): {c.launches} kernel launches, "
          f"{c.plain_calls} plain calls, {c.backward_plain} backward passes "
          f"(closed form in PyTorch)")
    if problem.param_shape is not None:
        m, b = mask_counts, blur_counts
        print(f"mask (B2): {m.launches} kernel launches, {m.plain_calls} "
              f"plain calls, {m.backward_plain} backward passes in PyTorch; "
              f"blur (B3): {b.launches} kernel launches, {b.plain_calls} "
              f"plain calls, {b.backward_launches + b.backward_plain} "
              f"backward passes (the blur itself)")
    report_final(problem, state["gen"], data, dev)
    return state


if __name__ == "__main__":
    main()
