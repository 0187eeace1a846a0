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

The exchange schedules other than `sync` (--sync-schedule,
--staleness, --max-staleness, --disc-every, --gen-every, the metrics
and trace sinks) are ROADMAP.md queue A item 3: they raise.  The run
ends with the ensemble against the truth, the serving-path solve
(`core.workflow.make_solver`) on the reference events, and the kernels'
launches and plain calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import sagips_gan
from repro_torch.core import gan, workflow
from repro_torch.core.ensemble import ensemble_response
from repro_torch.core.sync import MODES, PAYLOAD_PRECISIONS, SCHEDULE_ITEM
from repro_torch.kernels import build
from repro_torch.kernels.imaging import blur_counts, mask_counts
from repro_torch.kernels.inverse_cdf import counts as icdf_counts
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
        print(f"  rank {s['rank']} on {s['device']}: {n} epochs from "
              f"{s['start_epoch']}, {p50}, {s['wall_s']:.2f} s")
    h = out["history"]
    if len(h["d_loss"]):
        print(f"last epoch: d_loss {float(h['d_loss'][-1].mean()):.3f} "
              f"g_loss {float(h['g_loss'][-1].mean()):.3f} (mean over "
              f"ranks); {out['wall_s']:.1f} s from spawn to result, "
              f"start-up {out['startup_s']:.1f} s")
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
    # the JAX example's flags that are not ported yet: they raise
    ap.add_argument("--sync-schedule", default="sync")
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--max-staleness", type=int, default=None)
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
    for flag in ("--metrics-out", "--trace-dir", "--profile-dir"):
        ap.add_argument(flag, default=None)
    ap.add_argument("--obs-metrics", action="store_true")
    args = ap.parse_args(argv)

    later = [f for f, on in (
        ("--sync-schedule", args.sync_schedule != "sync"),
        ("--staleness", args.staleness != 1),
        ("--max-staleness", args.max_staleness is not None),
        ("--disc-every", args.disc_every != 1),
        ("--gen-every", args.gen_every != 1),
        ("--metrics-out", args.metrics_out), ("--trace-dir", args.trace_dir),
        ("--profile-dir", args.profile_dir),
        ("--obs-metrics", args.obs_metrics)) if on]
    if later:
        raise NotImplementedError(f"{', '.join(later)}: not ported yet, "
                                  f"{SCHEDULE_ITEM}")
    dev = resolve_device(args.device)
    base = {"paper": sagips_gan.PAPER,
            "reduced": sagips_gan.REDUCED}[args.preset]
    sync = dataclasses.replace(
        base.sync, fuse_tensors=not args.no_fuse,
        payload_precision=args.payload_precision,
        ring_chunking=args.ring_chunking,
        **{k: v for k, v in (("mode", args.mode), ("h", args.h))
           if v is not None})
    wcfg = dataclasses.replace(base, sync=sync, problem=args.problem)
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
    spec = workflow.make_schedule(wcfg).spec
    print(f"problem={args.problem} ({problem.n_params} params -> "
          f"{problem.obs_dim} observables) mode={wcfg.sync.mode} "
          f"h={wcfg.sync.h} schedule=sync payload="
          f"{wcfg.sync.payload_precision} ring_chunking="
          f"{wcfg.sync.ring_chunking} ({spec.n_segments} segments) "
          f"ranks={n_outer}x{n_inner} "
          f"samples={wcfg.n_param_samples}x{wcfg.events_per_sample} "
          f"disc_batch={wcfg.disc_batch} lr gen {wcfg.gen_lr} disc "
          f"{wcfg.disc_lr} on {dev}")
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

    def on_epoch(e, metrics):
        if (e + 1) % report_every == 0 or e + 1 == args.epochs:
            print(f"epoch {e:6d}  mean|r̂|="
                  f"{float(metrics['residuals'].abs().mean()):.4f}  d_loss="
                  f"{float(metrics['d_loss'].mean()):.3f}  g_loss="
                  f"{float(metrics['g_loss'].mean()):.3f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    for c in (icdf_counts, mask_counts, blur_counts):
        c.reset()
    state, _ = workflow.train_stacked(
        args.seed, wcfg, n_outer, n_inner, args.epochs, data,
        checkpoint_every=args.ckpt_every if args.checkpoint_dir else 0,
        chunk=chunk, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, device=dev, on_epoch=on_epoch)
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
