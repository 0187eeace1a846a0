"""Solve-service entry point of the port: serve SAGIPS generators over
registered inverse problems on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --problem proxy1d[:CKPT_DIR] --preset default --warm --stats \\
        [--device cpu]

Registers each `--problem NAME[:CKPT_DIR]` (the newest generator stack in
the JAX package's checkpoint store; without a directory, an untrained
2-rank MLP prior stack with the problem's n_params outputs, made from
`--seed`), then runs a demo client: submits
`--requests` observation batches generated from each problem's truth
(sizes swept across the bucket ladder), drains the queue, and reports
per-bucket latency percentiles, residuals against the truth and the
cache/queue counters.  Backpressure rejections are honored by draining
and resubmitting.  Runs on CUDA unless `--device cpu` is given.

The image problems (`imaging`, `imaging_blur`) are served here as the JAX
CLI serves them: both routes give an MLP stack (1024 outputs), since the
checkpoint route restores the MLP only.  Their conv generator is served
through `SolveService.register_problem(name, gen_stack=...)`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import serving as serving_cfg
from repro_torch.core import gan
from repro_torch.kernels import imaging as imaging_kernels
from repro_torch.kernels import inverse_cdf
from repro_torch.problems import available, get_problem
from repro_torch.serving import Backpressure, ServingError, SolveService


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", action="append", required=True,
                    metavar="NAME[:CKPT_DIR]",
                    help=f"problem to serve (repeatable); one of "
                         f"{available()}; append :DIR to restore a trained "
                         f"MLP generator checkpoint, else a fresh 2-rank "
                         f"MLP prior stack with the problem's n_params "
                         f"outputs is served (demo mode), image problems "
                         f"included, as the JAX CLI does")
    ap.add_argument("--preset", choices=("default", "reduced"),
                    default="reduced")
    ap.add_argument("--requests", type=int, default=16,
                    help="demo requests per problem")
    ap.add_argument("--events", type=int, default=0,
                    help="events per request (0: sweep the bucket ladder)")
    ap.add_argument("--warm", action="store_true",
                    help="build the whole (problem, bucket) pool before "
                         "serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print the full SolveService.snapshot() — queue "
                         "depth + reject/retry-after rate, warm-cache "
                         "hit/miss, per-bucket latency histograms")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = serving_cfg.DEFAULT if args.preset == "default" \
        else serving_cfg.REDUCED
    svc = SolveService(cfg, device=device)
    print(f"[serve] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    for spec in args.problem:
        name, _, ckpt = spec.partition(":")
        try:
            if ckpt:
                step = svc.register_problem(name, checkpoint_dir=ckpt)
                print(f"[serve] {name}: generator from {ckpt} (step {step})")
            else:
                prob = get_problem(name)
                g = torch.Generator().manual_seed(args.seed)
                stack = gan.init_generator(g, n_params=prob.n_params,
                                           ranks=2, device=device)
                svc.register_problem(name, gen_stack=stack)
                print(f"[serve] {name}: UNTRAINED 2-rank MLP prior stack, "
                      f"135 -> {prob.n_params} (demo mode; pass "
                      f"{name}:CKPT_DIR for a trained one)")
        except ServingError as e:
            raise SystemExit(f"[serve] error: {e}")

    if args.warm:
        t0 = time.perf_counter()
        for name in svc.problems():
            svc.warm(name)
        print(f"[serve] warm pool: {len(svc.cache)} solvers in "
              f"{time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(args.seed)
    lat = {}                       # (problem, bucket) -> [latency_s]
    for name in svc.problems():
        prob = get_problem(name)
        g = torch.Generator().manual_seed(args.seed + 1)
        for i in range(args.requests):
            n = args.events or int(rng.choice(cfg.buckets))
            y = prob.make_reference_data(g, n, device="cpu").numpy()
            t0 = time.perf_counter()
            while True:
                try:
                    ticket = svc.submit(name, y)
                    break
                except Backpressure as e:   # honor retry-after by draining
                    svc.run_until_empty()
                    time.sleep(e.retry_after_s)
            svc.run_until_empty()
            out = ticket.result(timeout=60.0)
            dt = time.perf_counter() - t0
            lat.setdefault((name, ticket.bucket), []).append(dt)
            if i == 0:
                res = float(prob.mean_abs_residual(
                    torch.from_numpy(out["params"])))
                print(f"[serve] {name} first solve: bucket {ticket.bucket}, "
                      f"residual {res:.3f}, score {out['score']:.3f}")

    for (name, bucket), xs in sorted(lat.items()):
        print(f"[serve] {name:>12s} bucket {bucket:>5d}: {len(xs):3d} req, "
              f"p50 {_percentile(xs, 50)*1e3:8.1f} ms, "
              f"p99 {_percentile(xs, 99)*1e3:8.1f} ms")
    for kernel, c in (("sampler", inverse_cdf.counts),
                      ("mask_apply", imaging_kernels.mask_counts),
                      ("blur2d", imaging_kernels.blur_counts)):
        print(f"[serve] {kernel}: {c.launches} kernel launches, "
              f"{c.plain_calls} plain calls")
    if args.stats:
        _print_snapshot(svc.snapshot())
    else:
        print(f"[serve] stats: {svc.stats()}")
    return svc


def _print_snapshot(snap: dict):
    """Human-readable rendering of `SolveService.snapshot()`."""
    q = snap["queue"]
    c = snap["cache"]
    print(f"[stats] served {snap['served']}, queue depth "
          f"{snap['queue_depth']} (admitted {q['admitted']}, rejected "
          f"{q['rejected']}, drained {q['drained']}; reject rate "
          f"{snap['reject_rate']:.1%}, retry-after "
          f"{snap['retry_after_s']*1e3:.0f} ms)")
    print(f"[stats] warm cache: {c['hits']} hits / {c['misses']} misses "
          f"(hit rate {snap['cache_hit_rate']:.1%}), {c['compiles']} "
          f"builds, {c['evictions']} evictions")
    for lane, h in snap["latency"].items():
        print(f"[stats] latency {lane:>16s}: n={h['count']:4d}  "
              f"p50 {h['p50_s']*1e3:8.1f} ms  p90 {h['p90_s']*1e3:8.1f} ms  "
              f"p99 {h['p99_s']*1e3:8.1f} ms")


if __name__ == "__main__":
    main()
