#!/usr/bin/env python3
"""Time the GAN epoch and its exchange in two variants of the ring payload
in turns, on one card: fp32 against bf16 (`--lane payload`, the default),
the fp32 payload unchunked against chunked (`--lane chunked`), the RMA
mailbox at depth 1 against depth k (`--lane depth`, `--staleness K`,
default 2), the sync schedule against the overlapped pod boundary
(`--lane overlap`, at `--h H`, default 10: a ship and a due combine
every H epochs), or static depth 1 against adaptive staleness at k_max
`--staleness K` (`--lane adaptive`: stacked, the skew is 0 and k_eff
stays 1, so the two differ by the adaptive exchange's own work).

    PYTHONPATH=src python scripts/payload_ab.py [--problem imaging_blur]
    PYTHONPATH=src python scripts/payload_ab.py --lane chunked \
        [--problem imaging_blur] [--ring-chunking BYTES]
    PYTHONPATH=src python scripts/payload_ab.py --lane depth [--staleness 3]
    PYTHONPATH=src python scripts/payload_ab.py --lane overlap [--h 10]
    PYTHONPATH=src python scripts/payload_ab.py --lane adaptive \
        [--staleness 3]
    PYTHONPATH=src python scripts/payload_ab.py --device cpu --epochs 4

Each turn trains `PAPER` (or `for_problem(name, PAPER)`) stacked at R 8 as
2 x 4 in `rma_arar_arar` from one seed, after a 2-epoch warm-up, and
reads its epoch p50 and p99 from CUDA events at each epoch's end; the
turns run in the order of `--turns` (default: A, B, B, A of the lane's
two variants), so a drift of the card shows as a gap between the two
runs of one variant.  The chunked lane cuts the payload into segments of
`--ring-chunking` bytes (default 65,536, and 524,288 for the image
problems: 4 and 3 segments).  Then `StaticSchedule.exchange` alone on
random gradients at the generator's widths (`AdaptiveSchedule.exchange`
in the adaptive lane): its time a call (CUDA events
over 200 calls, after warm-up, the epoch counter advancing a call) for
each variant.  `--h` sets the outer ring's period in every lane (default:
the preset's, 1,000; 10 in the overlap lane).  `--profile N` then runs N
epochs of each variant under `torch.profiler` (card only): its busy time
and device ops an epoch, and the kernels whose time differs most.  On the card the first
line names it and its power limit (nvidia-smi); on the CPU the host
clock stands in, and the numbers are not the card's.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def run(argv=None):
    """Run the lane `argv` asks for and print its lines.  Returns (epoch
    p50 in ms by variant, one a turn; the exchange alone in ms a call by
    variant)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="proxy1d")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lane", choices=("payload", "chunked", "depth",
                                       "overlap", "adaptive"),
                    default="payload")
    ap.add_argument("--h", type=int, default=None,
                    help="the outer ring's period (default: the preset's; "
                         "10 in the overlap lane)")
    ap.add_argument("--staleness", type=int, default=2,
                    help="the depth lane's RMA mailbox depth k, the "
                         "adaptive lane's k_max")
    ap.add_argument("--ring-chunking", type=int, default=None,
                    help="the chunked lane's segment size in bytes")
    ap.add_argument("--turns", default=None,
                    help="comma-separated variants (default A,B,B,A)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="then profile N epochs of each variant: the card's "
                         "busy time and device ops an epoch, and the ops "
                         "whose time differs most between the variants")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import resolve_device
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import build
    from repro_torch.problems import get_problem

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if cuda:
        build.build_all()

    class Clock:
        """A CUDA event on the card, the host clock elsewhere."""
        def __init__(self):
            self.ev = torch.cuda.Event(enable_timing=True) if cuda else None
            if cuda:
                self.ev.record()
            self.t = time.perf_counter()

        def ms_to(self, later):
            if cuda:
                later.ev.synchronize()
                return self.ev.elapsed_time(later.ev)
            return (later.t - self.t) * 1e3

    problem = get_problem(args.problem)
    chunk = args.ring_chunking or (524_288 if problem.param_shape
                                   else 65_536)
    # variant -> (payload precision, ring chunking, mailbox depth (k_max
    # when adaptive), overlap, adaptive)
    variants = {
        "payload": {"fp32": ("fp32", 0, 1, False, False),
                    "bf16": ("bf16", 0, 1, False, False)},
        "chunked": {"unchunked": ("fp32", 0, 1, False, False),
                    "chunked": ("fp32", chunk, 1, False, False)},
        "depth": {"depth1": ("fp32", 0, 1, False, False),
                  f"depth{args.staleness}": ("fp32", 0, args.staleness,
                                             False, False)},
        "overlap": {"sync": ("fp32", 0, 1, False, False),
                    "overlap": ("fp32", 0, 1, True, False)},
        "adaptive": {"static": ("fp32", 0, 1, False, False),
                     "adaptive": ("fp32", 0, args.staleness, False, True)},
    }[args.lane]
    a, b = variants
    turns = (args.turns or f"{a},{b},{b},{a}").split(",")
    base = for_problem(args.problem, PAPER)
    h = args.h or (10 if args.lane == "overlap" else base.sync.h)

    def wcfg_of(variant):
        prec, ring_chunking, depth, overlap, adaptive = variants[variant]
        return dataclasses.replace(base, sync=dataclasses.replace(
            base.sync, payload_precision=prec, ring_chunking=ring_chunking,
            staleness=depth, overlap=overlap, adaptive=adaptive, h=h))

    data = problem.make_reference_data(
        torch.Generator(device=dev).manual_seed(99), 50_000, device=dev)
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        name = f"{torch.cuda.get_device_name(dev)} ({smi})"
    else:
        name = "cpu (host clock: not the card's numbers)"
    print(f"{args.problem} for_problem(PAPER), R 8 as 2 x 4, rma_arar_arar, "
          f"h {h}, {args.epochs} epochs a turn, lane {args.lane}: "
          + ", ".join(f"{v} = {p} payload, ring_chunking {c}, "
                      f"staleness {k}, schedule "
                      f"{W.make_schedule(wcfg_of(v)).name}"
                      for v, (p, c, k, _, _) in variants.items())
          + f", on {name}", flush=True)
    epochs = {}
    for variant in turns:
        wcfg = wcfg_of(variant)
        W.train_stacked(1, wcfg, 2, 4, 2, data, device=dev)     # warm-up
        marks = []
        W.train_stacked(0, wcfg, 2, 4, args.epochs, data, device=dev,
                        on_epoch=lambda e, m: marks.append(Clock()))
        ms = np.array([a.ms_to(b) for a, b in zip(marks[:-1], marks[1:])])
        epochs.setdefault(variant, []).append(float(np.percentile(ms, 50)))
        print(f"turn {variant}: epoch p50 {np.percentile(ms, 50):.3f} ms, "
              f"p99 {np.percentile(ms, 99):.3f} ms over {len(ms)} epochs",
              flush=True)
    for variant, p50s in epochs.items():
        print(f"{variant}: epoch p50 by turn "
              + ", ".join(f"{v:.3f}" for v in p50s) + " ms")

    # the exchange alone, on random gradients at the generator's widths
    exchange_ms = {}
    g = torch.Generator(device="cpu").manual_seed(5)
    for variant in variants:
        sched = W.make_schedule(wcfg_of(variant))
        grads = tree_map(lambda t: torch.randn((8,) + tuple(t.shape),
                                               generator=g).to(dev),
                         sched.spec.zeros(None))
        st = sched.init_state(8, dev)
        epoch = torch.zeros((), dtype=torch.int64, device=dev)
        comm = VmapComm(2, 4)
        for i in range(20):
            _, st = sched.exchange(comm, grads, st, epoch + i)
        n = 200
        t0 = Clock()
        for i in range(n):
            _, st = sched.exchange(comm, grads, st, epoch + i)
        t1 = Clock()
        payload = sched.spec.total * sched.spec.payload_dtype.itemsize
        exchange_ms[variant] = t0.ms_to(t1) / n
        print(f"exchange alone, {variant} ({sched.spec.total:,} scalars a "
              f"rank, {payload:,} B in {sched.spec.n_segments} segment(s)): "
              f"{exchange_ms[variant]:.4f} ms a call (mean of {n}, back to "
              f"back)")
    if args.profile and not cuda:
        print("profile: the card's busy time needs the card; not measured")
    elif args.profile:
        profile(W, wcfg_of, variants, data, dev, args.profile)
    return epochs, exchange_ms


def profile(W, wcfg_of, variants, data, dev, n):
    """`n` epochs of each variant under `torch.profiler`, after one warm
    epoch, from one seed: the card's busy ms and device ops an epoch, the
    host clock an epoch, and the six kernels whose device time an epoch
    differs most between the first two variants."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    by_variant = {}
    for variant in variants:
        wcfg = wcfg_of(variant)
        epoch = W.make_epoch_fn(2, 4, wcfg)
        g = torch.Generator(device=dev).manual_seed(0)
        state, per_rank = W.init_run(g, 8, wcfg, data, dev)
        draws = [W.make_draws(g, wcfg, 8, per_rank.shape[1])
                 for _ in range(n + 1)]
        state, _ = epoch(state, per_rank, draws[0], 0)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for e, dr in enumerate(draws[1:], 1):
                state, _ = epoch(state, per_rank, dr, e)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        ops = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                t, c = ops.get(ev.name, (0.0, 0))
                ops[ev.name] = (t + ev.time_range.elapsed_us() / n, c + 1)
        by_variant[variant] = ops
        busy = sum(t for t, _ in ops.values()) / 1e3
        count = sum(c for _, c in ops.values()) / n
        print(f"profile, {variant}: epochs 1-{n}, card busy {busy:.3f} ms "
              f"an epoch over {count:.1f} device ops, host clock "
              f"{wall_ms:.3f} ms an epoch under the profiler")
    a, b = list(by_variant.values())[:2]
    names = sorted(set(a) | set(b), key=lambda k: -abs(
        b.get(k, (0.0, 0))[0] - a.get(k, (0.0, 0))[0]))
    va, vb = list(by_variant)[:2]
    for k in names[:6]:
        (ta, ca), (tb, cb) = a.get(k, (0.0, 0)), b.get(k, (0.0, 0))
        print(f"profile, {vb} - {va}: {tb - ta:+.2f} us an epoch "
              f"({ca / n:.1f} -> {cb / n:.1f} launches) {k[:80]}")


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
