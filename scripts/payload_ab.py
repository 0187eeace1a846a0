#!/usr/bin/env python3
"""Time the GAN epoch and its exchange in two variants of the ring payload
in turns, on one card: fp32 against bf16 (`--lane payload`, the default),
or the fp32 payload unchunked against chunked (`--lane chunked`).

    PYTHONPATH=src python scripts/payload_ab.py [--problem imaging_blur]
    PYTHONPATH=src python scripts/payload_ab.py --lane chunked \
        [--problem imaging_blur] [--ring-chunking BYTES]
    PYTHONPATH=src python scripts/payload_ab.py --device cpu --epochs 4

Each turn trains `PAPER` (or `for_problem(name, PAPER)`) stacked at R 8 as
2 x 4 in `rma_arar_arar` from one seed, after a 2-epoch warm-up, and
reads its epoch p50 and p99 from CUDA events at each epoch's end; the
turns run in the order of `--turns` (default: A, B, B, A of the lane's
two variants), so a drift of the card shows as a gap between the two
runs of one variant.  The chunked lane cuts the payload into segments of
`--ring-chunking` bytes (default 65,536, and 524,288 for the image
problems: 4 and 3 segments).  Then `StaticSchedule.exchange` alone on
random gradients at the generator's widths: its time a call (CUDA events
over 200 calls, after warm-up) for each variant.  On the card the first
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="proxy1d")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lane", choices=("payload", "chunked"),
                    default="payload")
    ap.add_argument("--ring-chunking", type=int, default=None,
                    help="the chunked lane's segment size in bytes")
    ap.add_argument("--turns", default=None,
                    help="comma-separated variants (default A,B,B,A)")
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
    variants = ({"fp32": ("fp32", 0), "bf16": ("bf16", 0)}
                if args.lane == "payload" else
                {"unchunked": ("fp32", 0), "chunked": ("fp32", chunk)})
    a, b = variants
    turns = (args.turns or f"{a},{b},{b},{a}").split(",")

    def wcfg_of(variant):
        prec, ring_chunking = variants[variant]
        base = for_problem(args.problem, PAPER)
        return dataclasses.replace(base, sync=dataclasses.replace(
            base.sync, payload_precision=prec, ring_chunking=ring_chunking))

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
          f"{args.epochs} epochs a turn, lane {args.lane}: "
          + ", ".join(f"{v} = {p} payload, ring_chunking {c}"
                      for v, (p, c) in variants.items())
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
    g = torch.Generator(device="cpu").manual_seed(5)
    for variant in variants:
        sched = W.make_schedule(wcfg_of(variant))
        grads = tree_map(lambda t: torch.randn((8,) + tuple(t.shape),
                                               generator=g).to(dev),
                         sched.spec.zeros(None))
        st = sched.init_state(8, dev)
        epoch = torch.zeros((), dtype=torch.int64, device=dev)
        comm = VmapComm(2, 4)
        for _ in range(20):
            _, st = sched.exchange(comm, grads, st, epoch)
        n = 200
        t0 = Clock()
        for _ in range(n):
            _, st = sched.exchange(comm, grads, st, epoch)
        t1 = Clock()
        payload = sched.spec.total * sched.spec.payload_dtype.itemsize
        print(f"exchange alone, {variant} ({sched.spec.total:,} scalars a "
              f"rank, {payload:,} B in {sched.spec.n_segments} segment(s)): "
              f"{t0.ms_to(t1) / n:.4f} ms a call (mean of {n}, back to "
              f"back)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
