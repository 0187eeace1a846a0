#!/usr/bin/env python3
"""Count how often a lock-step proc run differs from its per-rank
reference (ROADMAP.md queue C item 6).

    PYTHONPATH=src python scripts/proc_lockstep_repeat.py [--runs 20]
    PYTHONPATH=src python scripts/proc_lockstep_repeat.py --parent-threads
    PYTHONPATH=src python scripts/proc_lockstep_repeat.py --device cuda \
        --problem imaging_blur --param-samples 64 [--cudnn-free]

Each run is the proc runtime at `PAPER`'s widths cut to `--param-samples`
(default 32) samples a rank, retargeted at `--problem` (default proxy1d;
`for_problem` gives the image problems 32 events a sample, else 100):
`rma_arar_arar` with h 2, 8 worker processes as 2 x 4, lock-step,
`--epochs` epochs (default 3) from seed 0 on 50,000 reference events, on
`--device` (default cpu; the ring payload chunked by `--ring-chunking`
bytes, default 0).  Its stacked final state is compared bit for bit with
`lockstep_reference`, computed afresh after each run.  The script prints
one line a run and, last, a JSON object with the count of runs that
differed.

By default workers and reference compute at the runtime's fixed
lock-step thread count on the CPU (`runtime.launch.LOCKSTEP_CPU_THREADS`)
and with deterministic cuDNN algorithms on the card
(`runtime.launch.lockstep_cudnn_deterministic`).  `--parent-threads`
restores the CPU behaviour before the count was fixed, as the control:
`runtime.launch.lockstep_threads` is replaced in this process so that
the workers take its thread count and no `MKL_NUM_THREADS`, and the
reference runs at that count too.  `--cudnn-free` is the card's
control: `lockstep_cudnn_deterministic` is replaced so that workers and
reference let cuDNN pick any algorithm.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--parent-threads", action="store_true",
                    help="the control: workers and reference at this "
                         "process's thread count")
    ap.add_argument("--problem", default="proxy1d")
    ap.add_argument("--param-samples", type=int, default=32)
    ap.add_argument("--ring-chunking", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cudnn-free", action="store_true",
                    help="the card's control: cuDNN picks any algorithm "
                         "in workers and reference")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import resolve_device
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.problems import get_problem
    from repro_torch.runtime import launch

    dev = resolve_device(args.device)
    if dev.type == "cuda":             # fp32 compute, as chip_smoke.py
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.parent_threads:            # every run at the caller's count
        launch.lockstep_threads = lambda lockstep, device: None
    if args.cudnn_free:                # cuDNN's own pick, every run
        launch.lockstep_cudnn_deterministic = lambda lockstep, device: False
    wcfg = for_problem(args.problem, dataclasses.replace(
        PAPER, n_param_samples=args.param_samples,
        sync=dataclasses.replace(PAPER.sync, mode="rma_arar_arar", h=2,
                                 ring_chunking=args.ring_chunking)))
    data = get_problem(args.problem).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), 50_000, device=dev)
    threads = launch.lockstep_threads(True, dev)
    card = (f"{torch.cuda.get_device_name(dev)}, cuDNN deterministic "
            f"{launch.lockstep_cudnn_deterministic(True, dev)}"
            f"{' (the control)' if args.cudnn_free else ''}"
            if dev.type == "cuda" else "cpu")
    print(f"host: {os.cpu_count()} cores, torch {torch.__version__}, this "
          f"process at {torch.get_num_threads()} threads; workers and "
          f"reference at {threads or torch.get_num_threads()} threads"
          f"{' (the control)' if args.parent_threads else ''}; on {card}; "
          f"{args.problem} at PAPER's widths, {wcfg.n_param_samples} x "
          f"{wcfg.events_per_sample} events a rank, 8 workers as 2 x 4, "
          f"{wcfg.sync.mode} h {wcfg.sync.h}, ring_chunking "
          f"{wcfg.sync.ring_chunking}, {args.epochs} epochs, lock-step",
          flush=True)
    differed = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = launch.run_proc(wcfg, 2, 4, args.epochs, data, seed=0,
                              device=dev, timeout=900)
        ref = launch.lockstep_reference(0, wcfg, 2, 4, args.epochs, data,
                                        device=dev)
        diff = {k: float((a.float() - b.float()).abs().max())
                for (k, a), b in zip(tree_paths(out["state"]),
                                     tree_leaves(ref))
                if not torch.equal(a, b)}
        if diff:
            differed.append(i)
        worst = max(diff.items(), key=lambda kv: kv[1]) if diff else None
        print(f"run {i}: {'DIFFERS' if diff else 'bitwise'}"
              f"{f' in {len(diff)} leaves, worst {worst}' if diff else ''}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"runs": args.runs, "differed": len(differed),
                      "which": differed,
                      "threads": threads or torch.get_num_threads(),
                      "control": args.parent_threads,
                      "cudnn_free": args.cudnn_free,
                      "problem": args.problem, "device": str(dev),
                      "cores": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
