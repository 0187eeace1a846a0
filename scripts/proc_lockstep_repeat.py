#!/usr/bin/env python3
"""Count how often a lock-step proc run on the CPU differs from its
per-rank reference (ROADMAP.md queue C item 6).

    PYTHONPATH=src python scripts/proc_lockstep_repeat.py [--runs 20]
    PYTHONPATH=src python scripts/proc_lockstep_repeat.py --parent-threads

Each run is the proc runtime at `PAPER`'s widths cut to 32 x 100 events a
rank: proxy1d, `rma_arar_arar` with h 2, 8 worker processes as 2 x 4,
lock-step, `--epochs` epochs (default 3) from seed 0 on 50,000 reference
events.  Its stacked final state is compared bit for bit with
`lockstep_reference`, computed afresh after each run.  The script prints
one line a run and, last, a JSON object with the count of runs that
differed.

By default workers and reference compute at the runtime's fixed
lock-step thread count (`runtime.launch.LOCKSTEP_CPU_THREADS`).
`--parent-threads` restores the behaviour before it was fixed, as the
control: `runtime.launch.lockstep_threads` is replaced in this process
so that the workers take its thread count and no `MKL_NUM_THREADS`, and
the reference runs at that count too.
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
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.problems import get_problem
    from repro_torch.runtime import launch

    if args.parent_threads:            # every run at the caller's count
        launch.lockstep_threads = lambda lockstep, device: None
    wcfg = dataclasses.replace(
        PAPER, n_param_samples=32,
        sync=dataclasses.replace(PAPER.sync, mode="rma_arar_arar", h=2))
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 50_000, device="cpu")
    threads = launch.lockstep_threads(True, torch.device("cpu"))
    print(f"host: {os.cpu_count()} cores, torch {torch.__version__}, this "
          f"process at {torch.get_num_threads()} threads; workers and "
          f"reference at {threads or torch.get_num_threads()} threads"
          f"{' (the control)' if args.parent_threads else ''}; PAPER at "
          f"{wcfg.n_param_samples} x {wcfg.events_per_sample} events a "
          f"rank, 8 workers as 2 x 4, {wcfg.sync.mode} h {wcfg.sync.h}, "
          f"{args.epochs} epochs, lock-step", flush=True)
    differed = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = launch.run_proc(wcfg, 2, 4, args.epochs, data, seed=0,
                              device="cpu", timeout=900)
        ref = launch.lockstep_reference(0, wcfg, 2, 4, args.epochs, data,
                                        device="cpu")
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
                      "cores": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
