#!/usr/bin/env python3
"""How far a `torch.profiler` trace's device times sit from its host times.

    python3 scripts/profile_clocks.py [--runs 6] [--epochs 10]

Runs the GAN's `PAPER` config (proxy1d, R 8 as 2 x 4) for `--epochs`
epochs under `ObsConfig(profile_dir=...)`, as `chip_smoke.py` phase 44
does, `--runs` times in one process (an unprofiled 20-epoch run before
every second one).  Epoch 0 ends in a `torch.cuda.synchronize()`, a host
range and, inside it, a marker kernel (`torch.cuda._sleep`) on the
stream.  For each run it prints one JSON line:

  * `launches`, `after_epoch0`: B1's launches as its wrapper counts them;
  * `b1`, `b1_after_host_marker`, `b1_after_device_marker`: B1's
    `icdf_kernel` events in the trace, and those whose start is after
    the host range's and after the marker kernel's;
  * `device_minus_host_marker_us`: the marker kernel's start less the
    host range's (the kernel runs after the range opens, so a negative
    value is the clocks' offset);
  * `kernel_minus_launch_us_min_p50`: over every kernel event, its start
    less that of the runtime or driver call that launched it (linked by
    `correlation`), least and median; a kernel cannot start before its
    launch call, so a negative value is again the clocks' offset.

A count of events after a host marker is wrong by the launches within
that offset of it; the count after a marker kernel is not, as both its
times are the device's.  Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MARK_CYCLES = 1_000     # the marker kernel, ~0.5 us
REF_EVENTS = 50_000     # reference events, as chip_smoke.py's GAN phases


def one_run(dev, data, prof_dir, n_epochs):
    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.kernels.inverse_cdf import counts
    from repro_torch.obs import ObsConfig

    marker = "profile_clocks: epoch 0 done"
    w = dataclasses.replace(PAPER, obs=ObsConfig(profile_dir=prof_dir))
    first = []

    def on_epoch(e, metrics):
        if e == 0:
            torch.cuda.synchronize()
            first.append(counts.launches)
            with torch.profiler.record_function(marker):
                torch.cuda._sleep(MARK_CYCLES)
    counts.reset()
    W.train_stacked(0, w, 2, 4, n_epochs, data, device=dev,
                    on_epoch=on_epoch)
    torch.cuda.synchronize()
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    deltas = sorted(k["ts"] - launch[k["args"]["correlation"]]
                    for k in kernels
                    if k.get("args", {}).get("correlation") in launch)
    t_host = [e["ts"] for e in events if e.get("name") == marker]
    t_dev = [e["ts"] for e in kernels if "spin_kernel" in e.get("name", "")]
    b1 = [e["ts"] for e in kernels if "icdf_kernel" in e.get("name", "")]
    return {
        "launches": counts.launches, "after_epoch0": counts.launches - first[0],
        "kernels": len(kernels), "b1": len(b1),
        "b1_after_host_marker": sum(t > t_host[0] for t in b1)
        if t_host else None,
        "b1_after_device_marker": sum(t > t_dev[0] for t in b1)
        if t_dev else None,
        "marker_kernels": len(t_dev),
        "device_minus_host_marker_us": t_dev[0] - t_host[0]
        if t_host and t_dev else None,
        "kernel_minus_launch_us_min_p50": [deltas[0],
                                           deltas[len(deltas) // 2]]
        if deltas else None,
        "kernels_linked": len(deltas)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import workflow as W
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.problems import get_problem
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), REF_EVENTS, device=dev)
    tmp = tempfile.mkdtemp(prefix="profile_clocks_")
    for run in range(args.runs):
        if run % 2:
            W.train_stacked(0, PAPER, 2, 4, 20, data, device=dev)
        row = one_run(dev, data, os.path.join(tmp, f"run{run}"), args.epochs)
        print(json.dumps(dict(run=run, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
