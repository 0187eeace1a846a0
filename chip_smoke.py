#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     solve service's main-path shape and at ragged and tiny shapes, in fp32
     (rtol 1e-4 / atol 1e-5) and bf16 (2e-2);
  4. time each kernel and its plain version at the main-path shape (CUDA
     events, median of 50 samples of 20 calls each after warm-up; the card's
     time with the stream held while the host enqueues, and the time per
     call back to back with host launch included), beside the least time
     the card could take (its byte or operation bound);
  5. serve: `SolveService(DEFAULT)` on the card, with a 16-rank generator
     stack at the paper's widths (random weights from a seed) written in the
     JAX package's checkpoint layout and loaded through
     `load_generator_stack`; warm every bucket, serve 24 requests across the
     three buckets, check the results and that every solve launched the
     sampler kernel and none took the plain version; per-bucket p50/p99;
  6. solve one batch on the card and on the CPU with the same draws and
     compare, as tests/test_torch_serving.py compares the port with JAX;
  7. profile 8 served requests: the card's busy share and where its time
     goes, by kernel.

The last lines are the `kernels` JSON line, the card's nvidia-smi line, and
`{"ok": true, "device": {...}}`.  Without CUDA, or without the repo's
`src/repro_torch` beside it, the script exits non-zero and prints no result.
It imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
MAIN_SHAPE = (2048, 64, 2)      # sampler u at DEFAULT with 16 ranks
SPIN_CYCLES = 20_000_000        # ~10 ms at 1.98 GHz: outlasts 20 enqueues
RANKS = 16


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def close(a, b, rtol, atol):
    """(ok, max |a - b|) with NaN where both are NaN counted as equal."""
    a, b = a.float(), b.float()
    nan_a, nan_b = a.isnan(), b.isnan()
    if not bool((nan_a == nan_b).all()):
        return False, float("nan")
    a, b = a[~nan_a], b[~nan_b]
    err = (a - b).abs()
    worst = float(err.max()) if err.numel() else 0.0
    return bool((err <= atol + rtol * b.abs()).all()), worst


def cuda_ms(fn, device_only, inner=20, samples=50, warmup=20):
    """Median milliseconds of one call of `fn`, by CUDA events.

    device_only: a spin kernel holds the stream while the host enqueues
    the `inner` calls, so the events time the card's work alone, not the
    host's launch overhead; else calls run back to back as a caller
    issues them, and a host-bound call shows its host time."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def write_stack(directory, widths, ranks, step=1):
    """A random [ranks, ...] generator stack in the JAX package's store
    layout (step_<n>/arrays.npz + meta.json), written with numpy."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        arrays[f"gen/{i}/w"] = (rng.standard_normal((ranks, a, b))
                                * np.sqrt(2.0 / a)).astype(np.float32)
        arrays[f"gen/{i}/b"] = (0.01 * rng.standard_normal((ranks, b))
                                ).astype(np.float32)
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays),
                   "dtypes": {k: str(v.dtype) for k, v in arrays.items()}}, f)
    return arrays


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.checkpoint.store import load_generator_stack
    from repro_torch.configs.serving import DEFAULT
    from repro_torch.core import gan
    from repro_torch.core.workflow import make_solver, solve_draws
    from repro_torch.kernels import build
    from repro_torch.kernels.inverse_cdf import counts, inverse_cdf_channels
    from repro_torch.kernels.ref import inverse_cdf_ref
    from repro_torch.problems import get_problem
    from repro_torch.serving import SolveService

    dev = torch.device("cuda")
    # fp32 matmuls in full fp32 (TF32 off), as the CPU comparison needs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    cap = torch.cuda.get_device_capability(0)
    print(f"[1] card: {smi_line} | capability sm_{cap[0]}{cap[1]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc: {build.build_seconds})")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[2]   {name}: {line.strip()}")

    # -- 3. kernel against its plain version ---------------------------------
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def sampler_inputs(K, E, C, udtype, pdtype=torch.float32):
        u = torch.rand((K, E, C), generator=g).to(dev, udtype)
        mu = (torch.rand((K, C), generator=g) * 4 - 2).to(dev, pdtype)
        s = (torch.rand((K, C), generator=g) * 0.95 + 0.05).to(dev, pdtype)
        k = (torch.rand((K, C), generator=g) * 2 - 1).to(dev, pdtype)
        return u, mu, s, k

    cases = [(MAIN_SHAPE, torch.float32, torch.float32),
             (MAIN_SHAPE, torch.bfloat16, torch.float32),
             ((1000, 77, 1), torch.float32, torch.float32),
             ((1000, 77, 1), torch.bfloat16, torch.float32),
             ((3, 5, 2), torch.float32, torch.float32),
             ((3, 5, 2), torch.bfloat16, torch.bfloat16)]
    max_err_main = None
    for shape, udtype, pdtype in cases:
        u, mu, s, k = sampler_inputs(*shape, udtype, pdtype)
        if shape == (3, 5, 2):      # the clamp's edges and NaN
            u[0, :, 0] = torch.tensor([0.0, 1.0, -1.0, 2.0, float("nan")])
        y = inverse_cdf_channels(u, mu, s, k)
        torch.cuda.synchronize()
        ref = inverse_cdf_ref(u, mu, s, k)
        tol = FP32 if udtype == torch.float32 else BF16
        ok, err = close(y, ref, **tol)
        print(f"[3] inverse_cdf u{list(shape)} {str(udtype)[6:]} (params "
              f"{str(pdtype)[6:]}): max |kernel - plain| = {err:.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok or y.dtype != udtype or y.shape != u.shape:
            fail(f"inverse_cdf kernel disagrees with its plain version at "
                 f"{shape} {udtype}")
        if shape == MAIN_SHAPE and udtype == torch.float32:
            max_err_main = err

    # -- 4. time at the main-path shape --------------------------------------
    u, mu, s, k = sampler_inputs(*MAIN_SHAPE, torch.float32)
    kernel_call = lambda: inverse_cdf_channels(u, mu, s, k)
    plain_call = lambda: inverse_cdf_ref(u, mu, s, k)
    ms = cuda_ms(kernel_call, device_only=True)
    plain_ms = cuda_ms(plain_call, device_only=True)
    call_ms = cuda_ms(kernel_call, device_only=False)
    plain_call_ms = cuda_ms(plain_call, device_only=False)
    n = u.numel()
    n_bytes = 4 * n * 2 + 3 * 4 * mu.numel()   # u in, y out, mu/s/k in
    n_ops = 10 * n      # clamp 2, 1-u, divide, log, s*, +, u-0.5, k*, +
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[4] inverse_cdf u{list(MAIN_SHAPE)} fp32, card time: kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms by "
          f"{bound_by} ({n_bytes} B, {n_ops} fp32 ops); no single PyTorch "
          f"call computes it (library_ms null)")
    print(f"[4] inverse_cdf per call back to back, host launch included: "
          f"kernel wrapper {call_ms:.5f} ms, plain {plain_call_ms:.5f} ms")

    # -- 5. serve ------------------------------------------------------------
    problem = get_problem("proxy1d")
    ckpt = os.path.join(ROOT, "build", "repro_torch", "smoke_ckpt")
    written = write_stack(ckpt, gan.gen_widths(problem.n_params), RANKS)
    rng = np.random.default_rng(SEED)
    requests = []       # made on the card before the counted run
    gdata = torch.Generator(device="cpu").manual_seed(SEED + 1)
    for lo, hi in zip((0,) + DEFAULT.buckets[:-1], DEFAULT.buckets):
        for _ in range(8):
            n_ev = int(rng.integers(lo + 1, hi + 1))
            requests.append(problem.make_reference_data(
                gdata, n_ev, device=dev).cpu().numpy())
    torch.cuda.synchronize()

    counts.reset()                       # --- the counted main-path run ---
    t0 = time.perf_counter()
    svc = SolveService(DEFAULT, device=dev)
    step = svc.register_problem("proxy1d", checkpoint_dir=ckpt)
    svc.warm("proxy1d")
    warm_s = time.perf_counter() - t0
    lat, results, batches = {}, [], 0
    for y in requests:
        t1 = time.perf_counter()
        ticket = svc.submit("proxy1d", y)
        while svc.step():
            batches += 1
        results.append(ticket.result(timeout=60))
        lat.setdefault(ticket.bucket, []).append(time.perf_counter() - t1)
    launches, plain_calls = counts.launches, counts.plain_calls
    # --------------------------------------------------------------------

    stack, _ = load_generator_stack(ckpt, dev)
    for i, layer in enumerate(stack):
        if not np.array_equal(layer["w"].cpu().numpy(), written[f"gen/{i}/w"]):
            fail(f"layer {i} of the loaded stack differs from the stored one")
    if step != 1 or gan.param_count(stack) != RANKS * 51206:
        fail(f"loaded step {step}, {gan.param_count(stack)} parameters")
    calls = svc.cache.stats["compiles"] + batches
    for r in results:
        if not all(np.isfinite(v).all() for v in r.values()):
            fail("non-finite solve result")
        if not ((r["params"] > 0) & (r["params"] < 1)).all() \
                or (r["sigma"] < 0).any():
            fail(f"params outside (0, 1) or negative sigma: {r}")
    if launches != calls or plain_calls != 0:
        fail(f"sampler: {launches} kernel launches and {plain_calls} plain "
             f"calls for {calls} solver calls")
    print(f"[5] served {svc.served} requests in {batches} batches; warm pool "
          f"of {len(svc.cache)} built in {warm_s:.2f}s; stack "
          f"{RANKS}x{gan.param_count(stack) // RANKS} params from step {step}")
    print(f"[5] sampler on the main path: {launches} kernel launches for "
          f"{calls} solver calls, {plain_calls} plain calls")
    first = problem.mean_abs_residual(torch.from_numpy(results[0]["params"]))
    print(f"[5] first solve: residual {float(first):.3f} (random weights), "
          f"score {float(results[0]['score']):.3f}")
    for b in DEFAULT.buckets:
        xs = np.asarray(lat[b]) * 1e3
        print(f"[5] bucket {b:5d}: {len(xs)} requests, request latency p50 "
              f"{np.percentile(xs, 50):.3f} ms, p99 "
              f"{np.percentile(xs, 99):.3f} ms")

    # -- 6. one batch on the card and on the CPU, same draws -----------------
    cfg = DEFAULT.solve
    noise, u_draw = solve_draws(cfg, RANKS, problem, "cpu")
    bucket, B = DEFAULT.buckets[1], DEFAULT.max_batch
    ys = np.zeros((B, bucket, 2), np.float32)
    mask = np.zeros((B, bucket), bool)
    for i in range(B):
        y = requests[8 + i]
        ys[i, :len(y)], mask[i, :len(y)] = y, True
    outs = {}
    for d in ("cpu", "cuda"):
        solver = make_solver(problem, cfg, (noise.to(d), u_draw.to(d)))
        st = [{k: v.to(d) for k, v in layer.items()} for layer in stack]
        ys_d, m_d = torch.from_numpy(ys).to(d), torch.from_numpy(mask).to(d)
        _, scores = solver.scores(st, ys_d, m_d)
        kept = torch.topk(scores, solver.keep(RANKS), dim=1).indices
        outs[d] = (scores.cpu(), kept.cpu(), {
            k: v.cpu() for k, v in solver(st, ys_d, m_d).items()})
    (s_cpu, k_cpu, o_cpu), (s_gpu, k_gpu, o_gpu) = outs["cpu"], outs["cuda"]
    ok, err = close(s_gpu, s_cpu, **FP32)
    if not ok:
        fail(f"candidate scores differ between card and CPU (max {err:.3e})")
    same_rows = []
    for b in range(B):
        diff = set(k_cpu[b].tolist()) ^ set(k_gpu[b].tolist())
        kth = torch.sort(s_cpu[b], descending=True).values[k_cpu.shape[1] - 1]
        if any(abs(float(s_cpu[b, i] - kth)) >= 1e-5 for i in diff):
            fail(f"request {b}: kept sets differ beyond near-ties")
        if not diff:
            same_rows.append(b)
    worst = 0.0
    for key in ("params", "sigma", "score"):
        ok, err = close(o_gpu[key][same_rows], o_cpu[key][same_rows], **FP32)
        worst = max(worst, err)
        if not ok:
            fail(f"{key} differs between card and CPU (max {err:.3e})")
    print(f"[6] one DEFAULT batch (B={B}, bucket {bucket}, R={RANKS}) on the "
          f"card vs the CPU: scores max err {float((s_gpu - s_cpu).abs().max()):.3e}, "
          f"params/sigma/score max err {worst:.3e} on {len(same_rows)}/{B} "
          f"requests with identical kept sets (the rest differ only at "
          f"near-ties < 1e-5)")

    # -- 7. where a request's time goes (profiler over 8 requests) ----------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for y in requests[8:16]:
            ticket = svc.submit("proxy1d", y)
            svc.run_until_empty()
            ticket.result(timeout=60)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:
        busy = {}
        for e in on_card:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
        total = sum(busy.values())
        icdf = [e.time_range.elapsed_us() for e in on_card
                if "icdf_kernel" in e.name]
        p50_us = float(np.percentile(lat[DEFAULT.buckets[1]], 50)) * 1e6
        print(f"[7] 8 bucket-256 requests: {wall_us / 8:.1f} us each on the "
              f"host clock under the profiler, card busy {total / 8:.1f} us "
              f"each ({100 * total / wall_us:.1f}% of the profiled time, "
              f"{100 * total / 8 / p50_us:.1f}% of the unprofiled p50 "
              f"{p50_us:.1f} us; {len(on_card) / 8:.0f} device ops per "
              f"request); sampler kernel "
              f"{statistics.median(icdf):.2f} us per launch "
              f"({len(icdf)} launches)")
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
            print(f"[7]   {us / 8:8.2f} us/request  {name[:90]}")
    else:
        print("[7] the profiler recorded no device events: the card's busy "
              "share is not measured")

    # -- 8. the kernels ------------------------------------------------------
    kernels = [{
        "name": "inverse_cdf",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/inverse_cdf.cu",
        "replaces": "src/repro/kernels/inverse_cdf.py:23",
        "launches": launches,
        "max_abs_err": max_err_main,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
