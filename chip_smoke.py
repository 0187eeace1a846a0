#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     solve service's main-path shapes and at ragged, tiny and bf16 shapes:
     the sampler (B1) at fp32 rtol 1e-4 / atol 1e-5 and bf16 2e-2, the mask
     (B2) bitwise over a sweep of threads per block, the blur (B3) at
     rtol/atol 1e-6 over a sweep of images per block;
  4. time each kernel, its plain version and, where one exists, the one
     PyTorch call that computes the same function, at the main-path shape
     (CUDA events, median of 50 samples of 20 calls each after warm-up; the
     card's time with the stream held while the host enqueues, and the time
     per call back to back with host launch included), beside the least
     time the card could take (its byte or operation bound);
  5. serve proxy1d: `SolveService(DEFAULT)` on the card, with a 16-rank
     generator stack at the paper's widths (random weights from a seed)
     written in the JAX package's checkpoint layout and loaded through
     `load_generator_stack`; warm every bucket, serve 24 requests across
     the three buckets, check the results and that every solve launched the
     sampler kernel and none took the plain version; per-bucket p50/p99;
  6. solve one proxy1d batch on the card and on the CPU with the same draws
     and compare, as tests/test_torch_serving.py compares the port with JAX;
  7. profile 8 served proxy1d requests: the card's busy share and where its
     time goes, by kernel;
  8. serve imaging and imaging_blur the same way, each with a 16-rank stack
     of the full-width conv generator (292,545 parameters a rank, random
     weights from a seed) carried in from numpy by
     `conv_generator_from_numpy` and registered with `gen_stack=`; every
     solver call must launch the sampler once and the mask (imaging) or the
     blur (imaging_blur) once, and nothing must take a plain version;
  9. one DEFAULT batch per imaging problem on the card and on the CPU;
 10. profile 8 served requests per imaging problem.

Each served path runs with every kernel count set to 0 just before it and
read just after it.  The last lines are the `kernels` JSON line, the card's
nvidia-smi line, and `{"ok": true, "device": {...}}`.  Without CUDA, or
without the repo's `src/repro_torch` beside it, the script exits non-zero
and prints no result.  It imports nothing of JAX.
"""
import itertools
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
BLUR = dict(rtol=1e-6, atol=1e-6)
TIE_GAP = 1e-5                  # kept sets may differ only within this
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
MAIN_SHAPE = (2048, 64, 2)      # sampler u at DEFAULT with 16 ranks
MASK_SHAPE = (2048, 1024)       # mask x at DEFAULT: 16 ranks x 128 cands
BLUR_SHAPE = (2048, 32, 32)     # blur x at DEFAULT
L2_ROTATION = 8                 # B2/B3 input sets cycled: 67 MB > the 50 MB L2
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


def rotating(call, arg_sets):
    """A no-argument call that takes the next of `arg_sets` each time."""
    it = itertools.cycle(arg_sets)
    return lambda: call(*next(it))


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and fp32 operations over its fp32 rate."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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


def conv_stack_arrays(leaf_shapes, ranks):
    """A random [ranks, ...] conv generator stack as the JAX package's
    path-flattened numpy arrays ("proj/w", "convs/0/w", ...): Kaiming-normal
    weights (fan-in = all but the last axis) and small non-zero biases."""
    rng = np.random.default_rng(SEED + 2)
    arrays = {}
    for key, shape in leaf_shapes.items():
        if key.endswith("/w"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal((ranks,) + shape) * np.sqrt(2.0 / fan_in)
        else:
            a = 0.01 * rng.standard_normal((ranks,) + shape)
        arrays[key] = a.astype(np.float32)
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
    import torch.nn.functional as F
    from repro_torch.checkpoint.store import (conv_generator_from_numpy,
                                              load_generator_stack)
    from repro_torch.configs.serving import DEFAULT
    from repro_torch.core import gan
    from repro_torch.core.workflow import make_solver, solve_draws
    from repro_torch.kernels import build
    from repro_torch.kernels import imaging as kimaging
    from repro_torch.kernels.inverse_cdf import counts, inverse_cdf_channels
    from repro_torch.kernels.ref import (BLUR_W0, BLUR_W1, blur2d_ref,
                                         inverse_cdf_ref, mask_apply_ref)
    from repro_torch.models import convgen
    from repro_torch.problems import get_problem
    from repro_torch.serving import SolveService

    dev = torch.device("cuda")
    # fp32 matmuls in full fp32 (TF32 off, PyTorch's default), as the CPU
    # comparison needs.  cuDNN's TF32 flag is left as it stands: the conv
    # generator switches it off around its own call, and phase 8 checks
    # that the flag is unchanged afterwards.
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    all_counts = {"inverse_cdf": counts, "mask_apply": kimaging.mask_counts,
                  "blur2d": kimaging.blur_counts}

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    cap = torch.cuda.get_device_capability(0)
    print(f"[1] card: {smi_line} | capability sm_{cap[0]}{cap[1]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | cudnn.allow_tf32 {cudnn_tf32}")

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

    # -- 3. kernels against their plain versions -----------------------------
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def sampler_inputs(K, E, C, udtype, pdtype=torch.float32):
        u = torch.rand((K, E, C), generator=g).to(dev, udtype)
        mu = (torch.rand((K, C), generator=g) * 4 - 2).to(dev, pdtype)
        s = (torch.rand((K, C), generator=g) * 0.95 + 0.05).to(dev, pdtype)
        k = (torch.rand((K, C), generator=g) * 2 - 1).to(dev, pdtype)
        return u, mu, s, k

    cases = [(MAIN_SHAPE, torch.float32, torch.float32),
             (MAIN_SHAPE, torch.bfloat16, torch.float32),
             ((2048, 64, 1), torch.float32, torch.float32),
             ((1000, 77, 1), torch.float32, torch.float32),
             ((1000, 77, 1), torch.bfloat16, torch.float32),
             ((3, 5, 2), torch.float32, torch.float32),
             ((3, 5, 2), torch.bfloat16, torch.bfloat16)]
    max_err = {}
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
            max_err["inverse_cdf"] = err

    for shape, dtype, mdtype in [(MASK_SHAPE, torch.float32, torch.float32),
                                 (MASK_SHAPE, torch.bfloat16, torch.float32),
                                 ((257, 130), torch.float32, torch.bfloat16),
                                 ((7, 100), torch.bfloat16, torch.bfloat16),
                                 ((1, 32), torch.float32, torch.float32)]:
        x = torch.randn(shape, generator=g).to(dev, dtype)
        m = (torch.rand(shape[1], generator=g) > 0.4).to(dev, mdtype)
        want = mask_apply_ref(x, m)
        for threads in (32, 96, 256, 1024):
            y = kimaging.mask_apply(x, m, threads=threads)
            torch.cuda.synchronize()
            if y.dtype != dtype or not torch.equal(y, want):
                fail(f"mask_apply kernel is not bitwise its plain version at "
                     f"{shape} {dtype} (mask {mdtype}), {threads} threads")
        print(f"[3] mask_apply x{list(shape)} {str(dtype)[6:]} (mask "
              f"{str(mdtype)[6:]}): bitwise equal to the plain version at "
              f"32, 96, 256 and 1024 threads per block")
        if shape == MASK_SHAPE and dtype == torch.float32:
            max_err["mask_apply"] = float((y - want).abs().max())

    for shape, dtype in [(BLUR_SHAPE, torch.float32),
                         (BLUR_SHAPE, torch.bfloat16),
                         ((33, 64, 48), torch.float32),
                         ((20, 16, 24), torch.bfloat16),
                         ((1, 8, 8), torch.float32)]:
        x = torch.randn(shape, generator=g).to(dev, dtype)
        want = blur2d_ref(x)
        worst = 0.0
        for images in (1, 3, 4, 8):
            y = kimaging.blur2d(x, images=images)
            torch.cuda.synchronize()
            ok, err = close(y, want, **BLUR)
            worst = max(worst, err)
            if not ok or y.dtype != dtype:
                fail(f"blur2d kernel disagrees with its plain version at "
                     f"{shape} {dtype}, {images} images per block (max "
                     f"{err:.3e})")
        print(f"[3] blur2d x{list(shape)} {str(dtype)[6:]}: max |kernel - "
              f"plain| = {worst:.3e} over 1, 3, 4 and 8 images per block "
              f"(rtol/atol 1e-6) ok")
        if shape == BLUR_SHAPE and dtype == torch.float32:
            max_err["blur2d"] = worst

    # -- 4. time at the main-path shapes -------------------------------------
    def timed(kernel, plain, library, arg_sets, n_bytes, n_ops):
        """Card and back-to-back times of the kernel, its plain version and
        the library call (None: there is none), cycling `arg_sets`."""
        k, p = rotating(kernel, arg_sets), rotating(plain, arg_sets)
        t = dict(ms=cuda_ms(k, device_only=True),
                 plain_ms=cuda_ms(p, device_only=True),
                 library_ms=None if library is None else cuda_ms(
                     rotating(library, arg_sets), device_only=True),
                 call_ms=cuda_ms(k, device_only=False),
                 plain_call_ms=cuda_ms(p, device_only=False),
                 bytes=n_bytes, ops=n_ops)
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops)
        return t

    timing = {}
    u, mu, s, k = sampler_inputs(*MAIN_SHAPE, torch.float32)
    # u in, y out, mu/s/k in; clamp 2, 1-u, divide, log, s*, +, u-0.5, k*, +
    # per element
    timing["inverse_cdf"] = timed(
        inverse_cdf_channels, inverse_cdf_ref, None, [(u, mu, s, k)],
        4 * u.numel() * 2 + 3 * 4 * mu.numel(), 10 * u.numel())

    m = (torch.rand(MASK_SHAPE[1], generator=g) > 0.4).to(dev, torch.float32)
    sets = [(torch.randn(MASK_SHAPE, generator=g).to(dev), m)
            for _ in range(L2_ROTATION)]
    # x in, y out, m in; one product per element
    timing["mask_apply"] = timed(
        kimaging.mask_apply, mask_apply_ref, lambda x, m: x * m[None], sets,
        2 * 4 * sets[0][0].numel() + 4 * m.numel(), sets[0][0].numel())

    sets = [(torch.randn(BLUR_SHAPE, generator=g).to(dev),)
            for _ in range(L2_ROTATION)]
    taps = torch.tensor([BLUR_W1, BLUR_W0, BLUR_W1], device=dev)
    stencil = torch.outer(taps, taps)[None, None]
    cudnn = torch.backends.cudnn

    def library_blur(x):
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return F.conv2d(x[:, None], stencil, padding=1)[:, 0]

    ok, err = close(library_blur(*sets[0]), blur2d_ref(*sets[0]), **FP32)
    if not ok:
        fail(f"the library blur computes another function than the plain "
             f"version (max err {err:.3e})")
    print(f"[4] the library blur (cuDNN conv2d, TF32 off) against the plain "
          f"version: max err {err:.3e} (rtol 1e-4, atol 1e-5; it is timed "
          f"only, never called by the port)")
    # x in, y out; per pixel 2 adds and 2 products in each pass
    timing["blur2d"] = timed(
        kimaging.blur2d, blur2d_ref, library_blur, sets,
        2 * 4 * sets[0][0].numel(), 8 * sets[0][0].numel())
    del sets

    shapes = {"inverse_cdf": f"u{list(MAIN_SHAPE)}",
              "mask_apply": f"x{list(MASK_SHAPE)}",
              "blur2d": f"x{list(BLUR_SHAPE)}"}
    for name, t in timing.items():
        lib = (f"one PyTorch call {t['library_ms']:.5f} ms"
               if t["library_ms"] is not None
               else "no single PyTorch call computes it (library_ms null)")
        print(f"[4] {name} {shapes[name]} fp32, card time: kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, {lib}; bound "
              f"{t['bound_ms']:.6f} ms by {t['bound_by']} ({t['bytes']} B, "
              f"{t['ops']} fp32 ops)")
        print(f"[4] {name} per call back to back, host launch included: "
              f"kernel wrapper {t['call_ms']:.5f} ms, plain "
              f"{t['plain_call_ms']:.5f} ms")
    print(f"[4] mask_apply and blur2d cycle {L2_ROTATION} input sets (a "
          f"working set above the 50 MB L2); inverse_cdf reuses one")

    # -- the served paths ----------------------------------------------------
    def make_requests(problem):
        """8 requests per bucket, made on the card before the counted run."""
        rng = np.random.default_rng(SEED)
        gdata = torch.Generator(device="cpu").manual_seed(SEED + 1)
        out = []
        for lo, hi in zip((0,) + DEFAULT.buckets[:-1], DEFAULT.buckets):
            for _ in range(8):
                n_ev = int(rng.integers(lo + 1, hi + 1))
                out.append(problem.make_reference_data(
                    gdata, n_ev, device=dev).cpu().numpy())
        torch.cuda.synchronize()
        return out

    def serve(tag, name, requests, forward, **registration):
        """Serve `requests` through a fresh DEFAULT service, with every
        kernel count set to 0 just before and read just after.  Fails
        unless each solver call launched the sampler and `forward` (None:
        no other kernel) once and nothing took a plain version."""
        for c in all_counts.values():
            c.reset()                  # --- the counted main-path run ---
        t0 = time.perf_counter()
        svc = SolveService(DEFAULT, device=dev)
        step = svc.register_problem(name, **registration)
        svc.warm(name)
        warm_s = time.perf_counter() - t0
        lat, results, batches = {}, [], 0
        for y in requests:
            t1 = time.perf_counter()
            ticket = svc.submit(name, y)
            while svc.step():
                batches += 1
            results.append(ticket.result(timeout=60))
            lat.setdefault(ticket.bucket, []).append(
                time.perf_counter() - t1)
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        # ------------------------------------------------------------------
        calls = svc.cache.stats["compiles"] + batches
        want = {k: ((calls if k in ("inverse_cdf", forward) else 0), 0)
                for k in all_counts}
        if got != want:
            fail(f"{name}: (kernel launches, plain calls) {got} for {calls} "
                 f"solver calls; expected {want}")
        problem = get_problem(name)
        for r in results:
            if not all(np.isfinite(v).all() for v in r.values()):
                fail(f"{name}: non-finite solve result")
            if r["params"].shape != (problem.n_params,) \
                    or not ((r["params"] > 0) & (r["params"] < 1)).all() \
                    or (r["sigma"] < 0).any():
                fail(f"{name}: params outside (0, 1), of the wrong shape, "
                     f"or negative sigma")
        print(f"[{tag}] {name}: served {svc.served} requests in {batches} "
              f"batches; warm pool of {len(svc.cache)} built in "
              f"{warm_s:.2f}s")
        print(f"[{tag}] {name} on the main path, per kernel (launches, plain "
              f"calls) for {calls} solver calls: {got}")
        first = problem.mean_abs_residual(
            torch.from_numpy(results[0]["params"]))
        print(f"[{tag}] {name} first solve: residual {float(first):.3f} "
              f"(random weights), score {float(results[0]['score']):.3f}")
        for b in DEFAULT.buckets:
            xs_ms = np.asarray(lat[b]) * 1e3
            print(f"[{tag}] {name} bucket {b:5d}: {len(xs_ms)} requests, "
                  f"request latency p50 {np.percentile(xs_ms, 50):.3f} ms, "
                  f"p99 {np.percentile(xs_ms, 99):.3f} ms")
        return svc, step, lat, got

    def card_vs_cpu(tag, name, stack, requests):
        """One DEFAULT batch (bucket 256) on the card and on the CPU with
        the same draws: scores at fp32 tolerance, kept sets equal up to
        near-ties, params/sigma/score at fp32 tolerance where equal."""
        problem = get_problem(name)
        cfg = DEFAULT.solve
        noise, u_draw = solve_draws(cfg, RANKS, problem, "cpu")
        bucket, B = DEFAULT.buckets[1], DEFAULT.max_batch
        ys = np.zeros((B, bucket, problem.obs_dim), np.float32)
        mask = np.zeros((B, bucket), bool)
        for i in range(B):
            y = requests[8 + i]
            ys[i, :len(y)], mask[i, :len(y)] = y, True
        outs = {}
        for d in ("cpu", "cuda"):
            solver = make_solver(problem, cfg, (noise.to(d), u_draw.to(d)))
            st = gan.map_leaves(lambda t: t.to(d), stack)
            ys_d = torch.from_numpy(ys).to(d)
            m_d = torch.from_numpy(mask).to(d)
            _, scores = solver.scores(st, ys_d, m_d)
            kept = torch.topk(scores, solver.keep(RANKS), dim=1).indices
            outs[d] = (scores.cpu(), kept.cpu(), {
                k: v.cpu() for k, v in solver(st, ys_d, m_d).items()})
        (s_cpu, k_cpu, o_cpu), (s_gpu, k_gpu, o_gpu) = outs["cpu"], outs["cuda"]
        ok, err = close(s_gpu, s_cpu, **FP32)
        if not ok:
            fail(f"{name}: candidate scores differ between card and CPU "
                 f"(max {err:.3e})")
        same_rows = []
        for b in range(B):
            diff = set(k_cpu[b].tolist()) ^ set(k_gpu[b].tolist())
            kth = torch.sort(s_cpu[b], descending=True).values[
                k_cpu.shape[1] - 1]
            if any(abs(float(s_cpu[b, i] - kth)) >= TIE_GAP for i in diff):
                fail(f"{name} request {b}: kept sets differ beyond "
                     f"near-ties")
            if not diff:
                same_rows.append(b)
        worst = 0.0
        for key in ("params", "sigma", "score"):
            ok, err = close(o_gpu[key][same_rows], o_cpu[key][same_rows],
                            **FP32)
            worst = max(worst, err)
            if not ok:
                fail(f"{name}: {key} differs between card and CPU (max "
                     f"{err:.3e})")
        print(f"[{tag}] {name}: one DEFAULT batch (B={B}, bucket {bucket}, "
              f"R={RANKS}) on the card vs the CPU: scores max err "
              f"{float((s_gpu - s_cpu).abs().max()):.3e}, params/sigma/score "
              f"max err {worst:.3e} on {len(same_rows)}/{B} requests with "
              f"identical kept sets (the rest differ only at near-ties "
              f"< {TIE_GAP})")

    def profile(tag, svc, name, requests, lat):
        """Where the card's time goes over 8 bucket-256 requests."""
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for y in requests[8:16]:
                ticket = svc.submit(name, y)
                svc.run_until_empty()
                ticket.result(timeout=60)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not on_card:
            print(f"[{tag}] {name}: the profiler recorded no device events: "
                  f"the card's busy share is not measured")
            return
        busy = {}
        for e in on_card:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
        total = sum(busy.values())
        p50_us = float(np.percentile(lat[DEFAULT.buckets[1]], 50)) * 1e6
        print(f"[{tag}] {name}, 8 bucket-256 requests: {wall_us / 8:.1f} us "
              f"each on the host clock under the profiler, card busy "
              f"{total / 8:.1f} us each ({100 * total / wall_us:.1f}% of the "
              f"profiled time, {100 * total / 8 / p50_us:.1f}% of the "
              f"unprofiled p50 {p50_us:.1f} us; {len(on_card) / 8:.0f} device "
              f"ops per request)")
        for kname in ("icdf_kernel", "mask_kernel", "blur_kernel"):
            us = [e.time_range.elapsed_us() for e in on_card
                  if kname in e.name]
            if us:
                print(f"[{tag}]   {kname}: {statistics.median(us):.2f} us "
                      f"per launch ({len(us)} launches)")
        for kname, us in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[{tag}]   {us / 8:8.2f} us/request "
                  f"({100 * us / total:4.1f}%)  {kname[:90]}")

    # -- 5-7. proxy1d --------------------------------------------------------
    problem = get_problem("proxy1d")
    ckpt = os.path.join(ROOT, "build", "repro_torch", "smoke_ckpt")
    written = write_stack(ckpt, gan.gen_widths(problem.n_params), RANKS)
    requests = make_requests(problem)
    svc, step, lat, got = serve("5", "proxy1d", requests, None,
                                checkpoint_dir=ckpt)
    launches = {"inverse_cdf": got["inverse_cdf"][0]}
    stack, _ = load_generator_stack(ckpt, dev)
    for i, layer in enumerate(stack):
        if not np.array_equal(layer["w"].cpu().numpy(), written[f"gen/{i}/w"]):
            fail(f"layer {i} of the loaded stack differs from the stored one")
    if step != 1 or gan.param_count(stack) != RANKS * 51206:
        fail(f"loaded step {step}, {gan.param_count(stack)} parameters")
    print(f"[5] proxy1d stack {RANKS}x{gan.param_count(stack) // RANKS} "
          f"params from checkpoint step {step}")
    card_vs_cpu("6", "proxy1d", stack, requests)
    profile("7", svc, "proxy1d", requests, lat)

    # -- 8-10. imaging and imaging_blur --------------------------------------
    for name, forward in (("imaging", "mask_apply"),
                          ("imaging_blur", "blur2d")):
        problem = get_problem(name)
        shapes_one = convgen.leaf_shapes(problem.param_shape, gan.NOISE_DIM)
        arrays = conv_stack_arrays(shapes_one, RANKS)
        stack = conv_generator_from_numpy(arrays, dev)
        if gan.param_count(stack) != RANKS * 292545:
            fail(f"{name}: conv stack of {gan.param_count(stack)} parameters")
        requests = make_requests(problem)
        svc, _, lat, got = serve("8", name, requests, forward,
                                 gen_stack=stack)
        launches["inverse_cdf"] += got["inverse_cdf"][0]
        launches[forward] = got[forward][0]
        if torch.backends.cudnn.allow_tf32 != cudnn_tf32:
            fail(f"{name}: the solve changed cudnn.allow_tf32 to "
                 f"{torch.backends.cudnn.allow_tf32}")
        print(f"[8] {name}: stack {RANKS}x292545 conv params from numpy; "
              f"cudnn.allow_tf32 still {cudnn_tf32} after serving")
        card_vs_cpu("9", name, stack, requests)
        profile("10", svc, name, requests, lat)

    # -- the kernels ---------------------------------------------------------
    sources = {"inverse_cdf": ("src/repro_torch/kernels/csrc/inverse_cdf.cu",
                               "src/repro/kernels/inverse_cdf.py:23"),
               "mask_apply": ("src/repro_torch/kernels/csrc/imaging.cu",
                              "src/repro/kernels/imaging.py:45"),
               "blur2d": ("src/repro_torch/kernels/csrc/imaging.cu",
                          "src/repro/kernels/imaging.py:87")}
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches.get(name, 0) < 1:
            fail(f"{name} was launched no time on the main paths")
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
