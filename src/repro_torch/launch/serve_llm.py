"""Serve an LLM with batched requests: prefill + batched decode.

Counterpart of `examples/serve_llm.py`: the engine's mechanics (the
ring-buffer KV cache, the flash-attention kernel B4 in prefill; for
mamba2-130m and the hybrid jamba-1.5-large-398b the SSM state and conv
window, in plain PyTorch; for the MoE archs and the hybrid the routed
experts) with a freshly initialized model (random weights from
`--seed`), not its text.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --arch tinyllama-1.1b --batch 8 --prompt-len 1024 --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke \\
        --device cpu --window 16
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke \\
        --device cpu --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke \\
        --device cpu --arch jamba-1.5-large-398b

The prompts are text only, as the JAX example's are: an encoder-only
arch (hubert-xlarge) and a VLM (internvl2-1b) exit with a message.  A
VLM's image-plus-prompt batch (`data.make_batch`) is served by
`serving.make_prefill_fn` and then `make_serve_step`, as `chip_smoke.py`
does.

Runs the arch's full config on CUDA unless asked otherwise: `--smoke`
takes its smoke-test reduction (the JAX example always does), and
`--device cpu` runs the plain PyTorch path on the CPU.  The full
jamba-1.5-large-398b (397.7 B parameters) fits no one card, as it fits
no one device of the JAX package: serve its smoke config here, and see
`chip_smoke.py` (phases 56-58) for one period of it at full width.
Prints the throughput including prefill, the steady-state decode time
per step, B4's launches and plain calls, and for a MoE arch the (token,
expert) assignments its capacity dropped, summed over layers and steps.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as M
from repro_torch.models.moe import Tap
from repro_torch.serving import generate, make_prefill_fn, make_serve_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window width (ring-buffer KV cache)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke-test config, not its full one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only — no decode step")
    if cfg.family == "vlm":
        raise SystemExit(
            f"{args.arch} takes an image with its prompt, and this CLI's "
            f"prompts are text only: serve its image-plus-prompt batch "
            f"(data.make_batch) with serving.make_prefill_fn, then "
            f"make_serve_step")
    if args.window:
        cfg = cfg.replace(sliding_window=args.window)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init(gen, cfg, device)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    print(f"[serve_llm] {cfg.name} ({M.param_count(params):,} parameters, "
          f"{cfg.dtype}) on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    if device.type == "cuda":      # the kernel's first-use build, untimed
        build.build_all(("flash_attention",))
    fa.counts.reset()
    tap = Tap()                  # counts the MoE's dropped assignments
    _sync(device)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, args.new_tokens,
                   temperature=args.temperature, generator=gen, tap=tap)
    _sync(device)
    dt = time.perf_counter() - t0
    n_new = args.batch * args.new_tokens
    print(f"served batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens} in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s incl. prefill)")
    print("generated ids (request 0):", out[0, args.prompt_len:].tolist())
    print(f"[serve_llm] flash attention (B4): {fa.counts.launches} kernel "
          f"launches, {fa.counts.plain_calls} plain calls")
    if tap.calls:
        print(f"[serve_llm] MoE: {tap.dropped} (token, expert) assignments "
              f"dropped by capacity over {tap.calls} run_moe calls "
              f"(prefill and decode, every layer)")

    # steady-state decode throughput
    step_fn = make_serve_step(cfg)
    prefill_fn = make_prefill_fn(cfg)
    with torch.no_grad():
        _, cache = prefill_fn(params, {"tokens": prompts},
                              args.prompt_len + args.new_tokens + 8,
                              last_logits_only=True)
        tok = out[:, -1:]
        _, cache = step_fn(params, tok, cache)      # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(8):
            _, cache = step_fn(params, tok, cache)
        _sync(device)
    dt = (time.perf_counter() - t0) / 8
    print(f"steady-state decode: {dt * 1e3:.1f} ms/step "
          f"({args.batch / dt:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
