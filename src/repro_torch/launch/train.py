"""Train an LLM on one device.  Counterpart of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 50 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --smoke --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
        --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
        --steps 30

`--seq` counts tokens, or frames for the audio family (hubert-xlarge:
the stubbed frame features and their labels, `data.make_batch`), or for
the vlm family (internvl2-1b) the patches and the text tokens together:
min(256, seq // 2) stubbed patch embeddings, then the text, whose
positions alone carry the loss.

The flags are the JAX launcher's plus `--device` (CUDA unless `cpu` is
asked for) and `--seed` (the random weights; the JAX launcher uses key 0).
`--mesh` takes only `host`, one device: the multi-device meshes and the
hierarchical sync modes across them are ROADMAP.md queue A item 6; every
`--sync` mode runs the all-reduce step on one device, as the JAX package
does without a mesh.  With `--ckpt-dir` the final state is written once,
after the last step, in the JAX package's checkpoint layout
(`<dir>/step_<steps:08d>/`, `checkpoint.save_checkpoint`), which the JAX
package's `restore_checkpoint` reads into its trainer's state; as in the
JAX launcher, `--ckpt-every` is parsed and not used.  Prints the loss as
it goes, then the SSD scan's (B5) and flash attention's (B4) kernel
launches and plain calls, and for a MoE arch the (token, expert)
assignments its capacity dropped, summed over layers and steps (the
remat recompute included: it routes again under either `remat_policy`,
since "dots" keeps the router's matmul but not its top-k or dispatch).
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenStream
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.moe import Tap
from repro_torch.training import SYNC_MODES, TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sync", choices=SYNC_MODES, default="allreduce")
    ap.add_argument("--sync-h", type=int, default=100)
    ap.add_argument("--mesh", choices=("host", "single", "multi"),
                    default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; the "
            f"multi-device meshes are ROADMAP.md queue A item 6")
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(lr=args.lr, warmup=min(20, args.steps // 5 + 1),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       sync_mode=args.sync, sync_h=args.sync_h)
    tap = Tap()                  # counts the MoE's dropped assignments
    trainer = Trainer(cfg, tcfg, args.seed, device=args.device, tap=tap)
    if trainer.device.type == "cuda":      # the kernels' first-use build
        build.build_all(("ssd_scan", "flash_attention"))
    stream = TokenStream(cfg, args.batch, args.seq, device=trainer.device)
    for c in (ssd.counts, fa.counts):
        c.reset()
    print(f"[train] {cfg.name} on {trainer.device}: batch {args.batch}, seq "
          f"{args.seq}, {args.steps} steps, sync {args.sync} (one device)")
    state = trainer.run(stream, args.steps,
                        log_every=max(args.steps // 20, 1))
    for name, c in (("SSD scan (B5)", ssd.counts),
                    ("flash attention (B4)", fa.counts)):
        print(f"[train] {name}: {c.launches} kernel launches, "
              f"{c.plain_calls} plain calls, {c.backward_plain} backward "
              f"passes (the VJP of the plain version)")
    if tap.calls:
        print(f"[train] MoE: {tap.dropped} (token, expert) assignments "
              f"dropped by capacity over {tap.calls} run_moe calls (every "
              f"layer's forward and its remat recompute)")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, int(state["step"]), state)
        print(f"checkpoint written to {args.ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
