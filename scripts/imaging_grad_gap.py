#!/usr/bin/env python3
"""Where the imaging generator's card-vs-CPU gradient gap comes from.

    python3 scripts/imaging_grad_gap.py [--seeds 16] [--problem imaging]
                                        [--device cuda]

`chip_smoke.py` phase 23 holds one epoch's generator gradients on the
card against the CPU's at 1e-3 in relative norm (worst leaf).  The flat
problems agree to ~1e-7 that way; imaging's conv generator differed by
~1e-4, so phase 27 compares at the card's Leaky ReLU signs instead.
This script tests the cause: a Leaky ReLU pre-activation within
fp32 rounding of zero takes the other sign on the other device.  The
forward value barely moves (the function is continuous at 0), but the
local slope jumps from 1 to 0.01, and every gradient upstream of that
element moves with it.

For each seed, from phase 27's state and draws (the first, 23, is phase
27's own: full width, REDUCED batch sizes, R 4, h 1, fp32, TF32 off), it
computes `rank_grads` five ways:

  * on `--device` in fp32 (the card),
  * on the CPU in fp32,
  * on the CPU in float64 (the forward model's kernels replaced by their
    float64 arithmetic; sites are chosen from the fp32 uniforms, as on
    both fp32 sides), the exact answer to within fp32's reach,
  * on the CPU in fp32 with every Leaky ReLU's slope taken from the
    card's pre-activation signs (the card's kink pattern pinned, with
    `chip_smoke.leaky_kinks`, as phase 27 pins it),
  * on the CPU in fp32 at float64's signs (the mechanism, checked
    without the card).

It prints, per seed, the worst generator leaf in relative norm for card
vs CPU, pinned vs card, CPU vs float64, CPU at float64's signs vs
float64 and card vs float64, and the number of pre-activations on the
generator's gradient path whose sign differs between card and CPU (and
between CPU and float64).  If the kinks are the cause, pinning
closes the gap to the flat problems' ~1e-7, seeds without a flip show
no gap, and both fp32 sides sit about as far from float64.

With `--device cpu` the "card" is a second CPU run (no gap; a check of
the script itself).  Needs no JAX.
"""
import argparse
import dataclasses
import os
import sys
import unittest.mock as mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch                                    # noqa: E402
import torch.nn.functional as F                 # noqa: E402

from chip_smoke import leaky_kinks              # noqa: E402

SEED = 23                                       # chip_smoke.py phase 27
REF_EVENTS, RANKS = 5_000, 4


def float64_model(pim):
    """The forward model's kernels as float64 arithmetic (the plain
    versions compute in fp32)."""
    def icdf(u, mu, s, k):
        uc = torch.clamp(u, 1e-6, 1.0 - 1e-6)
        return (mu[:, None] + s[:, None] * torch.log(uc / (1.0 - uc))
                + k[:, None] * (uc - 0.5))

    def blur(x):
        up = F.pad(x[:, 1:, :], (0, 0, 0, 1))
        down = F.pad(x[:, :-1, :], (0, 0, 1, 0))
        v = 0.5 * x + 0.25 * (up + down)
        return 0.5 * v + 0.25 * (F.pad(v[:, :, 1:], (0, 1))
                                 + F.pad(v[:, :, :-1], (1, 0)))
    site = pim.site_index
    return [mock.patch.object(pim, "inverse_cdf", icdf),
            mock.patch.object(pim, "blur2d", blur),
            mock.patch.object(pim, "mask_apply",
                              lambda x, m: x * m[None].to(x.dtype)),
            mock.patch.object(pim, "site_index",
                              lambda u0, n: site(u0.float(), n))]


def grads(inputs, wcfg, device, dtype=torch.float32, signs=None):
    """(generator gradient leaves, pre-activations in call order)."""
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_leaves, tree_map
    import repro_torch.problems.imaging as pim

    def move(tree):
        return tree_map(lambda t: t.to(device, dtype) if t.is_floating_point()
                        else t.to(device), tree)
    state, per_rank, draws = (move(t) for t in inputs)
    record = []
    patches = float64_model(pim) if dtype == torch.float64 else []
    for p in patches:
        p.start()
    try:
        with leaky_kinks(record, signs):
            _, g, _ = W.rank_grads(state, per_rank, draws, wcfg)
    finally:
        for p in patches:
            p.stop()
    return ([t.detach().cpu().double() for t in tree_leaves(g)],
            [t.cpu() for t in record])


def worst(a, b):
    return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--problem", default="imaging")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card; pass --device cpu to check the script itself",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.sagips_gan import PAPER, REDUCED, for_problem
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_map

    base = for_problem(args.problem, REDUCED)
    wcfg = dataclasses.replace(
        for_problem(args.problem, PAPER),
        n_param_samples=base.n_param_samples,
        events_per_sample=base.events_per_sample,
        sync=dataclasses.replace(PAPER.sync, h=1))
    prob = wcfg.problem_obj
    print(f"{args.problem}: K {wcfg.n_param_samples}, E "
          f"{wcfg.events_per_sample}, R {RANKS}, fp32 (TF32 off); "
          f"generator gradient, worst leaf in relative norm; flips: "
          f"pre-activations on the generator's gradient path whose sign "
          f"differs between {args.device} and CPU")
    gaps, offs = [], []
    for s in range(args.seeds):
        g = torch.Generator().manual_seed(SEED + s)
        data = prob.make_reference_data(g, REF_EVENTS, device="cpu")
        state, per_rank = W.init_run(g, RANKS, wcfg, data, "cpu")
        tree_map(lambda t: torch.randn(t.shape, generator=g),
                 state["sync"]["mailbox"])     # phase 27's mailbox draw
        draws = W.make_draws(g, wcfg, RANKS, per_rank.shape[1])
        inputs = (state, per_rank, draws)
        card, pre_card = grads(inputs, wcfg, args.device)
        cpu, pre_cpu = grads(inputs, wcfg, "cpu")
        exact, pre_exact = grads(inputs, wcfg, "cpu", torch.float64)
        pinned, _ = grads(inputs, wcfg, "cpu",
                          signs=[p > 0 for p in pre_card])
        pinned64, _ = grads(inputs, wcfg, "cpu",
                            signs=[p > 0 for p in pre_exact])
        # call order: the generator's activations, then the
        # discriminator's on real, on detached fake (the discriminator's
        # step) and on fake (the generator's loss): only the first and the
        # last group lie on the generator's gradient path
        n_disc = len(state["disc"]) - 1
        total = len(pre_card)
        path = (list(range(total - 3 * n_disc))
                + list(range(total - n_disc, total)))
        flips = [int(((pre_card[i] > 0) != (pre_cpu[i] > 0)).sum())
                 for i in path]
        flips64 = sum(int(((pre_exact[i] > 0) != (pre_cpu[i] > 0)).sum())
                      for i in path)
        gap, off = worst(card, cpu), worst(cpu, exact)
        gaps.append(gap)
        offs.append(off)
        print(f"seed {SEED + s}: card vs CPU {gap:.3e} with {sum(flips)} "
              f"flips {flips}, CPU with the card's kinks vs card "
              f"{worst(pinned, card):.3e}; CPU vs float64 {off:.3e} with "
              f"{flips64} flips, CPU with float64's kinks vs float64 "
              f"{worst(pinned64, exact):.3e}; card vs float64 "
              f"{worst(card, exact):.3e}")
    for what, v in (("card vs CPU", gaps), ("CPU vs float64", offs)):
        v = sorted(v)
        print(f"{what} over {args.seeds} seeds: max {v[-1]:.3e}, median "
              f"{v[len(v) // 2]:.3e}, {sum(x > 1e-5 for x in v)} above "
              f"1e-5")
    return 0


if __name__ == "__main__":
    sys.exit(main())
