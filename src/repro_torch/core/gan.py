"""The paper's generator MLP — the solve path's half of `repro.core.gan`.

    generator  noise(135) -> 128 -> 128 -> 128 -> 6   = 51,206 params

(§V-A: Leaky ReLU hidden activations, Kaiming-normal init, sigmoid head
bounding the parameters to the unit cube.)  A generator is a list of
layers `{"w": [in, out], "b": [out]}` — the JAX package's layout, so a
checkpoint's path-flattened keys ("0/w", "0/b", ...) map one to one — and
a stack of R generators carries a leading `[R, ...]` axis on every leaf.
The discriminator comes with the training path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .. import resolve_device

NOISE_DIM = 135
N_PARAMS = 6                     # p_0..p_5 of the loop-closure test
GEN_WIDTHS = (NOISE_DIM, 128, 128, 128, N_PARAMS)
LEAK = 0.01

Generator = List[Dict[str, torch.Tensor]]


def gen_widths(n_params=None):
    """Generator widths for a problem with `n_params` outputs (only the
    output width varies per problem)."""
    return GEN_WIDTHS[:-1] + (GEN_WIDTHS[-1] if n_params is None
                              else n_params,)


def init_mlp(generator: torch.Generator, widths: Sequence[int], ranks=None,
             device=None) -> Generator:
    """Kaiming-normal MLP init (paper §V-A), drawn from `generator` on its
    own device.  `ranks=R` stacks R independent MLPs on a leading axis."""
    dev = resolve_device(device)
    lead = () if ranks is None else (ranks,)
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        w = torch.randn(lead + (a, b), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / a)
        layers.append({"w": w.to(dev), "b": torch.zeros(lead + (b,),
                                                       device=dev)})
    return layers


def init_generator(generator: torch.Generator, n_params=None, ranks=None,
                   device=None) -> Generator:
    """The paper's MLP generator in fp32 (`ranks=R`: an [R, ...] stack)."""
    return init_mlp(generator, gen_widths(n_params), ranks, device)


def mlp_apply(params: Generator, x, final_activation=None):
    """x [..., in] through the MLP.  With a stacked generator, x is
    [R, M, in] and each rank's matmul is one batch of `torch.matmul`
    (the `jax.vmap` of the JAX solver)."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < len(params) - 1:
            x = F.leaky_relu(x, LEAK)
    if final_activation is not None:
        x = final_activation(x)
    return x


def generate_params(gen_params: Generator, noise):
    """noise [..., NOISE_DIM] -> parameter samples [..., n_params] in the
    unit cube.  A stack [R, ...] takes noise [R, M, NOISE_DIM]."""
    return mlp_apply(gen_params, noise, final_activation=torch.sigmoid)


def param_count(params: Generator) -> int:
    return sum(t.numel() for layer in params for t in layer.values())
