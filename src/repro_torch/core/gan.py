"""The GAN optimizer networks — counterpart of `repro.core.gan`.

    generator      noise(135) -> 128 -> 128 -> 128 -> 6   = 51,206 params
    discriminator  (y0, y1)(2) -> 192 -> 192 -> 64 -> 1   = 50,049 params

(§V-A: Leaky ReLU hidden activations, Kaiming-normal init, sigmoid head
bounding the parameters to the unit cube.)  Each MLP is a list of layers
`{"w": [in, out], "b": [out]}` — the JAX package's layout, so a
checkpoint's path-flattened keys ("0/w", "0/b", ...) map one to one — and
a stack of R generators carries a leading `[R, ...]` axis on every leaf.
A problem with an image-valued `param_shape` gets the convolutional
generator of `models.convgen` instead, a dict `{"proj", "convs"}`; as in
the JAX package, `generate_params` dispatches on that structure.

The discriminators of R ranks are stacked the same way, and each of their
layers is one batched `torch.matmul`: events [R, N, obs] -> logits [R, N].
The losses are means over each rank's events, so they come out per rank,
[R]; the gradient of their sum is each rank's own gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Union

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import convgen

NOISE_DIM = 135
N_PARAMS = 6                     # p_0..p_5 of the loop-closure test
GEN_WIDTHS = (NOISE_DIM, 128, 128, 128, N_PARAMS)
DISC_WIDTHS = (2, 192, 192, 64, 1)
LEAK = 0.01

# discriminator forward compute precisions (`WorkflowConfig.disc_compute`)
DISC_COMPUTE = ("fp32", "bf16")

Generator = List[Dict[str, torch.Tensor]]
AnyGenerator = Union[Generator, convgen.ConvGenerator]


def gen_widths(n_params=None):
    """Generator widths for a problem with `n_params` outputs (only the
    output width varies per problem)."""
    return GEN_WIDTHS[:-1] + (GEN_WIDTHS[-1] if n_params is None
                              else n_params,)


def disc_widths(obs_dim=None):
    """Discriminator widths for a problem with `obs_dim` observables."""
    return ((DISC_WIDTHS[0] if obs_dim is None else obs_dim,)
            + DISC_WIDTHS[1:])


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
                   device=None, param_shape=None) -> AnyGenerator:
    """The paper's MLP generator in fp32 (`ranks=R`: an [R, ...] stack), or
    the conv generator when the problem declares an image-valued
    `param_shape` (H, W), as `repro.core.gan.init_generator` dispatches."""
    if param_shape is not None:
        return convgen.init_conv_generator(generator, param_shape, NOISE_DIM,
                                           ranks, device)
    return init_mlp(generator, gen_widths(n_params), ranks, device)


def init_discriminator(generator: torch.Generator, obs_dim=None, ranks=None,
                       device=None) -> Generator:
    """The paper's discriminator MLP in fp32, Kaiming-normal as `init_mlp`
    (`ranks=R`: R independent discriminators stacked)."""
    return init_mlp(generator, disc_widths(obs_dim), ranks, device)


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


def generate_params(gen_params: AnyGenerator, noise):
    """noise [..., NOISE_DIM] -> parameter samples [..., n_params] in the
    unit cube.  A stack [R, ...] takes noise [R, M, NOISE_DIM].  A dict is
    the conv generator, a list the MLP."""
    if isinstance(gen_params, dict):
        return convgen.conv_generator_apply(gen_params, noise)
    return mlp_apply(gen_params, noise, final_activation=torch.sigmoid)


def compute_dtype_of(precision: str):
    """`WorkflowConfig.disc_compute` -> the dtype `discriminate` casts its
    forward to; None keeps the master fp32 and casts nothing."""
    if precision == "fp32":
        return None
    if precision == "bf16":
        return torch.bfloat16
    raise ValueError(
        f"unknown disc_compute {precision!r}; expected one of {DISC_COMPUTE}")


def discriminate(disc_params: Generator, events, compute_dtype=None):
    """events [..., N, obs_dim] -> logits [..., N] (a stack [R, ...] takes
    events [R, N, obs_dim]).

    With a `compute_dtype` (from `compute_dtype_of`) the parameters and
    the events are cast once on entry, the matmuls run in that dtype and
    the logits come back as fp32, so losses, gradients and the optimizer
    state stay fp32.  None casts nothing."""
    if compute_dtype is None:
        return mlp_apply(disc_params, events)[..., 0]
    cast = [{k: v.to(compute_dtype) for k, v in layer.items()}
            for layer in disc_params]
    return mlp_apply(cast, events.to(compute_dtype))[..., 0].float()


# losses (standard GAN with logits; discriminator: real -> 1, fake -> 0).
# F.softplus is the identity above 20, jax.nn.softplus is not: they agree
# within fp32 rounding there.


def disc_loss(disc_params: Generator, real_events, fake_events,
              compute_dtype=None):
    """-log σ(D(real)) - log(1 - σ(D(fake))), each a mean over the events:
    a scalar, or [R] for a stack."""
    lr_ = discriminate(disc_params, real_events, compute_dtype)
    lf_ = discriminate(disc_params, fake_events, compute_dtype)
    return F.softplus(-lr_).mean(-1) + F.softplus(lf_).mean(-1)


def gen_loss(disc_params: Generator, fake_events, compute_dtype=None):
    """Non-saturating generator loss -log σ(D(fake)), a mean over the
    events: a scalar, or [R] for a stack."""
    lf_ = discriminate(disc_params, fake_events, compute_dtype)
    return F.softplus(-lf_).mean(-1)


def weight_mask(params: AnyGenerator):
    """True for weight matrices, False for biases, in the tree's layout:
    only weight gradients ride the ring (§V-C).  A dict is the conv
    generator, a list the MLP."""
    if isinstance(params, dict):
        return convgen.conv_weight_mask(params)
    return [{"w": True, "b": False} for _ in params]


def leaves(params: AnyGenerator) -> Iterator[torch.Tensor]:
    """Every weight and bias of a generator of either layout."""
    if isinstance(params, dict):
        yield from convgen.flatten(params).values()
    else:
        for layer in params:
            yield from layer.values()


def map_leaves(fn, params: AnyGenerator) -> AnyGenerator:
    """The same generator structure with `fn` applied to every leaf."""
    if isinstance(params, dict):
        return convgen.map_leaves(fn, params)
    return [{k: fn(v) for k, v in layer.items()} for layer in params]


def param_count(params: AnyGenerator) -> int:
    return sum(t.numel() for t in leaves(params))
