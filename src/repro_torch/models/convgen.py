"""Convolutional generator for image-valued parameter spaces.

Counterpart of `repro.models.convgen`, which `core.gan` dispatches to when
a problem declares a `param_shape` (the imaging problems, 32x32):

    noise [R, M, NOISE_DIM]
      -> dense projection to a (H/4, W/4, C0) base grid, leaky-relu
      -> [nearest-upsample x2 -> 3x3 conv -> leaky-relu]  (x2, to H x W)
      -> 3x3 conv to 1 channel -> sigmoid -> flatten [R, M, H*W]

The parameters keep the JAX pytree layout, so a checkpoint's
path-flattened keys ("proj/w", "convs/0/w", ...) map one to one:

    {"proj": {"w": [R, noise, h0·w0·c0], "b": [R, h0·w0·c0]},
     "convs": [{"w": [R, 3, 3, cin, cout], "b": [R, cout]} x 3]}

with conv weights HWIO and the projection's outputs read as (h0, w0, c0)
in that order (NHWC), as `repro/models/convgen.py` (line 134) reshapes
them.  Inside
`conv_generator_apply` the activations are NCHW with the R ranks side by
side on the channel axis, and each conv layer is ONE grouped `conv2d`
(`groups=R`) over all ranks.  The convolution runs in full fp32, forward
and backward: cuDNN's TF32 is switched off for each call (`_fp32_conv`)
and the process-wide flag restored after it.  Autograd runs a backward
outside the forward's scope, so the conv is a `torch.autograd.Function`
(`_GroupedConv`) whose backward enters the same scope.

Sizing (CONV_CHANNELS = (32, 32, 16), 32x32 output): 292,545 parameters a
rank.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device

LEAK = 0.01                      # hidden-activation slope, as core.gan.LEAK
CONV_CHANNELS = (32, 32, 16)     # base-grid, mid-resolution, pre-output
UPSAMPLE_STAGES = 2              # each doubles the grid: H/4 x W/4 base

ConvGenerator = Dict[str, object]


def base_grid(param_shape: Tuple[int, int]) -> Tuple[int, int]:
    h, w = param_shape
    f = 1 << UPSAMPLE_STAGES
    if h % f or w % f:
        raise ValueError(
            f"conv generator upsamples x{f}: param_shape {param_shape} "
            f"must be divisible by {f} in both dims")
    return h // f, w // f


def conv_gen_widths(param_shape: Tuple[int, int],
                    noise_dim: int) -> Tuple[int, ...]:
    """Layer fan-ins of the conv generator for `param_shape`, as
    `repro.models.convgen.conv_gen_widths` reports them."""
    h0, w0 = base_grid(param_shape)
    c0, c1, c2 = CONV_CHANNELS
    return (noise_dim, h0 * w0 * c0, 9 * c0 * c1, 9 * c1 * c2, 9 * c2)


def leaf_shapes(param_shape: Tuple[int, int],
                noise_dim: int) -> Dict[str, Tuple[int, ...]]:
    """Path-flattened leaf shapes of ONE rank's conv generator."""
    h0, w0 = base_grid(param_shape)
    chans = CONV_CHANNELS + (1,)
    shapes = {"proj/w": (noise_dim, h0 * w0 * chans[0]),
              "proj/b": (h0 * w0 * chans[0],)}
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        shapes[f"convs/{i}/w"] = (3, 3, cin, cout)
        shapes[f"convs/{i}/b"] = (cout,)
    return shapes


def flatten(params: ConvGenerator) -> Dict[str, torch.Tensor]:
    """The leaves under their checkpoint keys ("proj/w", "convs/0/b", ...)."""
    flat = {f"proj/{k}": v for k, v in params["proj"].items()}
    for i, layer in enumerate(params["convs"]):
        flat.update({f"convs/{i}/{k}": v for k, v in layer.items()})
    return flat


def conv_weight_mask(params: ConvGenerator):
    """Weight-only ring mask in the conv generator's structure (§V-C:
    biases never ride the ring), as `repro.models.convgen
    .conv_weight_mask`."""
    return {"proj": {"w": True, "b": False},
            "convs": [{"w": True, "b": False} for _ in params["convs"]]}


def map_leaves(fn, params: ConvGenerator) -> ConvGenerator:
    """The same conv generator with `fn` applied to every leaf."""
    return {"proj": {k: fn(v) for k, v in params["proj"].items()},
            "convs": [{k: fn(v) for k, v in layer.items()}
                      for layer in params["convs"]]}


def init_conv_generator(generator: torch.Generator,
                        param_shape: Tuple[int, int], noise_dim: int,
                        ranks=None, device=None) -> ConvGenerator:
    """Kaiming-normal init (as `repro.models.convgen.init_conv_generator`),
    drawn from `generator` on its own device; zero biases.  `ranks=R`
    stacks R independent generators on a leading axis."""
    dev = resolve_device(device)
    lead = () if ranks is None else (ranks,)
    shapes = leaf_shapes(param_shape, noise_dim)

    def layer(prefix, fan_in):
        w = torch.randn(lead + shapes[f"{prefix}/w"], generator=generator,
                        device=generator.device) * math.sqrt(2.0 / fan_in)
        return {"w": w.to(dev),
                "b": torch.zeros(lead + shapes[f"{prefix}/b"], device=dev)}

    return {"proj": layer("proj", noise_dim),
            "convs": [layer(f"convs/{i}", 9 * shapes[f"convs/{i}/w"][2])
                      for i in range(len(CONV_CHANNELS))]}


def _fp32_conv():
    """cuDNN with TF32 off for the duration of one call.  Every other cuDNN
    flag is passed through as it stands: `cudnn.flags` resets the flags it
    is not given (`enabled` to False among them)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       benchmark_limit=cudnn.benchmark_limit,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _GroupedConv(torch.autograd.Function):
    """3x3 SAME grouped conv, `F.conv2d(x, w, b, padding=1, groups=g)`,
    with TF32 off in the forward and in the backward (the same ATen
    `convolution_backward` autograd would call, inside `_fp32_conv`)."""

    @staticmethod
    def forward(ctx, x, w, b, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with _fp32_conv():
            return F.conv2d(x, w, b, padding=1, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _fp32_conv():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0],
                ctx.groups, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def conv_generator_apply(params: ConvGenerator, noise):
    """noise [R, M, noise_dim] through an R-rank stack -> parameter samples
    [R, M, H·W] in (0, 1), contiguous.  A single generator (no rank axis)
    takes noise [M, noise_dim] and returns [M, H·W]."""
    if noise.dim() == 2:
        return conv_generator_apply(map_leaves(lambda t: t[None], params),
                                    noise[None])[0]
    proj, convs = params["proj"], params["convs"]
    R, M = noise.shape[:2]
    x = torch.matmul(noise, proj["w"]) + proj["b"].unsqueeze(-2)
    x = F.leaky_relu(x, LEAK)
    c0 = convs[0]["w"].shape[3]
    h0 = math.isqrt(proj["b"].shape[-1] // c0)
    if h0 * h0 * c0 != proj["b"].shape[-1]:
        raise ValueError("conv generator supports square param_shape only")
    # (h0, w0, c0) per rank, as JAX reshapes; then ranks side by side on
    # the channel axis: [M, R·c0, h0, w0], channel r·c0 + c
    x = x.reshape(R, M, h0, h0, c0).permute(1, 0, 4, 2, 3)
    x = x.reshape(M, R * c0, h0, h0)
    for i, layer in enumerate(convs):
        if i < UPSAMPLE_STAGES:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        w = layer["w"]                              # [R, 3, 3, cin, cout]
        cin, cout = w.shape[3], w.shape[4]
        x = _GroupedConv.apply(x, w.permute(0, 4, 3, 1, 2).reshape(
            R * cout, cin, 3, 3), layer["b"].reshape(R * cout), R)
        if i < len(convs) - 1:
            x = F.leaky_relu(x, LEAK)
    H, W = x.shape[2:]
    x = torch.sigmoid(x)                           # [M, R, H, W]
    return x.permute(1, 0, 2, 3).reshape(R, M, H * W).contiguous()
