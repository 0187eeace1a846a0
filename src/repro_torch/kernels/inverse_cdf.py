"""The inverse-CDF event sampler: CUDA kernel on the card, plain on the CPU.

Counterpart of `repro.kernels.inverse_cdf` (`inverse_cdf`, line 40, and the
channel fold, lines 76 and 93).  The JAX package folds [K, E, C] into
[K·C, E] and, on its Pallas path, launches once per channel; here one
launch of `csrc/inverse_cdf.cu` covers [K, E, C] in place, and `[K, E]`
is the C = 1 case.

Dispatch is by the tensor's device and nothing else: a CPU tensor goes to
the plain version (`ref.inverse_cdf_ref`), a CUDA tensor to the kernel,
which either launches or raises.  u is checked before dispatch, so the
CPU refuses a u the kernel would refuse (a strided view among them).
`counts` records both routes, so a run can show that its path went
through the kernel.

Autograd: the wrapper is a `torch.autograd.Function` on both devices.
Its backward is the JAX package's closed form (`repro.kernels.ops`
`_icdf_bwd`), in PyTorch on either device:
du = g·(s/(u(1−u)) + k), dmu = Σg, ds = Σg·logit(u), dk = Σg·(u−0.5),
with u clipped, fp32 math, cast to u's dtype.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict

import torch

from . import build
from .ref import U_EPS, inverse_cdf_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class Counts:
    """Calls of a kernel wrapper by route, forward and backward apart:
    `launches` of the CUDA kernel and `plain_calls` of the plain version
    (CPU tensors) in the forward pass; `backward_launches` of a CUDA
    kernel and `backward_plain` backward passes computed by PyTorch
    operations.  A wrapper with more than one kernel route also counts its
    launches by route in `routes` (route -> launches, summing to
    `launches`)."""
    launches: int = 0
    plain_calls: int = 0
    backward_launches: int = 0
    backward_plain: int = 0
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self):
        self.launches = self.plain_calls = 0
        self.backward_launches = self.backward_plain = 0
        for route in self.routes:
            self.routes[route] = 0


counts = Counts()


def inverse_cdf(u, mu, s, k):
    """u [K, E] uniforms; mu/s/k [K] per-row parameters -> y [K, E] in
    u's dtype (fp32 or bf16), fp32 math."""
    if u.dim() != 2:
        raise ValueError(f"u must be [K, E], got shape {tuple(u.shape)}")
    y = inverse_cdf_channels(u.unsqueeze(-1), mu.unsqueeze(-1),
                             s.unsqueeze(-1), k.unsqueeze(-1))
    return y.squeeze(-1)


def inverse_cdf_channels(u, mu, s, k):
    """u [K, E, C] uniforms; mu/s/k [K, C] -> y [K, E, C] in u's dtype.

    y is contiguous, so `y.reshape(K * E, C)` is a view."""
    if u.dim() != 3:
        raise ValueError(f"u must be [K, E, C], got shape {tuple(u.shape)}")
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    K, E, C = u.shape
    for name, p in (("mu", mu), ("s", s), ("k", k)):
        if tuple(p.shape) != (K, C):
            raise ValueError(f"{name} must be [K, C] = [{K}, {C}] for u "
                             f"{tuple(u.shape)}, got {tuple(p.shape)}")
        if p.device != u.device:
            raise ValueError(f"{name} is on {p.device}, u on {u.device}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inverse_cdf runs on cuda or cpu tensors, got "
                         f"{u.device}")
    return _InverseCdf.apply(u, mu, s, k)


class _InverseCdf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, mu, s, k):
        ctx.save_for_backward(u, s, k)
        ctx.param_dtypes = (mu.dtype, s.dtype, k.dtype)
        if u.device.type == "cpu":
            counts.plain_calls += 1
            return inverse_cdf_ref(u, mu, s, k)
        return _launch(u, mu, s, k)

    @staticmethod
    def backward(ctx, g):
        u, s, k = ctx.saved_tensors
        counts.backward_plain += 1
        du, dmu, ds, dk = inverse_cdf_bwd(g, u, s, k)
        return (du,) + tuple(d.to(t) for d, t in
                             zip((dmu, ds, dk), ctx.param_dtypes))


def inverse_cdf_bwd(g, u, s, k):
    """The closed-form partials of `repro.kernels.ops._icdf_bwd` for
    u [K, E, C] and s/k [K, C]: (du, dmu, ds, dk), fp32 math with u
    clipped, each cast to u's dtype."""
    uc = torch.clamp(u.float(), U_EPS, 1.0 - U_EPS)
    gf = g.float()
    logit = torch.log(uc / (1 - uc))
    du = gf * (s.float()[:, None] / (uc * (1 - uc)) + k.float()[:, None])
    dmu = gf.sum(dim=1)
    ds = (gf * logit).sum(dim=1)
    dk = (gf * (uc - 0.5)).sum(dim=1)
    return tuple(d.to(u.dtype) for d in (du, dmu, ds, dk))


def _launch(u, mu, s, k):
    """One launch of the CUDA kernel over u [K, E, C] on the current
    stream.  Raises on any parameter the kernel does not take."""
    pdtype = mu.dtype
    for name, p in (("mu", mu), ("s", s), ("k", k)):
        if p.dtype != pdtype or p.dtype not in _DTYPE_CODES:
            raise TypeError(f"mu/s/k must share one dtype of float32 or "
                            f"bfloat16, got {name} {p.dtype} beside "
                            f"mu {pdtype}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K, E, C = u.shape
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = _kernel()(u.data_ptr(), mu.data_ptr(), s.data_ptr(),
                        k.data_ptr(), y.data_ptr(), K, E, C,
                        _DTYPE_CODES[u.dtype], _DTYPE_CODES[pdtype], stream)
    if err != 0:
        raise RuntimeError(f"inverse_cdf kernel launch failed: CUDA error "
                           f"{err} (u {tuple(u.shape)} {u.dtype})")
    counts.launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of `csrc/inverse_cdf.cu`, built on first use."""
    fn = build.load("inverse_cdf").repro_inverse_cdf
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn
