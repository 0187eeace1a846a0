"""The imaging operators: CUDA kernels on the card, plain on the CPU.

Counterpart of `repro.kernels.imaging`:

    mask_apply(x, m)   y[k, p] = x[k, p]·m[p]       (problem `imaging`)
    blur2d(x)          separable 3-tap blur of      (problem `imaging_blur`)
                       each [H, W] image, zero
                       boundary

both in fp32 math, written in x's dtype (fp32 or bf16), one launch of
`csrc/imaging.cu` each.  The Pallas kernels take `block_k`/`block_p`; the
tile arguments here are `threads` (per block, for the mask) and `rows`
(output rows per band, for the blur; `band_plan` picks it by default),
and the result does not depend on them.

Dispatch is by the tensor's device and nothing else, as for
`kernels.inverse_cdf`: the inputs are checked first, then a CPU tensor
goes to the plain version (`ref.mask_apply_ref`, `ref.blur2d_ref`) and a
CUDA tensor to the kernel, which either launches or raises.  Each kernel
has its `Counts`.

Autograd: each wrapper is a `torch.autograd.Function` on both devices,
with the JAX package's backward (`repro.kernels.ops`): the mask's
`_mask_bwd` in PyTorch (dx = g·m, dm = Σ_k g·x, fp32 math), and the
blur's `_blur_bwd`, which is the blur itself (the operator is symmetric):
on the card the blur's backward launches the blur kernel, counted in
`blur_counts.backward_launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import build
from .inverse_cdf import Counts
from .ref import blur2d_ref, mask_apply_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

mask_counts = Counts()
blur_counts = Counts()

# the blur kernel's launch (csrc/imaging.cu kBlurThreads, kMaxStages) and
# its band plan; SPAN_BYTES and MAX_PER_SM are the fastest of a sweep on an
# H100 at [2048, 32, 32] and [16, 256, 256] (PERF.md §6)
BLUR_THREADS = 256
MAX_STAGES = 3
SPAN_BYTES = 8192        # a band's output rows are about this large
SMEM_PER_SM = 228 * 1024
MAX_PER_SM = 6


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """How the blur kernel cuts x [K, H, W]: bands of `rows` output rows
    (of the K·H rows), a ring of `stages` spans per block, `per_sm` blocks
    per SM in a persistent grid."""
    rows: int
    stages: int
    per_sm: int


def span_bytes(rows: int, W: int, itemsize: int) -> int:
    """Shared memory of one stage: a band's rows and its two halo rows,
    rounded up to 128 bytes (csrc/imaging.cu `launch_blur`)."""
    return -(-(rows + 2) * W * itemsize // 128) * 128


@functools.lru_cache(maxsize=None)
def band_plan(H: int, W: int, dtype: torch.dtype,
              rows: Optional[int] = None) -> BandPlan:
    """The band plan for images of H x W in `dtype`, or with `rows` output
    rows per band.  By default a band has enough 16-byte items for every
    thread of a block and about SPAN_BYTES of output rows, rounded down
    to whole images when an image is smaller (then it needs no halo
    rows).  The ring is as deep as MAX_STAGES spans of it fit in a
    block's shared memory; where not even one span of three rows fits,
    the kernel takes its scalar path, which needs no shared memory."""
    itemsize = torch.finfo(dtype).bits // 8
    if rows is not None:
        rows = min(rows, 1 << 30)                      # a C int
    else:
        items = -(-W * itemsize // 16)                 # 16-byte items a row
        rows = max(-(-BLUR_THREADS // items), SPAN_BYTES // (W * itemsize),
                   1)
        if H <= rows:
            rows -= rows % H                           # whole images
    stage = span_bytes(rows, W, itemsize)
    stages = max(1, min(MAX_STAGES, (SMEM_PER_SM - 1024) // stage))
    per_sm = max(1, min(MAX_PER_SM, SMEM_PER_SM // (stages * stage + 1024)))
    return BandPlan(rows, stages, per_sm)


def _check(name, t, dim):
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the imaging kernels run on cuda or cpu tensors, "
                         f"got {t.device}")


def _raise_on(err, what, x):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype})")


def mask_apply(x, m, threads: int = 256):
    """x [K, P] image rows; m [P] 0/1 mask -> x·m [K, P] in x's dtype.

    `threads` per block of the kernel: a multiple of 32 in [32, 1024]."""
    _check("x", x, 2)
    _check("m", m, 1)
    if m.shape[0] != x.shape[1]:
        raise ValueError(f"m must be [P] = [{x.shape[1]}] for x "
                         f"{tuple(x.shape)}, got {tuple(m.shape)}")
    if m.device != x.device:
        raise ValueError(f"m is on {m.device}, x on {x.device}")
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    return _MaskApply.apply(x, m, threads)


class _MaskApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, threads):
        ctx.save_for_backward(x, m)
        if x.device.type == "cpu":
            mask_counts.plain_calls += 1
            return mask_apply_ref(x, m)
        return _mask_launch(x, m, threads)

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        mask_counts.backward_plain += 1
        gf = g.float()
        dx = gf * m.float()[None, :]
        dm = (gf * x.float()).sum(dim=0)
        return dx.to(x.dtype), dm.to(m.dtype), None


def _mask_launch(x, m, threads):
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _kernels().repro_mask_apply(
            x.data_ptr(), m.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[m.dtype], threads,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "mask_apply", x)
    mask_counts.launches += 1
    return y


def blur2d(x, rows: Optional[int] = None):
    """x [K, H, W] images -> separable 3-tap (0.25, 0.5, 0.25) blur, rows
    then columns, zero boundary, in x's dtype.  The operator is symmetric,
    so it is its own adjoint.  Any K, H, W.

    `rows` output rows per band of the kernel (>= 1; None: `band_plan`'s
    choice)."""
    _check("x", x, 3)
    if rows is not None and rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    return _Blur2d.apply(x, rows)


class _Blur2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        if x.device.type == "cpu":
            blur_counts.plain_calls += 1
            return blur2d_ref(x)
        y = _blur_launch(x, rows)
        blur_counts.launches += bool(y.numel())
        return y

    @staticmethod
    def backward(ctx, g):
        # the blur matrix is symmetric: its adjoint is the blur itself
        g = g.contiguous()
        if g.device.type == "cpu":
            blur_counts.backward_plain += 1
            return blur2d_ref(g), None
        dx = _blur_launch(g, ctx.rows)
        blur_counts.backward_launches += bool(dx.numel())
        return dx, None


def _blur_launch(x, rows):
    """One launch of the blur kernel on the current stream, cut by
    `band_plan`."""
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    K, H, W = x.shape
    plan = band_plan(H, W, x.dtype, rows)
    with torch.cuda.device(x.device):
        err = _kernels().repro_blur2d(
            x.data_ptr(), y.data_ptr(), K, H, W, _DTYPE_CODES[x.dtype],
            plan.rows, plan.stages, plan.per_sm,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "blur2d", x)
    return y


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library of `csrc/imaging.cu`, built on first use, with the C
    signatures of its two entry points."""
    lib = build.load("imaging")
    lib.repro_mask_apply.restype = ctypes.c_int
    lib.repro_mask_apply.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.repro_blur2d.restype = ctypes.c_int
    lib.repro_blur2d.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib
