"""The Mamba-2 SSD chunked scan: the CUDA kernel on the card, plain on the CPU.

Counterpart of `repro.kernels.ssd_scan` (the Pallas `_ssd_kernel`, line 25,
entry `ssd_scan`, line 71) and of the model-layout
`repro.kernels.ops.ssd_scan` (line 84), which takes the same layout:

    ssd_scan(x, dt, A, Bc, Cc, chunk)
        x [B, S, H, P] fp32 or bf16; dt [B, S, H] fp32 (after softplus);
        A [H] fp32 (negative); Bc/Cc [B, S, N] in x's dtype
        -> y [B, S, H, P] in x's dtype, fp32 math, without the D·x term

one launch of `csrc/ssd_scan.cu`.  `chunk` is the SSD chunk (Q =
min(chunk, S)) and `tile` the kernel's rows per tile inside a chunk (32,
64 or 128); the result depends on neither beyond fp32 reordering.  Any
S >= 0 is taken, as the Pallas entry's padding does.

Dispatch is by the tensor's device and nothing else, as for the other
kernels: the inputs are checked first, then CPU tensors go to the plain
version (`ref.ssd_chunked_ref`) and CUDA tensors to the kernel, which
either launches or raises.  `counts` records both routes.

Autograd: a `torch.autograd.Function` on both devices.  Its backward is
the VJP of the plain chunked version, recomputed with autograd on the
same device (`counts.backward_plain`).  The JAX package differentiates
the sequential `ref.ssd_scan_ref` instead (`_ssd_bwd`): the same function
with an exact gradient, but S small steps a layer where the chunked form
takes a few dozen operations.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .inverse_cdf import Counts
from .ref import ssd_chunked_ref, vjp_of_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILES = (32, 64, 128)
TILE = 64            # the model path's tile

counts = Counts()


def _plain(x, dt, A, Bc, Cc, chunk):
    return ssd_chunked_ref(x, dt, A, Bc, Cc, chunk)[0]


def ssd_scan(x, dt, A, Bc, Cc, chunk: int = 64, tile: int = TILE):
    """x [B, S, H, P]; dt [B, S, H] fp32; A [H] fp32; Bc/Cc [B, S, N] in
    x's dtype -> y [B, S, H, P] in x's dtype (see the module docstring).
    Every input must be contiguous and on one device."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    B, S, H, P = x.shape
    N = Bc.shape[-1] if Bc.dim() == 3 else -1
    want = {"dt": ((B, S, H), torch.float32), "A": ((H,), torch.float32),
            "Bc": ((B, S, N), x.dtype), "Cc": ((B, S, N), x.dtype)}
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc)):
        if name != "x":
            shape, dtype = want[name]
            if tuple(t.shape) != shape or N < 1:
                raise ValueError(f"{name} must be {list(shape)} for x "
                                 f"{tuple(x.shape)}, got {tuple(t.shape)}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    return _SsdScan.apply(x, dt, A, Bc, Cc, chunk, tile)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, chunk, tile):
        ctx.save_for_backward(x, dt, A, Bc, Cc)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            counts.plain_calls += 1
            return _plain(x, dt, A, Bc, Cc, chunk)
        return _launch(x, dt, A, Bc, Cc, chunk, tile)

    @staticmethod
    def backward(ctx, g):
        counts.backward_plain += 1
        return vjp_of_plain(_plain, ctx.saved_tensors, g, ctx.chunk) \
            + (None, None)


def _launch(x, dt, A, Bc, Cc, chunk, tile):
    """One launch of the CUDA kernel on the current stream."""
    B, S, H, P = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernels().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), B, S, H, P, Bc.shape[-1], chunk,
            tile, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed: "
            f"{'unsupported shape' if err == -1 else f'CUDA error {err}'} "
            f"(x {tuple(x.shape)} {x.dtype}, N {Bc.shape[-1]}, chunk "
            f"{chunk}, tile {tile})")
    counts.launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library of `csrc/ssd_scan.cu`, built on first use, with the C
    signature of its entry point."""
    lib = build.load("ssd_scan")
    lib.repro_ssd_scan.restype = ctypes.c_int
    lib.repro_ssd_scan.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int64] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib
