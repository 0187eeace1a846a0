"""The Mamba-2 SSD chunked scan: CUDA kernels on the card, plain on the CPU.

Counterpart of `repro.kernels.ssd_scan` (the Pallas `_ssd_kernel`, line 25,
entry `ssd_scan`, line 71) and of the model-layout
`repro.kernels.ops.ssd_scan` (line 84), which takes the same layout:

    ssd_scan(x, dt, A, Bc, Cc, chunk)
        x [B, S, H, P] fp32 or bf16; dt [B, S, H] fp32 (after softplus);
        A [H] fp32 (negative); Bc/Cc [B, S, N] in x's dtype
        -> y [B, S, H, P] in x's dtype, fp32 math, without the D·x term

`chunk` is the SSD chunk (Q = min(chunk, S)) and `tile` the fp32 kernel's
rows per tile inside a chunk (32, 64 or 128); the result depends on
neither beyond the order of sums (and, in bf16, where it rounds).  Any
S >= 0 is taken, as the Pallas entry's padding does.

Dispatch is fixed, by the device and then the dtype and nothing else
(`route`); the inputs are checked first:

    cpu tensors    -> "plain": `ref.ssd_chunked_ref`
    cuda float32   -> "fma":   `csrc/ssd_scan.cu`, one launch, fp32 FMAs on
                      the CUDA cores (holds fp32 rtol/atol 1e-3), `tile`
                      rows per tile
    cuda bfloat16  -> "wgmma": `csrc/ssd_scan_tc.cu`, bf16 tensor cores
                      (wgmma, TMA): the SSD algorithm's steps as launches of
                      one call (seg; for S > Q the chunk states and the
                      pass over chunks; y), fp32 state and decays; it
                      ignores `tile` (every tile is 64 rows, one wgmma M),
                      P 32 or 64, N 16, 32, 64 or 128

Each CUDA route either runs or raises: no route gives way to another or
to the plain version.  `counts.launches` counts CALLS of the CUDA routes
(one per call, however many launches the bf16 route makes), and
`counts.routes` each route's calls.

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

_DTYPES = (torch.float32, torch.bfloat16)
TILES = (32, 64, 128)
TILE = 64            # the model path's tile
TC_P = (32, 64)      # head dims the bf16 route takes
TC_N = (16, 32, 64, 128)   # state sizes the bf16 route takes

counts = Counts(routes={"fma": 0, "wgmma": 0})


def route(dtype: torch.dtype, device: torch.device) -> str:
    """The fixed dispatch: "plain" for a CPU tensor, else "fma" for
    float32 and "wgmma" for bfloat16."""
    if torch.device(device).type == "cpu":
        return "plain"
    return {torch.float32: "fma", torch.bfloat16: "wgmma"}[dtype]


def _plain(x, dt, A, Bc, Cc, chunk):
    return ssd_chunked_ref(x, dt, A, Bc, Cc, chunk)[0]


def ssd_scan(x, dt, A, Bc, Cc, chunk: int = 64, tile: int = TILE):
    """x [B, S, H, P]; dt [B, S, H] fp32; A [H] fp32; Bc/Cc [B, S, N] in
    x's dtype -> y [B, S, H, P] in x's dtype (see the module docstring).
    Every input must be contiguous and on one device."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
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
        r = route(x.dtype, x.device)
        if r == "plain":
            counts.plain_calls += 1
            return _plain(x, dt, A, Bc, Cc, chunk)
        if r == "fma":
            return _launch(x, dt, A, Bc, Cc, chunk, tile)
        return _launch_tc(x, dt, A, Bc, Cc, chunk)

    @staticmethod
    def backward(ctx, g):
        counts.backward_plain += 1
        return vjp_of_plain(_plain, ctx.saved_tensors, g, ctx.chunk) \
            + (None, None)


def _launch(x, dt, A, Bc, Cc, chunk, tile):
    """One launch of the fp32 kernel (`csrc/ssd_scan.cu`) on the current
    stream."""
    B, S, H, P = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernels().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), B, S, H, P, Bc.shape[-1], chunk,
            tile, 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed: "
            f"{'unsupported shape' if err == -1 else f'CUDA error {err}'} "
            f"(x {tuple(x.shape)} {x.dtype}, N {Bc.shape[-1]}, chunk "
            f"{chunk}, tile {tile})")
    counts.launches += 1
    counts.routes["fma"] += 1
    return y


_TC_ERRORS = {-1: "unsupported shape", -2: "the driver has no "
              "cuTensorMapEncodeTiled", -3: "a TMA map was refused"}


def _launch_tc(x, dt, A, Bc, Cc, chunk):
    """One call of the bf16 tensor-core kernels (`csrc/ssd_scan_tc.cu`) on
    the current stream, with their scratch: seg in fp64, the chunk decays
    and, for more than one chunk, the chunk states (fp32) and the states
    entering each chunk (bf16, split into hi and lo parts)."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    if P not in TC_P or N not in TC_N:
        raise ValueError(f"the bf16 SSD kernel takes P in {TC_P} and N in "
                         f"{TC_N}, got P {P}, N {N}")
    y = torch.empty_like(x)
    if B == 0 or S == 0:
        counts.launches += 1
        counts.routes["wgmma"] += 1
        return y
    Q = min(chunk, S)
    nc = -(-S // Q)
    dev = x.device
    seg = torch.empty((B, S, H), dtype=torch.float64, device=dev)
    cdecay = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    states = hs = None
    if nc > 1:
        states = torch.empty((B, nc - 1, H, P, N), dtype=torch.float32,
                             device=dev)
        hs = torch.empty((2, B, nc - 1, H, P, N), dtype=torch.bfloat16,
                         device=dev)                # hi and lo parts
    for name, t in (("x", x), ("Bc", Bc), ("Cc", Cc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (TMA)")
    with torch.cuda.device(dev):
        err = _kernels_tc().repro_ssd_scan_tc(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), seg.data_ptr(), cdecay.data_ptr(),
            None if states is None else states.data_ptr(),
            None if hs is None else hs.data_ptr(), B, S, H, P, N, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan bf16 kernel launch failed: "
            f"{_TC_ERRORS.get(err, f'CUDA error {err}')} (x {tuple(x.shape)}, "
            f"N {N}, chunk {chunk})")
    counts.launches += 1
    counts.routes["wgmma"] += 1
    return y


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library of `csrc/ssd_scan.cu` (the fp32 route), built on first
    use, with the C signature of its entry point."""
    lib = build.load("ssd_scan")
    lib.repro_ssd_scan.restype = ctypes.c_int
    lib.repro_ssd_scan.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int64] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _kernels_tc():
    """The library of `csrc/ssd_scan_tc.cu` (the bf16 route)."""
    lib = build.load("ssd_scan_tc")
    fn = lib.repro_ssd_scan_tc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 6 \
        + [ctypes.c_void_p]
    return lib
