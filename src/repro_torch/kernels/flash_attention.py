"""Flash attention: CUDA kernels on the card, plain on the CPU.

Counterpart of `repro.kernels.flash_attention` (the Pallas `_flash_kernel`,
line 34, entry `flash_attention`, line 83) and of the model-layout adapter
`repro.kernels.ops.flash_attention` (line 47):

    flash_attention(q, k, v)        q [B, H, Sq, hd], k/v [B, KV, Sk, hd]
                                    -> [B, H, Sq, hd]
    flash_attention_model(q, k, v)  q [B, S, KV, G, hd], k/v [B, S, KV, hd]
                                    -> [B, S, KV, G, hd]

online-softmax attention, causal and/or sliding window, GQA through the
KV-head index h // G, fp32 math, written in q's dtype (fp32 or bf16).
`block_q`/`block_k` are the tiles, as in the Pallas signature (32, 64 or
128 each).  Unlike the Pallas kernel, which asserts Sq % min(128, Sq) ==
0, any Sq, Sk >= 1 is taken.  The plain version takes any head dim, as
the Pallas kernel and its oracle do; the CUDA routes take the head dims
of `HEAD_DIMS` (80 is hubert-xlarge's 1280 / 16) and raise on another.

Dispatch is fixed, by the device and then the dtype and nothing else
(`route`); the inputs are checked first:

    cpu tensors    -> "plain": `ref.flash_attention_ref`
    cuda float32   -> "fma":   `csrc/flash_attention.cu`, fp32 FMAs on the
                      CUDA cores (holds fp32 rtol 1e-4 / atol 1e-5); the
                      result depends on the tiles only by fp32 reordering
    cuda bfloat16  -> "wgmma": `csrc/flash_attention_tc.cu`, bf16 tensor
                      cores (wgmma, TMA), fp32 m/l/acc, P rounded to bf16
                      before P·V; tiles by `tc_tiles`

Each CUDA route is one launch that either runs or raises: no route gives
way to another or to the plain version.  `counts.launches` counts both
CUDA routes, `counts.routes` each.  The bf16 route reads the model
layout, q [B, S, KV, G, hd] and k/v [B, S, KV, hd], through its strides
and writes o in q's layout: the model-layout adapter hands it its
tensors with no transposing copies, at the tiles TC_BLOCK_Q x
TC_BLOCK_K, and `flash_attention` hands it strided views of its
[B, H, S, hd] tensors.  The fp32 route takes the kernel layout,
so the adapter transposes for it, as before, at BLOCK_Q x BLOCK_K.

Autograd: both entries are `torch.autograd.Function`s on every device.
The backward is the JAX package's `_flash_bwd` (`repro.kernels.ops`): the
VJP of the plain version, recomputed with autograd on the same device
(`counts.backward_plain`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build
from .inverse_cdf import Counts
from .ref import flash_attention_ref, vjp_of_plain

HEAD_DIMS = (32, 64, 80, 128)   # what the CUDA routes take
TILES = (32, 64, 128)
# the tiles the model path uses (prefill attention) on the fp32 route ...
BLOCK_Q = 128
BLOCK_K = 64
# ... and on the bf16 route: the fastest pair at tinyllama's prefill shape
# on an H100 (PERF.md §6)
TC_BLOCK_Q = 64
TC_BLOCK_K = 64
_DTYPES = (torch.float32, torch.bfloat16)

counts = Counts(routes={"fma": 0, "wgmma": 0})


def route(dtype: torch.dtype, device: torch.device) -> str:
    """The fixed dispatch: "plain" for a CPU tensor, else "fma" for
    float32 and "wgmma" for bfloat16."""
    if torch.device(device).type == "cpu":
        return "plain"
    return {torch.float32: "fma", torch.bfloat16: "wgmma"}[dtype]


def tc_tiles(block_q: int, block_k: int) -> Tuple[int, int]:
    """The bf16 kernel's tiles for the wrapper's block_q/block_k: a wgmma
    takes 64 rows, so a tile below 64 runs as 64 (32 -> 64, 64 -> 64,
    128 -> 128).  block_q / 64 warpgroups share a block's K/V tiles."""
    return max(64, block_q), max(64, block_k)


def _check(name, t, dtype, device, dims=4, contiguous=True):
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dtype != dtype:
        raise TypeError(f"q, k and v must share a dtype; {name} is {t.dtype}, "
                        f"q {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{t.device}")


def _check_args(B, H, KV, Sq, Sk, k_shape, v_shape, want_k, block_q,
                block_k, window):
    if tuple(k_shape) != want_k or tuple(v_shape) != want_k:
        raise ValueError(f"k and v must be {list(want_k)} and equal, got "
                         f"{tuple(k_shape)} and {tuple(v_shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not split into groups over "
                         f"{KV} KV heads")
    if block_q not in TILES or block_k not in TILES:
        raise ValueError(f"block_q and block_k must be in {TILES}, got "
                         f"{block_q} and {block_k}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"Sq and Sk must be >= 1, got {Sq} and {Sk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_head_dim(hd):
    """The kernel routes' head dims (the plain version takes any)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} on the CUDA "
                         f"routes, got {hd}")


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """q [B, H, Sq, hd]; k/v [B, KV, Sk, hd] with H a multiple of KV ->
    [B, H, Sq, hd] in q's dtype.  Key c is visible to query r when
    c <= r (causal) and c > r - window (window >= 1, or None).  A query
    that sees no key at all (possible only with a window and Sq > Sk) has
    no defined result: the kernels write 0, the plain version NaN (as the
    JAX oracle) and the Pallas kernel the mean of V."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    _check_args(B, H, KV, Sq, Sk, k.shape, v.shape, (B, KV, Sk, hd),
                block_q, block_k, window)
    if route(q.dtype, q.device) == "wgmma":
        # the same kernel as the model layout, on strided views of it
        G = H // KV
        o = _FlashAttentionModel.apply(
            q.view(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4),
            k.transpose(1, 2), v.transpose(1, 2), causal, window, block_q,
            block_k)
        return o.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, hd)
    return _FlashAttention.apply(q, k, v, causal, window, block_q, block_k)


class _FlashAttention(torch.autograd.Function):
    """The plain version and the fp32 route, in the kernel layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        if route(q.dtype, q.device) == "plain":
            counts.plain_calls += 1
            return flash_attention_ref(q, k, v, causal, window)
        return _launch(q, k, v, causal, window, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        counts.backward_plain += 1
        return vjp_of_plain(flash_attention_ref, ctx.saved_tensors, g,
                            *ctx.mask) + (None,) * 4


def _launch(q, k, v, causal, window, block_q, block_k):
    """One launch of the fp32 kernel (`csrc/flash_attention.cu`) on the
    current stream."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    _check_head_dim(hd)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV,
            Sq, Sk, hd, int(causal), 0 if window is None else window,
            block_q, block_k, 1.0 / math.sqrt(hd), 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{'unsupported shape' if err == -1 else f'CUDA error {err}'} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, tiles "
            f"{block_q}x{block_k})")
    counts.launches += 1
    counts.routes["fma"] += 1
    return o


def _tma_ready(name, t, strides):
    """TMA reads rows of 16-byte-aligned bases and strides."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous head dim, got "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in strides):
        raise ValueError(f"{name} must start 16-byte aligned with strides "
                         f"that are multiples of 8 elements (TMA), got "
                         f"strides {t.stride()}")


_TC_ERRORS = {-1: "unsupported shape", -2: "the driver has no "
              "cuTensorMapEncodeTiled", -3: "a TMA map was refused"}


def _launch_tc(q, k, v, o, qs, ks, vs, os_, dims, causal, window, block_q,
               block_k):
    """One launch of the bf16 tensor-core kernel
    (`csrc/flash_attention_tc.cu`): q and o strides (b, s, kv, g), k and
    v strides (b, s, kv), in elements."""
    B, H, KV, Sq, Sk, hd = dims
    _check_head_dim(hd)
    for name, t, st in (("q", q, qs), ("k", k, ks), ("v", v, vs),
                        ("o", o, os_)):
        _tma_ready(name, t, st)
    bq, bk = tc_tiles(block_q, block_k)
    arr = [(ctypes.c_int64 * len(s))(*s) for s in (qs, ks, vs, os_)]
    with torch.cuda.device(q.device):
        err = _kernels_tc().repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV,
            Sq, Sk, hd, *arr, int(causal), 0 if window is None else window,
            bq, bk, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention bf16 kernel launch failed: "
            f"{_TC_ERRORS.get(err, f'CUDA error {err}')} (q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, kernel tiles {bq}x{bk})")
    counts.launches += 1
    counts.routes["wgmma"] += 1


def _plain_model(q, k, v, causal, window):
    """The plain version in the model layout (q may have another S than
    k and v)."""
    B, S, KV, G, hd = q.shape
    o = flash_attention_ref(q.reshape(B, S, KV * G, hd).transpose(1, 2),
                            k.transpose(1, 2), v.transpose(1, 2), causal,
                            window)
    return o.transpose(1, 2).reshape(B, S, KV, G, hd)


class _FlashAttentionModel(torch.autograd.Function):
    """The bf16 route in the model layout, q [B, Sq, KV, G, hd] and k/v
    [B, Sk, KV, hd], any strides; o is laid out as q where q is dense."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        B, Sq, KV, G, hd = q.shape
        o = torch.empty_like(q)
        _launch_tc(q, k, v, o, q.stride()[:4], k.stride()[:3],
                   v.stride()[:3], o.stride()[:4],
                   (B, KV * G, KV, Sq, k.shape[1], hd), causal, window,
                   block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, g):
        counts.backward_plain += 1
        return vjp_of_plain(_plain_model, ctx.saved_tensors, g,
                            *ctx.mask) + (None,) * 4


def flash_attention_model(q, k, v, causal: bool = True,
                          window: Optional[int] = None):
    """Model layout: q [B, S, KV, G, hd], k/v [B, S, KV, hd] ->
    [B, S, KV, G, hd].  On the bf16 route the kernel reads these layouts
    through their strides; otherwise through `flash_attention` in the
    kernel layout."""
    _check("q", q, q.dtype, q.device, dims=5, contiguous=False)
    for name, t in (("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device, dims=4, contiguous=False)
    B, S, KV, G, hd = q.shape
    if route(q.dtype, q.device) == "wgmma":
        _check_args(B, KV * G, KV, S, S, k.shape, v.shape,
                    (B, S, KV, hd), TC_BLOCK_Q, TC_BLOCK_K, window)
        return _FlashAttentionModel.apply(q, k, v, causal, window,
                                          TC_BLOCK_Q, TC_BLOCK_K)
    qk = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    o = flash_attention(qk, k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal, window)
    return o.transpose(1, 2).reshape(B, S, KV, G, hd)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library of `csrc/flash_attention.cu` (the fp32 route), built on
    first use, with the C signature of its entry point."""
    lib = build.load("flash_attention")
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_int64] \
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _kernels_tc():
    """The library of `csrc/flash_attention_tc.cu` (the bf16 route)."""
    lib = build.load("flash_attention_tc")
    fn = lib.repro_flash_attention_tc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 \
        + [ctypes.POINTER(ctypes.c_int64)] * 4 \
        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_void_p]
    return lib
