"""Flash attention: the CUDA kernel on the card, plain on the CPU.

Counterpart of `repro.kernels.flash_attention` (the Pallas `_flash_kernel`,
line 34, entry `flash_attention`, line 83) and of the model-layout adapter
`repro.kernels.ops.flash_attention` (line 47):

    flash_attention(q, k, v)        q [B, H, Sq, hd], k/v [B, KV, Sk, hd]
                                    -> [B, H, Sq, hd]
    flash_attention_model(q, k, v)  q [B, S, KV, G, hd], k/v [B, S, KV, hd]
                                    -> [B, S, KV, G, hd]

online-softmax attention, causal and/or sliding window, GQA through the
KV-head index h // G, fp32 math, written in q's dtype (fp32 or bf16); one
launch of `csrc/flash_attention.cu` each.  `block_q`/`block_k` are the
tiles, as in the Pallas signature (32, 64 or 128 each); the result does
not depend on them beyond fp32 reordering.  Unlike the Pallas kernel,
which asserts Sq % min(128, Sq) == 0, any Sq, Sk >= 1 is taken.

Dispatch is by the tensor's device and nothing else, as for the other
kernels: the inputs are checked first, then CPU tensors go to the plain
version (`ref.flash_attention_ref`) and CUDA tensors to the kernel, which
either launches or raises.  `counts` records both routes.

Autograd: `flash_attention` is a `torch.autograd.Function` on both
devices.  Its backward is the JAX package's `_flash_bwd`
(`repro.kernels.ops`): the VJP of the plain version, recomputed with
autograd on the same device (`counts.backward_plain`).  The model-layout
adapter is differentiable reshapes around it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build
from .inverse_cdf import Counts
from .ref import flash_attention_ref, vjp_of_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
TILES = (32, 64, 128)
# the tiles the model path uses (prefill attention)
BLOCK_Q = 128
BLOCK_K = 64

counts = Counts()


def _check(name, t, dtype, device):
    if t.dim() != 4:
        raise ValueError(f"{name} must have 4 dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dtype != dtype:
        raise TypeError(f"q, k and v must share a dtype; {name} is {t.dtype}, "
                        f"q {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{t.device}")


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """q [B, H, Sq, hd]; k/v [B, KV, Sk, hd] with H a multiple of KV ->
    [B, H, Sq, hd] in q's dtype.  Key c is visible to query r when
    c <= r (causal) and c > r - window (window >= 1, or None).  A query
    that sees no key at all (possible only with a window and Sq > Sk) has
    no defined result: the kernel writes 0, the plain version NaN (as the
    JAX oracle) and the Pallas kernel the mean of V."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"k and v must be [B={B}, KV, Sk, hd={hd}] and "
                         f"equal, got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not split into groups over "
                         f"{KV} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if block_q not in TILES or block_k not in TILES:
        raise ValueError(f"block_q and block_k must be in {TILES}, got "
                         f"{block_q} and {block_k}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"Sq and Sk must be >= 1, got {Sq} and {Sk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return _FlashAttention.apply(q, k, v, causal, window, block_q, block_k)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        if q.device.type == "cpu":
            counts.plain_calls += 1
            return flash_attention_ref(q, k, v, causal, window)
        return _launch(q, k, v, causal, window, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        counts.backward_plain += 1
        return vjp_of_plain(flash_attention_ref, ctx.saved_tensors, g,
                            *ctx.mask) + (None,) * 4


def _launch(q, k, v, causal, window, block_q, block_k):
    """One launch of the CUDA kernel on the current stream."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV,
            Sq, Sk, hd, int(causal), 0 if window is None else window,
            block_q, block_k, 1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{'unsupported shape' if err == -1 else f'CUDA error {err}'} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, tiles "
            f"{block_q}x{block_k})")
    counts.launches += 1
    return o


def flash_attention_model(q, k, v, causal: bool = True,
                          window: Optional[int] = None):
    """Model layout: q [B, S, KV, G, hd], k/v [B, S, KV, hd] ->
    [B, S, KV, G, hd], through `flash_attention` in the kernel layout."""
    B, S, KV, G, hd = q.shape
    qk = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    o = flash_attention(qk, k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal, window)
    return o.transpose(1, 2).reshape(B, S, KV, G, hd)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library of `csrc/flash_attention.cu`, built on first use, with
    the C signature of its entry point."""
    lib = build.load("flash_attention")
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_int64] \
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib
