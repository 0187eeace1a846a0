"""The port's two streaming kernels, the blur (B3) and the sampler (B1), as
their CUDA kernels cut the work, emulated on the CPU against JAX.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
`chip_smoke.py`).  What decides their results besides the arithmetic is
how they cut the work, and that is checked here:

  B3  `kernels.imaging.band_plan` and the bands of `csrc/imaging.cu`: every
      output row is produced exactly once, from a span that holds its
      halo rows, by one block of the persistent grid; a plain emulation
      that blurs each band from its contiguous span alone matches JAX's
      `blur2d` (Pallas, interpret mode) at rtol/atol 1e-6; the port's
      plain blur matches it at image sizes the kernel used to refuse.
  B1  the row mapping of `csrc/inverse_cdf.cu`: 32-bit offsets from each
      row's base, a scalar head up to the first 16-byte boundary, 16-byte
      vectors (4 fp32 or 8 bf16), a scalar tail, or an all-scalar row when
      u and y are misaligned against each other, and the channel of each
      element from its offset; the emulation matches JAX's
      `inverse_cdf_channels` at fp32 rtol 1e-4 / atol 1e-5 and bf16 2e-2.

Inputs are made by numpy from a seed and handed to both packages.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import torch_one_thread  # noqa: F401

import jax.numpy as jnp

from repro.kernels.imaging import blur2d as jax_blur2d
from repro.kernels.inverse_cdf import \
    inverse_cdf_channels as jax_inverse_cdf_channels

from repro_torch.kernels import imaging as kimaging
from repro_torch.kernels.ref import BLUR_W0, BLUR_W1, U_EPS

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BLUR = dict(rtol=1e-6, atol=1e-6)
SMS = 132                       # an H100's SMs: the persistent grid's size
SMEM_OPTIN = 232_448            # shared memory a block may opt into
BAR_BYTES = 128                 # csrc/imaging.cu kBarBytes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16(a):
    """a rounded to bf16, as fp32 numpy (both packages can take it)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_blur(x):
    return np.asarray(jax_blur2d(jnp.asarray(x), interpret=True), np.float32)


# ----------------------------------------------------------------------------
# B3: the blur


def band_spans(K, H, rows):
    """The kernel's bands over the K·H rows (csrc/imaging.cu `band_span`,
    `launch_blur`): (g0, g1, s0, s1) for output rows [g0, g1) and the span
    [s0, s1) copied for them."""
    total = K * H
    rows = min(rows, total)
    spans = []
    for b in range(-(-total // rows)):
        g0 = b * rows
        g1 = min(g0 + rows, total)
        spans.append((g0, g1, g0 - 1 if g0 % H else g0,
                      g1 + 1 if g1 % H else g1))
    return spans


def blur_by_bands(x, rows):
    """The band path in plain PyTorch: each band blurred from its span
    alone, in fp32 and the kernel's order, written to its output rows."""
    K, H, W = x.shape
    flat = x.reshape(K * H, W).float()
    out = torch.full((K * H, W), float("nan"))
    for g0, g1, s0, s1 in band_spans(K, H, rows):
        span = flat[s0:s1].clone()              # all the kernel reads of x
        g = torch.arange(g0, g1)
        r, j = g % H, g - s0
        has_up, has_down = r < H - 1, r > 0
        assert bool((j[has_up] + 1 < len(span)).all())
        assert bool((j[has_down] - 1 >= 0).all())
        up = torch.zeros((g1 - g0, W))
        down = torch.zeros((g1 - g0, W))
        up[has_up] = span[j[has_up] + 1]
        down[has_down] = span[j[has_down] - 1]
        v = BLUR_W0 * span[j] + BLUR_W1 * (up + down)
        left = F.pad(v[:, 1:], (0, 1))          # v[c + 1]
        right = F.pad(v[:, :-1], (1, 0))        # v[c - 1]
        out[g0:g1] = BLUR_W0 * v + BLUR_W1 * (left + right)
    return out.reshape(K, H, W).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,H,W", [(3, 130, 77), (2, 256, 256), (1, 1, 300),
                                   (4, 300, 1)])
def test_plain_blur_matches_jax_at_any_size(K, H, W, dtype):
    """The sizes the kernel refused (above 227 KB an image) or takes by
    its scalar path: the port's blur on the CPU against JAX's Pallas
    kernel in interpret mode."""
    x = np.random.default_rng(K * H + W).standard_normal(
        (K, H, W)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    y = kimaging.blur2d(torch.from_numpy(x).to(DTYPES[dtype]))
    assert y.dtype == DTYPES[dtype] and y.shape == (K, H, W)
    np.testing.assert_allclose(y.float().numpy(), _jax_blur(x),
                               **(BLUR if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(32, 32), (256, 256), (130, 77), (1, 300),
                                 (300, 1), (3, 20000), (8, 8), (64, 48),
                                 (1, 5), (5, 64)])
def test_band_plan_produces_every_row_once(H, W, dtype):
    dt = DTYPES[dtype]
    itemsize = torch.finfo(dt).bits // 8
    fits = BAR_BYTES + kimaging.span_bytes(1, W, itemsize) <= SMEM_OPTIN
    default = kimaging.band_plan(H, W, dt)
    assert default is kimaging.band_plan(H, W, dt)          # cached
    if H <= default.rows:
        assert default.rows % H == 0                        # whole images
    if fits:                                # the ring fits in one block
        assert BAR_BYTES + default.stages * kimaging.span_bytes(
            default.rows, W, itemsize) <= SMEM_OPTIN
    for rows in (None, 1, 3, 64):
        plan = kimaging.band_plan(H, W, dt, rows)
        assert plan.rows == (rows or default.rows) >= 1
        assert 1 <= plan.stages <= kimaging.MAX_STAGES and plan.per_sm >= 1
        for K in (1, 3):
            spans = band_spans(K, H, plan.rows)
            grid = min(len(spans), SMS * plan.per_sm)
            walked = sorted(b for block in range(grid)
                            for b in range(block, len(spans), grid))
            assert walked == list(range(len(spans)))       # each band once
            produced = [g for g0, g1, _, _ in spans for g in range(g0, g1)]
            assert produced == list(range(K * H))          # each row once
            for g0, g1, s0, s1 in spans:
                assert s0 <= g0 < g1 <= s1 <= K * H
                # the halos of the band's rows, and only rows of its images
                assert s0 // H == g0 // H and (s1 - 1) // H == (g1 - 1) // H
                for g in (g0, g1 - 1):
                    assert g % H == 0 or s0 <= g - 1
                    assert g % H == H - 1 or g + 1 < s1
                assert (s1 - s0) * W * itemsize <= kimaging.span_bytes(
                    plan.rows, W, itemsize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,H,W", [(3, 130, 77), (2, 64, 64), (5, 8, 8),
                                   (4, 300, 1), (1, 1, 300)])
def test_blur_band_by_band_matches_jax(K, H, W, dtype):
    """Each band blurred from its own span gives JAX's blur, at the
    default plan and at band heights that cut images mid-way."""
    x = np.random.default_rng(K + H + W).standard_normal(
        (K, H, W)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    want = _jax_blur(x)
    xt = torch.from_numpy(x).to(DTYPES[dtype])
    for rows in (None, 1, 3, 7):
        got = blur_by_bands(xt, kimaging.band_plan(H, W, xt.dtype, rows).rows)
        assert not got.isnan().any()
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **(BLUR if dtype == "float32" else BF16))


# ----------------------------------------------------------------------------
# B1: the sampler


def icdf_by_rows(u_buf, offset, shape, mu, s, k):
    """The kernel's row mapping in plain PyTorch.  u is `shape` [K, E, C]
    stored `offset` elements into the 16-byte aligned `u_buf`; y is a new
    (aligned) tensor.  Returns (y, heads, tails): y in u's dtype, and how
    many rows had a scalar head or tail."""
    K, E, C = shape
    L = E * C
    item = u_buf.element_size()
    N = 16 // item                                  # elements per vector
    y = torch.full((K * L,), float("nan"))
    seen = torch.zeros(K * L, dtype=torch.int64)
    heads = tails = 0
    for r in range(K):
        au = (offset + r * L) * item % 16           # u's row base
        ay = r * L * item % 16                      # y's row base
        head, nvec = L, 0
        if au == ay:
            head = min(L, (16 - au) % 16 // item)
            nvec = (L - head) // N
        body = [head + q * N + j for q in range(nvec) for j in range(N)]
        i = torch.tensor(list(range(head)) + body
                         + list(range(head + nvec * N, L)), dtype=torch.int32)
        heads += 0 < head < L
        tails += head + nvec * N < L and nvec > 0
        ch = torch.zeros_like(i) if C == 1 else (i & 1 if C == 2 else i % C)
        ch = ch.long()
        x = u_buf[offset + r * L + i.long()].float()
        x = torch.where(x < U_EPS, torch.tensor(U_EPS), x)
        x = torch.where(x > 1.0 - U_EPS, torch.tensor(1.0 - U_EPS), x)
        y[r * L + i.long()] = (mu[r, ch] + s[r, ch] * torch.log(x / (1.0 - x))
                               + k[r, ch] * (x - 0.5))
        seen[r * L + i.long()] += 1
    assert bool((seen == 1).all())                  # every element once
    return y.reshape(shape).to(u_buf.dtype), heads, tails


@pytest.mark.parametrize("E", [1, 3, 64, 100])
@pytest.mark.parametrize("C", [1, 2, 3, 5])
def test_sampler_row_mapping_matches_jax(C, E):
    K = 6
    rng = np.random.default_rng(10 * C + E)
    u = rng.uniform(size=(K, E, C)).astype(np.float32)
    u[0, 0, 0], u[-1, -1, -1] = 0.0, 1.0                 # the clamp's edges
    mu = rng.uniform(-2.0, 2.0, (K, C)).astype(np.float32)
    s = rng.uniform(0.05, 1.0, (K, C)).astype(np.float32)
    k = rng.uniform(-1.0, 1.0, (K, C)).astype(np.float32)
    params = [torch.from_numpy(p) for p in (mu, s, k)]
    for dtype, tol in (("float32", FP32), ("bfloat16", BF16)):
        ud = u if dtype == "float32" else _bf16(u)
        want = np.asarray(jax_inverse_cdf_channels(
            *(jnp.asarray(a) for a in (ud, mu, s, k)), interpret=True),
            np.float32)
        for offset in range(4):
            buf = torch.zeros(u.size + offset, dtype=DTYPES[dtype])
            buf[offset:] = torch.from_numpy(ud).flatten().to(DTYPES[dtype])
            y, heads, tails = icdf_by_rows(buf, offset, u.shape, *params)
            assert y.dtype == DTYPES[dtype]
            np.testing.assert_allclose(y.float().numpy(), want, **tol)
            if offset == 0 and dtype == "float32" and E * C * 4 % 16 \
                    and E * C > 8:
                assert heads and tails      # ragged rows take both


def test_plan_constants_match_the_kernel():
    """The constants band_plan shares with csrc/imaging.cu."""
    src = (Path(kimaging.__file__).parent / "csrc" / "imaging.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["kBlurThreads"]) == kimaging.BLUR_THREADS
    assert int(const["kMaxStages"]) == kimaging.MAX_STAGES
    assert int(const["kBarBytes"]) == BAR_BYTES
