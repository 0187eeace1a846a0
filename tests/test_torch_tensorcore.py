"""The bf16 tensor-core routes of flash attention (B4) and the SSD scan
(B5), on the CPU.

The CUDA kernels `csrc/flash_attention_tc.cu` and `csrc/ssd_scan_tc.cu`
run only on the card (tests/test_torch_cuda.py, `chip_smoke.py`).  Here:

(a) a plain PyTorch emulation of each kernel's rounding points, kept in
    this file and not in the package, held against the JAX oracle
    (`repro.kernels.ref`, and the Pallas entries in interpret mode) at the
    bf16 bar of rtol/atol 2e-2 over small versions of `chip_smoke.py`'s
    phase-11 and phase-16 sweeps.  B4: fp32 scores of bf16 inputs, the
    kernel's tile loop with fp32 m/l/acc, P rounded to bf16 before P·V.
    B5: the scaled scores, w·x and the carried state rounded to a bf16
    pair (hi, lo) before their products, as the kernel does; the same
    emulation rounding once to bf16 misses the bar, which is why the
    kernel splits;
(b) the decomposition the bf16 SSD kernel launches (seg, chunk states,
    the pass over chunks, the inter- and intra-chunk terms) in fp32
    against the sequential recurrence at fp32 1e-3, ragged S, several
    chunks;
(c) `flash_attention_model` on non-contiguous model-layout inputs against
    `repro.kernels.ops.flash_attention` at fp32 tolerance;
(d) the wrappers' dtype -> route and tile mappings, as pure functions, and
    the build's hash over the shared headers.
"""
import itertools
import math
import shutil

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_scan_ref

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SSD_FP32 = dict(rtol=1e-3, atol=1e-3)
LOG2E = 1.4426950408889634
MASKS = {"causal": (True, None), "full": (False, None),
         "window64": (True, 64), "window256": (True, 256)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf(t):
    """t rounded to bf16, back in fp32."""
    return t.to(torch.bfloat16).float()


def _split(t):
    """(hi, lo): hi = bf16(t), lo = bf16(t - hi), both in fp32."""
    hi = _bf(t)
    return hi, _bf(t - hi)


# ----------------------------------------------------------------------------
# (a) B4: the bf16 kernel's rounding points


def emulate_flash_tc(q, k, v, causal, window, block_q, block_k):
    """What `csrc/flash_attention_tc.cu` computes for bf16 q [B, H, Sq, hd],
    k/v [B, KV, Sk, hd]: per key tile of the kernel's BK, fp32 scores of
    the bf16 inputs in the log2 domain, the mask (-inf, base 0 while a
    row's max is -inf), fp32 running max, denominator and accumulator, and
    P rounded to bf16 before P·V; o = acc / max(l, 1e-30) in bf16."""
    _, bk = fa.tc_tiles(block_q, block_k)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, hd)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    scale = LOG2E / math.sqrt(hd)
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, KV, G, Sq, 1), -math.inf)
    l = torch.zeros((B, KV, G, Sq, 1))
    acc = torch.zeros((B, KV, G, Sq, hd))
    for k0 in range(0, Sk, bk):
        cols = torch.arange(k0, min(k0 + bk, Sk))[None, :]
        s = qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2) * scale
        ok = torch.ones((Sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= cols > rows - window
        s = s.masked_fill(~ok, -math.inf)
        new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(new == -math.inf, torch.zeros_like(new), new)
        corr = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf(p) @ vf[..., k0:k0 + bk, :]
        m = new
    o = acc / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, Sq, hd).to(torch.bfloat16)


def _qkv(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


FLASH_SWEEP = [(G, hd, mask, S) for G, hd, mask, S in itertools.product(
    (1, 4, 8), (32, 64, 128), MASKS, (1, 100, 300))]


@pytest.mark.parametrize("G,hd,mask,S", FLASH_SWEEP)
def test_flash_tc_emulation_holds_bf16_against_jax(G, hd, mask, S):
    """Phase 11's sweep at small S, each case at another pair of tiles."""
    causal, window = MASKS[mask]
    n = FLASH_SWEEP.index((G, hd, mask, S))
    bq, bk = list(itertools.product(fa.TILES, fa.TILES))[n % 9]
    arrays = _qkv(2, 2 * G, 2, S, hd, seed=n)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = emulate_flash_tc(q, k, v, causal, window, bq, bk)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal, window)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16)


def test_flash_tc_emulation_at_the_prefill_heads_and_pallas():
    """tinyllama's heads (32 over 4 KV heads, hd 64) at a short prompt,
    against the Pallas kernel in interpret mode too."""
    arrays = _qkv(1, 32, 4, 128, 64, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = emulate_flash_tc(q, k, v, True, None, fa.BLOCK_Q, fa.BLOCK_K)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(jax_flash(jq, jk, jv, causal=True,
                                             interpret=True)), **BF16)


@pytest.mark.parametrize("S,window", [(256, None), (300, 8)])
def test_flash_tc_emulation_tile_invariance(S, window):
    """The bf16 kernel rounds P after each tile's rescaling, so its tiles
    agree within the bf16 bar, not fp32's."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 2, S, 64, seed=1))
    outs = [emulate_flash_tc(q, k, v, True, window, bq, bk).float()
            for bq, bk in itertools.product(fa.TILES, fa.TILES)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], **BF16)


# ----------------------------------------------------------------------------
# (a), (b) B5: the bf16 kernel's decomposition and rounding points


def emulate_ssd_tc(x, dt, A, Bc, Cc, chunk, rounding="split"):
    """The steps of `csrc/ssd_scan_tc.cu` in plain PyTorch:
      0. seg = cumsum(dt A) per chunk in fp64; decay = fp32(exp(seg_last));
      1. each chunk's state (w x)^T B, w_j = dt_j fp32(exp(seg_last -
         seg_j)) with w x rounded;
      2. the pass over chunks, fp32, writing the rounded state entering
         each chunk;
      3. y = exp(seg_i) C_i state^T + (C B^T ⊙ exp(seg_i - seg_j) dt_j,
         masked, rounded) x.
    rounding: "split" rounds each computed operand to a bf16 pair (hi, lo),
    as the kernel; "once" to bf16 alone; "none" keeps fp32 (the
    decomposition itself).  x, Bc, Cc enter as they are."""
    def rnd(t):
        if rounding == "none":
            return (t,)
        if rounding == "once":
            return (_bf(t),)
        return _split(t)

    B, S, H, P = x.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    xf, Bf, Cf = x.float(), Bc.float(), Cc.float()
    y = torch.zeros((B, S, H, P))
    run = torch.zeros((B, H, P, Bc.shape[-1]))
    for c in range(nc):
        sl = slice(c * Q, min((c + 1) * Q, S))
        L = sl.stop - sl.start
        seg = torch.cumsum((dt[:, sl] * A).double(), dim=1)       # [B,L,H]
        # 3. the inter-chunk term, from the state entering this chunk
        if c > 0:
            inter = sum(torch.einsum("bin,bhpn->bihp", Cf[:, sl], part)
                        for part in rnd(run))
            y[:, sl] += inter * torch.exp(seg.float())[..., None]
        # 3. the intra-chunk term
        g = Cf[:, sl] @ Bf[:, sl].transpose(1, 2)                  # [B,L,L]
        rel = seg[:, :, None, :] - seg[:, None, :, :]              # [B,i,j,H]
        causal = torch.ones((L, L), dtype=torch.bool).tril()[None, :, :, None]
        dec = torch.where(causal, torch.exp(rel.float()), 0.0)
        m = g[..., None] * dec * dt[:, None, sl, :]
        y[:, sl] += sum(torch.einsum("bijh,bjhp->bihp", part, xf[:, sl])
                        for part in rnd(m))
        # 1. and 2.: this chunk's state, then the carry
        if c < nc - 1:
            w = dt[:, sl] * torch.exp((seg[:, -1:] - seg).float())  # [B,L,H]
            state = sum(torch.einsum("bjhp,bjn->bhpn", part, Bf[:, sl])
                        for part in rnd(xf[:, sl] * w[..., None]))
            run = run * torch.exp(seg[:, -1]).float()[..., None, None] + state
    return y.to(x.dtype)


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
    A = -np.exp(rng.standard_normal(H))
    Bc = rng.standard_normal((B, S, N))
    Cc = rng.standard_normal((B, S, N))
    return [np.asarray(a, np.float32) for a in (x, dt, A, Bc, Cc)]


def _ssd_pair(arrays, dtype):
    """(JAX inputs, torch inputs), x/Bc/Cc in `dtype`."""
    x, dt, A, Bc, Cc = arrays
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bc, jdt), jnp.asarray(Cc, jdt)]
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return j, t


SSD_SWEEP = [(S, chunk, N, P) for S, chunk, N, P in itertools.product(
    (1, 100, 300), (16, 64, 128, 512), (16, 128), (32, 64))]


@pytest.mark.parametrize("S,chunk,N,P", SSD_SWEEP)
def test_ssd_tc_emulation_holds_bf16_against_jax(S, chunk, N, P):
    """Phase 16's sweep at small S: the split rounding against the JAX
    sequential oracle at the bf16 bar."""
    arrays = _ssd_inputs(2, S, 2, P, N, seed=SSD_SWEEP.index(
        (S, chunk, N, P)))
    (jx, jdt, jA, jB, jC), t = _ssd_pair(arrays, torch.bfloat16)
    want = _np(jax_ref.ssd_scan_ref(jx, jdt, jA, jB, jC))
    got = emulate_ssd_tc(*t, chunk).float().numpy()
    np.testing.assert_allclose(got, want, **BF16)


def test_ssd_tc_emulation_against_pallas_at_the_model_head():
    """mamba2's head (P 64, N 128) over two chunks, against the Pallas
    kernel in interpret mode."""
    arrays = _ssd_inputs(1, 128, 2, 64, 128, seed=11)
    (jx, jdt, jA, jB, jC), t = _ssd_pair(arrays, torch.bfloat16)
    want = _np(jax_ssd_scan(jx, jdt, jA, jB, jC, chunk=64, interpret=True))
    np.testing.assert_allclose(emulate_ssd_tc(*t, 64).float().numpy(), want,
                               **BF16)


def test_ssd_rounding_once_misses_the_bf16_bar():
    """Why the kernel splits: at N 128 the scores reach ~10 and y ~100s;
    one bf16 rounding of the scaled scores misses 2e-2 where the pair
    holds it."""
    arrays = _ssd_inputs(2, 256, 2, 64, 128, seed=3)
    (jx, jdt, jA, jB, jC), t = _ssd_pair(arrays, torch.bfloat16)
    want = _np(jax_ref.ssd_scan_ref(jx, jdt, jA, jB, jC))
    tol = BF16["atol"] + BF16["rtol"] * np.abs(want)
    once = np.abs(emulate_ssd_tc(*t, 512, "once").float().numpy() - want)
    split = np.abs(emulate_ssd_tc(*t, 512).float().numpy() - want)
    assert (once > tol).any()
    assert (split <= tol).all()


@pytest.mark.parametrize("S,chunk", [(100, 16), (300, 64), (257, 128),
                                     (1, 16), (130, 512), (64, 64)])
def test_ssd_decomposition_matches_the_sequential_recurrence(S, chunk):
    """(b): seg, chunk states, the pass and both terms in fp32, against
    the JAX and the port's sequential recurrence at fp32 1e-3."""
    arrays = _ssd_inputs(2, S, 3, 16, 8, seed=S + chunk)
    j, t = _ssd_pair(arrays, torch.float32)
    got = emulate_ssd_tc(*t, chunk, "none").numpy()
    np.testing.assert_allclose(got, _np(jax_ref.ssd_scan_ref(*j)),
                               **SSD_FP32)
    np.testing.assert_allclose(got, ssd_scan_ref(*t).numpy(), **SSD_FP32)


# ----------------------------------------------------------------------------
# (c) the model layout with strides


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_model_layout_takes_non_contiguous_inputs(causal, window):
    """q, k, v as views of one fused [B, S, KV, G + 2, hd] projection
    (none contiguous), against the JAX adapter at fp32 tolerance."""
    rng = np.random.default_rng(5)
    B, S, KV, G, hd = 2, 96, 2, 3, 32
    fused = rng.standard_normal((B, S, KV, G + 2, hd)).astype(np.float32)
    t = torch.from_numpy(fused)
    q, k, v = t[:, :, :, :G], t[:, :, :, G], t[:, :, :, G + 1]
    assert not any(x.is_contiguous() for x in (q, k, v))
    want = jax_ops.flash_attention(jnp.asarray(fused[:, :, :, :G]),
                                   jnp.asarray(fused[:, :, :, G]),
                                   jnp.asarray(fused[:, :, :, G + 1]),
                                   causal, window)
    fa.counts.reset()
    o = fa.flash_attention_model(q, k, v, causal=causal, window=window)
    assert fa.counts.plain_calls == 1 and fa.counts.launches == 0
    assert o.shape == (B, S, KV, G, hd)
    np.testing.assert_allclose(o.numpy(), _np(want), **FP32)


def test_flash_model_layout_strided_plain_keeps_its_gradient():
    """The model-layout route's backward (the VJP of the plain version in
    that layout) equals autograd through the plain version."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 40, 2, 2, 32, generator=g, requires_grad=True)
    k = torch.randn(1, 40, 2, 32, generator=g, requires_grad=True)
    v = torch.randn(1, 40, 2, 32, generator=g, requires_grad=True)
    w = torch.randn(1, 40, 2, 2, 32, generator=g)
    got = torch.autograd.grad((fa._plain_model(q, k, v, True, 8) * w).sum(),
                              (q, k, v))
    want = torch.autograd.grad((fa.flash_attention_model(q, k, v, True, 8)
                                * w).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **FP32)


# ----------------------------------------------------------------------------
# (d) the fixed dispatch and the tile mappings


@pytest.mark.parametrize("module", [fa, ssd])
def test_route_is_fixed_by_device_and_dtype(module):
    assert module.route(torch.float32, "cpu") == "plain"
    assert module.route(torch.bfloat16, torch.device("cpu")) == "plain"
    assert module.route(torch.float32, "cuda") == "fma"
    assert module.route(torch.bfloat16, torch.device("cuda", 1)) == "wgmma"
    with pytest.raises(KeyError):
        module.route(torch.float16, "cuda")
    assert set(module.counts.routes) == {"fma", "wgmma"}


def test_flash_tile_mapping():
    """block_q/block_k below 64 run as 64 (one wgmma M); 64 and 128 stay."""
    want = {32: 64, 64: 64, 128: 128}
    for bq, bk in itertools.product(fa.TILES, fa.TILES):
        assert fa.tc_tiles(bq, bk) == (want[bq], want[bk])


def test_ssd_tc_shapes():
    assert ssd.TC_P == (32, 64)
    assert ssd.TC_N == (16, 32, 64, 128)


def test_route_counters_reset_with_the_rest():
    fa.counts.routes["wgmma"] = 3
    fa.counts.launches = 3
    fa.counts.reset()
    assert fa.counts.routes == {"fma": 0, "wgmma": 0}
    assert fa.counts.launches == 0


def test_cpu_tensors_take_the_plain_version_in_bf16():
    """The dtype picks among the CUDA routes only: a bf16 CPU tensor is
    plain, and no route is counted."""
    arrays = _ssd_inputs(1, 20, 2, 16, 8, seed=0)
    _, t = _ssd_pair(arrays, torch.bfloat16)
    ssd.counts.reset()
    ssd.ssd_scan(*t, chunk=8)
    assert (ssd.counts.plain_calls, ssd.counts.launches) == (1, 0)
    assert ssd.counts.routes == {"fma": 0, "wgmma": 0}


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited `csrc/*.cuh` must rebuild every library, or a stale one
    would be loaded."""
    for f in ("flash_attention_tc.cu", "hopper.cuh"):
        shutil.copy(build.CSRC / f, tmp_path / f)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("flash_attention_tc")
    assert build.library_path("flash_attention_tc") == before
    with open(tmp_path / "hopper.cuh", "a") as fh:
        fh.write("\n// edited\n")
    edited = build.library_path("flash_attention_tc")
    assert edited != before
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert build.library_path("flash_attention_tc") not in (before, edited)
