"""The port's CUDA kernels on the card (marker `sm90`).

These tests need an NVIDIA sm_90 (Hopper) card and skip elsewhere; the
`sm90_card` fixture decides at run time.  They import no JAX, so they run
on the card's machine, which has none:

    PYTHONPATH=src python -m pytest -q -m sm90 tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the sampler and flash attention at fp32 rtol 1e-4 / atol 1e-5
and bf16 2e-2, the mask bitwise, the blur at rtol/atol 1e-6, the SSD scan
at fp32 rtol/atol 1e-3 and bf16 2e-2) across its tile sizes; flash
attention and the SSD scan take bf16 through their tensor-core kernels
(`csrc/*_tc.cu`) and fp32 through the FMA kernels, and both routes are
held here, with the bf16 flash route's strided model layout; its wrapper
is shown to raise on what the kernel does not take, every wrapper's
gradients on the card are shown to equal the CPU's, and the solve
service, the LLM engine, the LLM trainer and the GAN trainer on the card
are shown to launch the kernels and to agree with the CPU on the same
inputs (the GAN trainer: B1 once an epoch, forward and backward; every
registered problem on its kernels, with the conv generator's backward in
full fp32; under the update cadences, B1 on each epoch where a half runs
and backward on the generator's).  Flash attention is held at head dim
80 on both routes, and at GQA group 3 (granite-moe-3b-a800m's);
non-causal at head dim 80 in the model layout at hubert-xlarge's heads,
with a depth-2 hubert forward on the card against the CPU; causal at GQA
group 7 in the model layout at internvl2-1b's heads, with a depth-2
internvl2 image-plus-prompt prefill and its greedy decode on the card
against the CPU; causal at GQA group 8, head dim 128 at
jamba-1.5-large-398b's heads, the bf16 SSD scan at its 256 heads over two
chunks, and a narrow hybrid at jamba's period prefilled and decoded on
the card against the CPU.  A train step under the remat policy "dots"
equals its step under "full" on the card, B4 or B5 recomputed as under
"full", and an LLM train state written from the card restores onto it
bit for bit.  The MoE
layer on the card is held against the CPU with capacity drops, and
is bitwise repeatable in bf16.  The exchange with the bf16 ring payload,
and the depth-k RMA mailbox's at fp32 and bf16, whole and chunked, are
bitwise the CPU's on the same gradients, and so is the overlapped pod
boundary's at depth 1 and 2.  The proc runtime's 2 worker processes on the card
are bitwise their per-rank reference, with B1 on its kernel in both.
The metrics channel's obs rows on the card equal the CPU's.
"""
import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

from repro_torch.configs.serving import REDUCED
from repro_torch.core import gan
from repro_torch.core.workflow import make_solver, solve_draws
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.imaging import (blur2d, blur_counts, mask_apply,
                                         mask_counts)
from repro_torch.kernels.inverse_cdf import (counts, inverse_cdf,
                                             inverse_cdf_channels)
from repro_torch.kernels.ref import (blur2d_ref, flash_attention_ref,
                                     inverse_cdf_ref, mask_apply_ref,
                                     ssd_chunked_ref, ssd_scan_ref)
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.problems import get_problem
from repro_torch.problems.imaging import SIGMA as IMAGING_SIGMA
from repro_torch.serving import SolveService, generate
from repro_torch.training import trainer as T

pytestmark = pytest.mark.sm90
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def sm90_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip(f"needs sm_90, found sm_"
                    f"{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, udtype, pdtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    K, C = shape[0], shape[2]
    u = torch.rand(shape, generator=g)
    mu = torch.rand((K, C), generator=g) * 4 - 2
    s = torch.rand((K, C), generator=g) * 0.95 + 0.05
    k = torch.rand((K, C), generator=g) * 2 - 1
    return (u.to(dev, udtype), mu.to(dev, pdtype), s.to(dev, pdtype),
            k.to(dev, pdtype))


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 64, 2), (1000, 77, 1), (3, 5, 2),
                                   (257, 130, 2), (8192, 100, 2),
                                   (2048, 64, 1), (8192, 100, 1),
                                   (300, 7, 3), (64, 100, 5), (5, 1, 1),
                                   (8192, 100, 3), (8192, 100, 4)])
def test_kernel_matches_plain(sm90_card, shape, udtype, pdtype):
    u, mu, s, k = _inputs(shape, udtype, pdtype, sm90_card)
    before = counts.launches
    y = inverse_cdf_channels(u, mu, s, k)
    torch.cuda.synchronize()
    assert counts.launches == before + 1
    assert y.dtype == udtype and y.shape == u.shape and y.is_cuda
    tol = FP32 if udtype == torch.float32 else BF16
    torch.testing.assert_close(y.float(), inverse_cdf_ref(u, mu, s, k).float(),
                               **tol)


@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 100, 2), (2048, 64, 1),
                                   (300, 7, 3), (17, 33, 2)])
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_kernel_on_unaligned_views(sm90_card, shape, udtype, offset):
    """u a contiguous view `offset` elements into its buffer, y a new
    (aligned) tensor: u and y are misaligned against each other, so every
    row takes the scalar path.  (Rows whose base is misaligned in both
    take a scalar head and tail: the shapes of test_kernel_matches_plain
    whose row is not a multiple of 16 bytes.)"""
    u, mu, s, k = _inputs(shape, torch.float32, torch.float32, sm90_card,
                          seed=offset)
    buf = torch.empty(u.numel() + offset, device=sm90_card, dtype=udtype)
    buf[offset:] = u.flatten().to(udtype)
    uv = buf[offset:].view(shape)
    assert uv.is_contiguous() and uv.data_ptr() % 16
    y = inverse_cdf_channels(uv, mu, s, k)
    tol = FP32 if udtype == torch.float32 else BF16
    torch.testing.assert_close(y.float(),
                               inverse_cdf_ref(uv, mu, s, k).float(), **tol)


def test_kernel_two_dim_entry_and_clamp(sm90_card):
    u = torch.tensor([[0.0, 1.0, -3.0, 4.0, 1e-7, 1 - 1e-7, 0.5,
                       float("nan")]], device=sm90_card)
    mu, s, k = (torch.tensor([v], device=sm90_card) for v in (0.3, 0.7, -0.2))
    y = inverse_cdf(u, mu, s, k)
    ref = inverse_cdf_ref(u, mu, s, k)
    assert torch.isnan(y[0, -1])
    torch.testing.assert_close(y[:, :-1], ref[:, :-1], **FP32)


def test_kernel_at_the_imaging_readout(sm90_card):
    """The imaging readout's call in training: the 2-D entry on the noise
    channel of u [512, 32, 2] (8 ranks x 64 samples, 32 events), mu = k =
    0 and s = SIGMA, one launch."""
    g = torch.Generator().manual_seed(512)
    u = torch.rand((512, 32, 2), generator=g).to(sm90_card)[..., 1]
    u = u.contiguous()
    zeros = torch.zeros(512, device=sm90_card)
    s = torch.full((512,), IMAGING_SIGMA, device=sm90_card)
    before = counts.launches
    y = inverse_cdf(u, zeros, s, zeros)
    torch.cuda.synchronize()
    assert counts.launches == before + 1
    torch.testing.assert_close(y, inverse_cdf_ref(u, zeros, s, zeros), **FP32)


def test_kernel_wrapper_raises(sm90_card):
    u, mu, s, k = _inputs((8, 16, 2), torch.float32, torch.float32, sm90_card)
    before = (counts.launches, counts.plain_calls)
    with pytest.raises(TypeError):
        inverse_cdf_channels(u.half(), mu, s, k)
    with pytest.raises(TypeError):
        inverse_cdf_channels(u, mu.bfloat16(), s, k)       # mixed params
    with pytest.raises(ValueError, match="contiguous"):
        inverse_cdf_channels(u.transpose(0, 1).contiguous().transpose(0, 1),
                             mu, s, k)
    with pytest.raises(ValueError):
        inverse_cdf_channels(u, mu.cpu(), s, k)
    assert (counts.launches, counts.plain_calls) == before


def test_service_on_the_card_launches_the_kernel(sm90_card):
    prob = get_problem("proxy1d")
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=2,
                               device=sm90_card)
    svc = SolveService(REDUCED, device=sm90_card)
    svc.register_problem("proxy1d", gen_stack=stack)
    ys = [prob.make_reference_data(torch.Generator().manual_seed(i), n,
                                   device="cpu").numpy()
          for i, n in enumerate((5, 16, 40, 64))]
    counts.reset()
    tickets = [svc.submit("proxy1d", y) for y in ys]
    svc.run_until_empty()
    assert counts.plain_calls == 0
    assert counts.launches == svc.cache.stats["compiles"] + 2   # 2 batches
    cpu = SolveService(REDUCED, device="cpu")
    cpu.register_problem("proxy1d", gen_stack=stack)
    cpu_tickets = [cpu.submit("proxy1d", y) for y in ys]
    cpu.run_until_empty()
    for t, c in zip(tickets, cpu_tickets):
        for key in ("params", "sigma", "score"):
            np.testing.assert_allclose(t.result()[key], c.result()[key],
                                       **FP32)


def test_solver_draws_are_device_independent(sm90_card):
    prob = get_problem("proxy1d")
    cpu = solve_draws(REDUCED.solve, 2, prob, "cpu")
    card = solve_draws(REDUCED.solve, 2, prob, sm90_card)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    stack = gan.init_generator(torch.Generator().manual_seed(1), ranks=2,
                               device="cpu")
    ys = torch.zeros(1, 16, 2)
    mask = torch.ones(1, 16, dtype=torch.bool)
    out_cpu = make_solver(prob, REDUCED.solve, cpu)(stack, ys, mask)
    out_card = make_solver(prob, REDUCED.solve, card)(
        [{k: v.to(sm90_card) for k, v in layer.items()} for layer in stack],
        ys.to(sm90_card), mask.to(sm90_card))
    for key, v in out_cpu.items():
        torch.testing.assert_close(out_card[key].cpu(), v, **FP32)


# ----------------------------------------------------------------------------
# the imaging kernels


@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,P", [(2048, 1024), (512, 1024), (1, 32), (7, 100),
                                 (300, 128), (257, 130)])
def test_mask_kernel_matches_plain_bitwise(sm90_card, K, P, dtype, mdtype):
    g = torch.Generator().manual_seed(K + P)
    x = torch.randn((K, P), generator=g).to(sm90_card, dtype)
    m = (torch.rand(P, generator=g) > 0.4).to(sm90_card, mdtype)
    want = mask_apply_ref(x, m)
    for threads in (32, 96, 256, 1024):       # ragged against every size
        before = mask_counts.launches
        y = mask_apply(x, m, threads=threads)
        torch.cuda.synchronize()
        assert mask_counts.launches == before + 1
        assert y.dtype == dtype and y.shape == (K, P) and y.is_cuda
        assert torch.equal(y, want), threads


BLUR_ROWS = (None, 1, 3, 4, 32, 64, 1000)      # band heights; None: the plan's


def _blur_sweep(x, K, H, W, dtype):
    """The blur at every band height of BLUR_ROWS: one launch each, all
    bitwise equal, and the first equal to the plain version at 1e-6."""
    want = blur2d_ref(x)
    outs = []
    for rows in BLUR_ROWS:
        before = blur_counts.launches
        outs.append(blur2d(x, rows=rows))
        torch.cuda.synchronize()
        assert blur_counts.launches == before + 1
    for y in outs:
        assert y.dtype == dtype and y.shape == (K, H, W) and y.is_cuda
        assert torch.equal(y, outs[0])
    torch.testing.assert_close(outs[0].float(), want.float(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,H,W", [(2048, 32, 32), (512, 32, 32), (1, 8, 8),
                                   (5, 32, 32),
                                   (20, 16, 24), (3, 1, 5), (33, 64, 48),
                                   (2, 128, 128), (2, 256, 256),
                                   (16, 256, 256), (3, 130, 77), (1, 1, 300),
                                   (4, 300, 1), (1, 3, 20000)])
def test_blur_kernel_matches_plain(sm90_card, K, H, W, dtype):
    """Every band height gives the same result (bitwise), ragged bands
    included, at every image size: the band path (16-byte rows) and the
    scalar path (other rows, and (1, 3, 20000), whose three fp32 rows do
    not fit in shared memory)."""
    g = torch.Generator().manual_seed(K + H * W)
    x = torch.randn((K, H, W), generator=g).to(sm90_card, dtype)
    _blur_sweep(x, K, H, W, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,H,W", [(16, 256, 256), (3, 130, 77),
                                   (2048, 32, 32)])
def test_blur_kernel_on_an_unaligned_view(sm90_card, K, H, W, dtype):
    """x a contiguous view one element into its buffer: its rows are not
    16-byte aligned, and the kernel takes its scalar path."""
    g = torch.Generator().manual_seed(K + H * W + 1)
    buf = torch.randn(K * H * W + 1, generator=g).to(sm90_card, dtype)
    x = buf[1:].view(K, H, W)
    assert x.is_contiguous() and x.data_ptr() % 16
    _blur_sweep(x, K, H, W, dtype)


def test_imaging_wrappers_raise_on_the_card(sm90_card):
    x = torch.randn(16, 64, device=sm90_card)
    m = torch.ones(64, device=sm90_card)
    img = torch.randn(4, 32, 32, device=sm90_card)
    before = (mask_counts.launches, mask_counts.plain_calls,
              blur_counts.launches, blur_counts.plain_calls)
    with pytest.raises(ValueError, match="contiguous"):
        mask_apply(x[:, ::2], m[:32])
    with pytest.raises(ValueError, match="contiguous"):
        blur2d(img.transpose(1, 2))
    with pytest.raises(TypeError):
        mask_apply(x.half(), m)
    with pytest.raises(TypeError):
        blur2d(img.double())
    with pytest.raises(ValueError, match="cpu"):
        mask_apply(x, m.cpu())
    assert (mask_counts.launches, mask_counts.plain_calls,
            blur_counts.launches, blur_counts.plain_calls) == before
    u = torch.rand(8, 16, 2, device=sm90_card)
    with pytest.raises(ValueError, match="contiguous"):
        inverse_cdf(u[..., 1], torch.zeros(8, device=sm90_card),
                    torch.full((8,), 0.05, device=sm90_card),
                    torch.zeros(8, device=sm90_card))


@pytest.mark.parametrize("name", ["imaging", "imaging_blur"])
def test_imaging_service_on_the_card_launches_the_kernels(sm90_card, name):
    """One sampler launch and one mask (or blur) launch per solver call, no
    plain call, cuDNN's TF32 flag as it was; the results agree with the
    CPU's on the same stack and draws."""
    prob = get_problem(name)
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=2,
                               device="cpu", param_shape=prob.param_shape)
    ys = [prob.make_reference_data(torch.Generator().manual_seed(i), n,
                                   device="cpu").numpy()
          for i, n in enumerate((5, 16, 40, 64))]
    tf32 = torch.backends.cudnn.allow_tf32
    svc = SolveService(REDUCED, device=sm90_card)
    svc.register_problem(name, gen_stack=stack)
    for c in (counts, mask_counts, blur_counts):
        c.reset()
    tickets = [svc.submit(name, y) for y in ys]
    svc.run_until_empty()
    calls = svc.cache.stats["compiles"] + 2                # 2 batches
    forward, other = (mask_counts, blur_counts) if name == "imaging" \
        else (blur_counts, mask_counts)
    assert (counts.launches, forward.launches, other.launches) == \
        (calls, calls, 0)
    assert counts.plain_calls == forward.plain_calls == 0
    assert torch.backends.cudnn.allow_tf32 == tf32
    cpu = SolveService(REDUCED, device="cpu")
    cpu.register_problem(name, gen_stack=stack)
    cpu_tickets = [cpu.submit(name, y) for y in ys]
    cpu.run_until_empty()
    for t, c in zip(tickets, cpu_tickets):
        for key in ("params", "sigma", "score"):
            np.testing.assert_allclose(t.result()[key], c.result()[key],
                                       **FP32)


# ----------------------------------------------------------------------------
# flash attention (B4) and the LLM engine

TILES = [(bq, bk) for bq in (32, 64, 128) for bk in (32, 64, 128)]
MASKS = {"causal": (True, None), "full": (False, None),
         "window64": (True, 64), "window256": (True, 256)}


def _qkv(B, H, KV, S, hd, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dev, dtype)
                 for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_kernel_matches_plain(sm90_card, G, hd, mask, dtype):
    """Ragged lengths 1, 100 and 1000, each at another pair of tiles; hd
    80 is hubert-xlarge's (1280 / 16): 80 / 16 columns a thread on the
    fp32 route, five 32-byte swizzle atoms on the bf16 one."""
    causal, window = MASKS[mask]
    for n, S in enumerate((1, 100, 1000)):
        bq, bk = TILES[(G + hd + 3 * n + len(mask)) % len(TILES)]
        q, k, v = _qkv(2, 2 * G, 2, S, hd, dtype, sm90_card, seed=S)
        before = fa.counts.launches
        o = fa.flash_attention(q, k, v, causal, window, block_q=bq,
                               block_k=bk)
        torch.cuda.synchronize()
        assert fa.counts.launches == before + 1
        assert o.dtype == dtype and o.shape == q.shape and o.is_cuda
        torch.testing.assert_close(
            o.float(), flash_attention_ref(q, k, v, causal, window).float(),
            **(FP32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("S,window", [(256, None), (1000, 64), (300, 8)])
def test_flash_kernel_tile_invariance(sm90_card, S, window):
    """Every pair of tiles gives the result of the first within rtol 1e-5
    / atol 1e-6 (tests/test_kernels.py::test_flash_attention_block_shapes);
    a window of 8 is narrower than every tile."""
    q, k, v = _qkv(1, 4, 2, S, 64, torch.float32, sm90_card, seed=1)
    outs = [fa.flash_attention(q, k, v, True, window, block_q=bq,
                               block_k=bk) for bq, bk in TILES]
    torch.cuda.synchronize()
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs[0], flash_attention_ref(q, k, v, True,
                                                            window), **FP32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_prefill_shape(sm90_card, dtype):
    """tinyllama-1.1b's prefill at batch 8, prompt 1024."""
    q, k, v = _qkv(8, 32, 4, 1024, 64, dtype, sm90_card, seed=2)
    o = fa.flash_attention(q, k, v, True, None)
    torch.testing.assert_close(
        o.float(), flash_attention_ref(q, k, v, True, None).float(),
        **(FP32 if dtype == torch.float32 else BF16))


def test_flash_wrapper_raises_on_the_card(sm90_card):
    q, k, v = _qkv(1, 4, 2, 16, 64, torch.float32, sm90_card)
    before = (fa.counts.launches, fa.counts.plain_calls)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*(t[..., :48].contiguous() for t in (q, k, v)))
    assert (fa.counts.launches, fa.counts.plain_calls) == before


@pytest.mark.parametrize("dtype,route", [(torch.float32, "fma"),
                                         (torch.bfloat16, "wgmma")])
def test_flash_route_follows_the_dtype(sm90_card, dtype, route):
    """fp32 takes flash_attention.cu, bf16 flash_attention_tc.cu: one
    launch each, counted under its route."""
    q, k, v = _qkv(1, 4, 2, 100, 64, dtype, sm90_card)
    fa.counts.reset()
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.counts.launches == 1 and fa.counts.routes[route] == 1
    assert sum(fa.counts.routes.values()) == 1


@pytest.mark.parametrize("S,window", [(256, None), (1000, 64), (300, 8)])
def test_flash_tc_tile_invariance(sm90_card, S, window):
    """The bf16 route rounds P after each tile's rescaling: every pair of
    tiles within the bf16 bar of the first, and of the plain version."""
    q, k, v = _qkv(1, 4, 2, S, 64, torch.bfloat16, sm90_card, seed=1)
    outs = [fa.flash_attention(q, k, v, True, window, block_q=bq,
                               block_k=bk).float() for bq, bk in TILES]
    torch.cuda.synchronize()
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], **BF16)
    torch.testing.assert_close(outs[0], flash_attention_ref(
        q, k, v, True, window).float(), **BF16)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,window", [(1024, None), (100, None), (300, 8)])
def test_flash_tc_model_layout_reads_strides(sm90_card, hd, S, window):
    """The bf16 route reads q/k/v as views of one fused projection [B, S,
    KV, G + 2, hd] (no copies) and writes o in the model layout."""
    B, KV, G = 2, 2, 4
    g = torch.Generator().manual_seed(hd + S)
    fused = torch.randn(B, S, KV, G + 2, hd, generator=g).to(
        sm90_card, torch.bfloat16)
    q, k, v = fused[:, :, :, :G], fused[:, :, :, G], fused[:, :, :, G + 1]
    fa.counts.reset()
    o = fa.flash_attention_model(q, k, v, True, window)
    torch.cuda.synchronize()
    assert fa.counts.routes == {"fma": 0, "wgmma": 1}
    assert o.shape == (B, S, KV, G, hd) and o.is_contiguous()
    torch.testing.assert_close(o.float(), fa._plain_model(
        q, k, v, True, window).float(), **BF16)


def test_flash_tc_model_layout_backward(sm90_card):
    """The bf16 model-layout route's backward is the VJP of the plain
    version in that layout, on the card."""
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(2, 100, 2, 4, 64, generator=g),
          torch.randn(2, 100, 2, 64, generator=g),
          torch.randn(2, 100, 2, 64, generator=g)]
    w = torch.randn(2, 100, 2, 4, 64, generator=g).to(sm90_card)
    grads, seen = [], []
    for fn in (fa.flash_attention_model, fa._plain_model):
        ts = [x.to(sm90_card, torch.bfloat16).requires_grad_() for x in xs]
        fa.counts.reset()
        (fn(*ts, True, 16).float() * w).sum().backward()
        grads.append([t.grad.float() for t in ts])
        seen.append((dict(fa.counts.routes), fa.counts.backward_plain))
    assert seen == [({"fma": 0, "wgmma": 1}, 1), ({"fma": 0, "wgmma": 0}, 0)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **BF16)


def test_flash_tc_refuses_what_tma_cannot_read(sm90_card):
    q = torch.zeros(1, 16, 1, 2, 36, device=sm90_card,
                    dtype=torch.bfloat16)[..., :32]     # rows 72 B apart
    k = torch.zeros(1, 16, 1, 32, device=sm90_card, dtype=torch.bfloat16)
    fa.counts.reset()
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_model(q, k, k)
    assert fa.counts.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_gqa_group_3(sm90_card, dtype):
    """granite-moe-3b-a800m's attention: 24 heads over 8 KV heads (group
    3), head dim 64, causal, in both layouts against the plain version:
    the kernel layout at ragged lengths, and the model layout at its
    training shape q [8, 256, 8, 3, 64]."""
    tol = FP32 if dtype == torch.float32 else BF16
    for S in (1, 100, 256):
        q, k, v = _qkv(2, 24, 8, S, 64, dtype, sm90_card, seed=S + 3)
        o = fa.flash_attention(q, k, v, True, None)
        torch.testing.assert_close(
            o.float(), flash_attention_ref(q, k, v, True, None).float(), **tol)
    g = torch.Generator().manual_seed(33)
    q = torch.randn(8, 256, 8, 3, 64, generator=g).to(sm90_card, dtype)
    k, v = (torch.randn(8, 256, 8, 64, generator=g).to(sm90_card, dtype)
            for _ in range(2))
    fa.counts.reset()
    o = fa.flash_attention_model(q, k, v, True, None)
    torch.cuda.synchronize()
    route = "fma" if dtype == torch.float32 else "wgmma"
    assert fa.counts.routes[route] == 1 and fa.counts.launches == 1
    torch.testing.assert_close(o.float(), fa._plain_model(
        q, k, v, True, None).float(), **tol)


def test_flash_tc_non_causal_at_hubert_heads(sm90_card):
    """hubert-xlarge's attention: 16 heads of 80 (G 1), no mask, in the
    model layout q [2, 256, 16, 1, 80] bf16 on the wgmma route, forward
    and backward, against the plain version."""
    g = torch.Generator().manual_seed(50)
    xs = [torch.randn(2, 256, 16, 1, 80, generator=g),
          torch.randn(2, 256, 16, 80, generator=g),
          torch.randn(2, 256, 16, 80, generator=g)]
    w = torch.randn(2, 256, 16, 1, 80, generator=g).to(sm90_card)
    outs, grads = [], []
    for fn in (fa.flash_attention_model, fa._plain_model):
        ts = [x.to(sm90_card, torch.bfloat16).requires_grad_() for x in xs]
        fa.counts.reset()
        o = fn(*ts, False, None)
        (o.float() * w).sum().backward()
        torch.cuda.synchronize()
        outs.append(o.detach().float())
        grads.append([t.grad.float() for t in ts])
        if fn is fa.flash_attention_model:
            assert fa.counts.routes == {"fma": 0, "wgmma": 1}
            assert fa.counts.backward_plain == 1
    torch.testing.assert_close(outs[0], outs[1], **BF16)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **BF16)


def test_hubert_forward_on_the_card_matches_the_cpu(sm90_card):
    """hubert-xlarge at full width, depth 2, fp32 (TF32 off), batch 1, 64
    frames: one B4 launch a layer on the card (the fp32 route), none on
    the CPU, and the logits agree within 1e-3."""
    from repro_torch.data import make_batch
    cfg = get_config("hubert-xlarge").replace(num_layers=2, dtype="float32")
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = make_batch(cfg, 1, 64, seed=1, device="cpu")
    runs = {}
    for dev in ("cpu", sm90_card):
        fa.counts.reset()
        with torch.no_grad():
            logits, _ = M.forward(
                M.map_params(lambda t: t.to(dev), params),
                {k: v.to(dev) for k, v in batch.items()}, cfg)
        runs[str(dev)] = (logits.cpu(), fa.counts.launches,
                          fa.counts.plain_calls)
    (lg_c, l_c, p_c), (lg_g, l_g, p_g) = runs.values()
    assert (l_c, p_c) == (0, 2) and (l_g, p_g) == (2, 0)
    assert lg_g.shape == (1, 64, 504) and torch.isfinite(lg_g).all()
    torch.testing.assert_close(lg_g, lg_c, rtol=0, atol=1e-3)


def test_flash_tc_causal_at_internvl2_heads(sm90_card):
    """internvl2-1b's attention: 14 heads over 2 KV heads (GQA group 7,
    odd and not a power of two) of 64, causal, in the model layout q [2,
    256, 2, 7, 64] bf16 on the wgmma route, forward and backward, against
    the plain version."""
    g = torch.Generator().manual_seed(53)
    xs = [torch.randn(2, 256, 2, 7, 64, generator=g),
          torch.randn(2, 256, 2, 64, generator=g),
          torch.randn(2, 256, 2, 64, generator=g)]
    w = torch.randn(2, 256, 2, 7, 64, generator=g).to(sm90_card)
    outs, grads = [], []
    for fn in (fa.flash_attention_model, fa._plain_model):
        ts = [x.to(sm90_card, torch.bfloat16).requires_grad_() for x in xs]
        fa.counts.reset()
        o = fn(*ts, True, None)
        (o.float() * w).sum().backward()
        torch.cuda.synchronize()
        outs.append(o.detach().float())
        grads.append([t.grad.float() for t in ts])
        if fn is fa.flash_attention_model:
            assert fa.counts.routes == {"fma": 0, "wgmma": 1}
            assert fa.counts.backward_plain == 1
    torch.testing.assert_close(outs[0], outs[1], **BF16)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **BF16)


def test_internvl2_prefill_and_decode_on_the_card_match_the_cpu(sm90_card):
    """internvl2-1b at full width (d_model 896, 14 heads over 2, d_ff
    4864), depth 2, its vocab cut to 257, fp32 (TF32 off): an
    image-plus-prompt batch (16 patches, 16 tokens) prefilled, then two
    greedy decode steps.  One B4 launch a layer on the card (the fp32
    route), a plain call on the CPU; the logits agree within 1e-3 and the
    greedy tokens are equal."""
    from repro_torch.data import make_batch
    cfg = get_config("internvl2-1b").replace(num_layers=2, vocab_size=257,
                                             dtype="float32")
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = make_batch(cfg, 1, 32, seed=1, device="cpu")
    assert batch["vision"].shape == (1, 16, M.VISION_EMB_DIM)
    runs = {}
    for dev in ("cpu", sm90_card):
        p = M.map_params(lambda t: t.to(dev), params)
        fa.counts.reset()
        with torch.no_grad():
            logits, cache = M.prefill(p, {k: v.to(dev) for k, v in
                                          batch.items()}, cfg, 40)
            seen, toks = [logits.cpu()], []
            for _ in range(2):
                toks.append(torch.argmax(seen[-1][:, -1:], -1))
                lg, cache = M.decode_step(p, toks[-1].to(dev), cache, cfg)
                seen.append(lg.cpu())
        assert cache["pos"] == 34
        runs[str(dev)] = (seen, toks, fa.counts.launches,
                          fa.counts.plain_calls)
    (lg_c, tk_c, l_c, p_c), (lg_g, tk_g, l_g, p_g) = runs.values()
    assert (l_c, p_c) == (0, 2) and (l_g, p_g) == (2, 0)
    assert lg_g[0].shape == (1, 32, 257)
    for a, b in zip(lg_g, lg_c):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(tk_g, tk_c))


def test_flash_tc_causal_at_jamba_heads(sm90_card):
    """jamba-1.5-large-398b's attention: 64 heads over 8 KV heads (GQA
    group 8) of 128, causal, in the model layout q [2, 256, 8, 8, 128]
    bf16 (a q row stride of 16,384 B) on the wgmma route, against the
    plain version."""
    g = torch.Generator().manual_seed(56)
    q = torch.randn(2, 256, 8, 8, 128, generator=g).to(sm90_card,
                                                        torch.bfloat16)
    k, v = (torch.randn(2, 256, 8, 128, generator=g).to(sm90_card,
                                                         torch.bfloat16)
            for _ in range(2))
    fa.counts.reset()
    o = fa.flash_attention_model(q, k, v, True, None)
    torch.cuda.synchronize()
    assert fa.counts.routes == {"fma": 0, "wgmma": 1}
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    torch.testing.assert_close(o.float(), fa._plain_model(
        q, k, v, True, None).float(), **BF16)


def test_ssd_tc_at_jamba_heads(sm90_card):
    """jamba-1.5-large-398b's Mamba-2 mixer: 256 heads of P 64, N 128,
    chunk 256, over two chunks (the chunk-state pass on 2 x 1 x 256
    blocks; an x row stride of 32,768 B), bf16 on the wgmma route, against
    the plain version."""
    xs = _ssd(2, 512, 256, 64, 128, torch.bfloat16, sm90_card, seed=57)
    ssd.counts.reset()
    y = ssd.ssd_scan(*xs, chunk=256)
    torch.cuda.synchronize()
    assert ssd.counts.routes == {"fma": 0, "wgmma": 1}
    assert y.dtype == torch.bfloat16 and y.shape == xs[0].shape
    torch.testing.assert_close(y.float(),
                               ssd_chunked_ref(*xs, 256)[0].float(), **BF16)


def test_hybrid_prefill_and_decode_on_the_card_match_the_cpu(sm90_card):
    """A narrow hybrid at jamba's period (8 layers: attention at offset 4
    with 8 heads over 1 of 128, 7 Mamba-2 mixers of P 64, N 128, chunk
    256; MoE of 4 experts on the odd layers), fp32 (TF32 off): a 2 x 300
    prompt prefilled, then a greedy decode step.  The prefill's one B4
    launch on the card (the fp32 route), a plain call on the CPU, and no
    B5 call on either (the prefill's scan is plain); the logits agree
    within 1e-3, the greedy tokens, `pos` and the routing are equal."""
    from repro_torch.data import make_batch
    cfg = get_config("jamba-1.5-large-398b").replace(
        num_layers=8, d_model=1024, num_heads=8, num_kv_heads=1, d_ff=2048,
        num_experts=4, moe_d_ff=2048, vocab_size=257, dtype="float32")
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = make_batch(cfg, 2, 300, seed=1, device="cpu")
    runs = {}
    for dev in ("cpu", sm90_card):
        p = M.map_params(lambda t: t.to(dev), params)
        tap = moe.Tap(record=True)
        fa.counts.reset()
        ssd.counts.reset()
        with torch.no_grad():
            logits, cache = M.prefill(p, {"tokens": batch["tokens"].to(dev)},
                                      cfg, 310, tap=tap)
            tok = torch.argmax(logits[:, -1:], -1)
            lg, cache = M.decode_step(p, tok, cache, cfg, tap)
        assert cache["pos"] == 301
        runs[str(dev)] = (logits.cpu(), lg.cpu(), tok.cpu(),
                          torch.argmax(lg, -1).cpu(), tap.routes,
                          (fa.counts.launches, fa.counts.plain_calls,
                           ssd.counts.launches, ssd.counts.plain_calls))
    (pc, dc, tc, nc, rc, cc), (pg, dg, tg, ng, rg, cg) = runs.values()
    assert cc == (0, 1, 0, 0) and cg == (1, 0, 0, 0)
    assert all(torch.equal(a[1], b[1]) for a, b in zip(rg, rc))
    for a, b in ((pg, pc), (dg, dc)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    assert torch.equal(tg, tc) and torch.equal(ng, nc)


@pytest.mark.parametrize("window", [None, 8])
def test_llm_engine_on_the_card_launches_flash(sm90_card, window):
    """The tinyllama smoke config in fp32: one B4 launch per layer and
    prefill, no plain call, and the card's logits and greedy tokens are
    the CPU's on the same weights."""
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(
        dtype="float32", sliding_window=window)
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", sm90_card):
        logits = []
        fa.counts.reset()
        out = generate(M.map_params(lambda t: t.to(dev), params), cfg,
                       tok.to(dev), 6,
                       on_logits=lambda i, lg: logits.append(lg.cpu()))
        runs[str(dev)] = (out.cpu(), logits, fa.counts.launches,
                          fa.counts.plain_calls)
    (out_c, lg_c, l_c, p_c), (out_g, lg_g, l_g, p_g) = runs.values()
    assert (l_c, p_c) == (0, cfg.num_layers)
    assert (l_g, p_g) == (cfg.num_layers, 0)
    assert torch.equal(out_c, out_g)
    for a, b in zip(lg_g, lg_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


# ----------------------------------------------------------------------------
# the MoE layer and the MoE engine


def _moe_inputs(arch, dev, dtype=torch.float32, seed=0):
    """A smoke config's MoE layer at capacity factor 1.25 with a router
    biased towards experts 0 and 2, so that capacity drops entries: (cfg,
    params, x [4, 64, D]) on `dev`."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg, torch.float32,
                     "cpu")
    p["router"][:, [0, 2]] += 0.05
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1)) + 0.5
    router = p["router"]
    p = M.map_params(lambda t: t.to(dev, dtype), p)
    p["router"] = router.to(dev)                   # fp32 in a bf16 model
    return cfg, p, x.to(dev, dtype)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_moe_layer_on_the_card_matches_the_cpu(sm90_card, arch):
    """fp32, TF32 off, with capacity drops: the same routing, y within
    rtol 1e-4 / atol 1e-5 and aux within 1e-6 of the CPU's; in bf16 two
    card runs are bitwise equal (no atomic adds, no row written twice)."""
    outs = []
    for dev in ("cpu", sm90_card):
        cfg, p, x = _moe_inputs(arch, dev)
        tap = moe.Tap(record=True)
        y, aux = moe.run_moe(p, x, cfg, tap)
        outs.append((y.cpu(), float(aux), tap.dropped,
                     torch.sort(tap.routes[0][1]).values))
    (y_c, a_c, d_c, i_c), (y_g, a_g, d_g, i_g) = outs
    assert d_c == d_g > 0 and torch.equal(i_c, i_g)
    torch.testing.assert_close(y_g, y_c, **FP32)
    assert abs(a_g - a_c) <= 1e-6 * abs(a_c)
    cfg, p, x = _moe_inputs(arch, sm90_card, torch.bfloat16)
    cfg = cfg.replace(dtype="bfloat16")
    runs = [moe.run_moe(p, x, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0][0].dtype == torch.bfloat16
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_moe_engine_on_the_card_launches_flash(sm90_card):
    """qwen2-moe-smoke in fp32: one B4 launch per layer and prefill, no
    plain call, the card's greedy tokens the CPU's."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", sm90_card):
        logits = []
        fa.counts.reset()
        out = generate(M.map_params(lambda t: t.to(dev), params), cfg,
                       tok.to(dev), 6,
                       on_logits=lambda i, lg: logits.append(lg.cpu()))
        runs.append((out.cpu(), logits, fa.counts.launches,
                     fa.counts.plain_calls))
    (out_c, lg_c, l_c, p_c), (out_g, lg_g, l_g, p_g) = runs
    assert (l_c, p_c) == (0, cfg.num_layers)
    assert (l_g, p_g) == (cfg.num_layers, 0)
    assert torch.equal(out_c, out_g)
    for a, b in zip(lg_g, lg_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


# ----------------------------------------------------------------------------
# the SSD scan (B5), the gradients of every wrapper, and the LLM trainer


def _ssd(B, S, H, P, N, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g))
    Bc, Cc = (torch.randn(B, S, N, generator=g) for _ in range(2))
    return [x.to(dev, dtype), dt.to(dev), A.to(dev), Bc.to(dev, dtype),
            Cc.to(dev, dtype)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (2, 128, 3, 32, 16, 32, torch.float32),
    (1, 100, 2, 64, 128, 64, torch.float32),
    (1, 64, 1, 16, 8, 16, torch.float32),
    (2, 96, 4, 32, 32, 48, torch.float32),
    (1, 1, 2, 64, 128, 512, torch.float32),
    (2, 1000, 2, 64, 16, 128, torch.float32),
    (2, 1000, 2, 32, 128, 512, torch.bfloat16),
    (8, 256, 24, 64, 128, 512, torch.float32),
    (8, 256, 24, 64, 128, 512, torch.bfloat16),
])
def test_ssd_kernel_matches_plain(sm90_card, B, S, H, P, N, chunk, dtype):
    """tests/test_kernels.py's sweep, ragged S, and mamba2-130m's training
    shape, at every tile."""
    xs = _ssd(B, S, H, P, N, dtype, sm90_card, seed=S)
    want = ssd_chunked_ref(*xs, chunk)[0].float()
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == torch.float32 else BF16
    for tile in ssd.TILES:
        before = ssd.counts.launches
        y = ssd.ssd_scan(*xs, chunk=chunk, tile=tile)
        torch.cuda.synchronize()
        assert ssd.counts.launches == before + 1
        assert y.dtype == dtype and y.shape == xs[0].shape and y.is_cuda
        torch.testing.assert_close(y.float(), want, **tol)
    if S <= 128:
        torch.testing.assert_close(y.float(), ssd_scan_ref(*xs).float(),
                                   **tol)


@pytest.mark.parametrize("S,chunk,N,P", [
    (S, chunk, N, P) for S in (1, 100, 1000) for chunk in (16, 64, 128, 512)
    for N, P in ((16, 32), (128, 64))] + [(2048, 512, 128, 64),
                                          (300, 64, 64, 32),
                                          (200, 48, 32, 64)])
def test_ssd_tc_matches_plain(sm90_card, S, chunk, N, P):
    """The bf16 route over phase 16's sweep and the multi-chunk shape: one
    call, counted once under its route, within the bf16 bar."""
    xs = _ssd(2, S, 3, P, N, torch.bfloat16, sm90_card, seed=S + chunk)
    ssd.counts.reset()
    y = ssd.ssd_scan(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.counts.launches == 1
    assert ssd.counts.routes == {"fma": 0, "wgmma": 1}
    assert y.dtype == torch.bfloat16 and y.shape == xs[0].shape
    torch.testing.assert_close(y.float(),
                               ssd_chunked_ref(*xs, chunk)[0].float(), **BF16)


def test_ssd_tc_tile_and_chunk_agree(sm90_card):
    """Every `tile` runs as 64 rows (bitwise equal); chunks agree within
    the bf16 bar."""
    xs = _ssd(1, 300, 2, 64, 128, torch.bfloat16, sm90_card, seed=2)
    by_tile = [ssd.ssd_scan(*xs, chunk=64, tile=t) for t in ssd.TILES]
    by_chunk = [ssd.ssd_scan(*xs, chunk=c) for c in (16, 64, 128, 512)]
    torch.cuda.synchronize()
    for y in by_tile[1:]:
        assert torch.equal(y, by_tile[0])
    for y in by_chunk[1:]:
        torch.testing.assert_close(y.float(), by_chunk[0].float(), **BF16)


def test_ssd_tc_refuses_shapes_it_does_not_take(sm90_card):
    xs = _ssd(1, 16, 2, 16, 8, torch.bfloat16, sm90_card)
    ssd.counts.reset()
    with pytest.raises(ValueError, match="bf16 SSD kernel"):
        ssd.ssd_scan(*xs)
    with pytest.raises(ValueError, match="bf16 SSD kernel"):
        ssd.ssd_scan(*_ssd(1, 16, 2, 64, 256, torch.bfloat16, sm90_card))
    assert ssd.counts.launches == 0


def test_ssd_kernel_chunk_and_tile_invariance(sm90_card):
    """Chunks 16-512 and every tile within 1e-4 of chunk 16, tile 32, at
    tests/test_kernels.py::test_ssd_chunk_invariance's P and N, ragged S."""
    xs = _ssd(1, 300, 2, 16, 8, torch.float32, sm90_card, seed=1)
    outs = [ssd.ssd_scan(*xs, chunk=c, tile=t)
            for c in (16, 64, 128, 512) for t in ssd.TILES]
    torch.cuda.synchronize()
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-4, atol=1e-4)


def test_ssd_wrapper_raises_on_the_card(sm90_card):
    x, dt, A, Bc, Cc = _ssd(1, 16, 2, 8, 4, torch.float32, sm90_card)
    before = (ssd.counts.launches, ssd.counts.plain_calls)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bc, Cc)
    with pytest.raises(ValueError, match="cpu"):
        ssd.ssd_scan(x, dt.cpu(), A, Bc, Cc)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, A, Bc.bfloat16(), Cc)
    with pytest.raises(RuntimeError, match="ssd_scan kernel"):
        big = _ssd(1, 8, 1, 128, 512, torch.float32, sm90_card)
        ssd.ssd_scan(*big, tile=128)      # state + tiles above 227 KB
    assert (ssd.counts.launches, ssd.counts.plain_calls) == before


def _grad_cases(dev):
    g = torch.Generator().manual_seed(3)
    u = torch.rand(6, 9, 2, generator=g)
    mu, s, k = (torch.rand(6, 2, generator=g) for _ in range(3))
    q = torch.randn(2, 40, 2, 2, 32, generator=g)
    kv = [torch.randn(2, 40, 2, 32, generator=g) for _ in range(2)]
    return {
        "inverse_cdf": (lambda *a: inverse_cdf_channels(*a),
                        [u, mu, s + 0.1, k - 0.5], counts),
        "mask_apply": (mask_apply, [torch.randn(8, 40, generator=g),
                                    (torch.rand(40, generator=g) > 0.4)
                                    .float()], mask_counts),
        "blur2d": (blur2d, [torch.randn(3, 8, 12, generator=g)],
                   blur_counts),
        # imaging training's shapes: 8 ranks x 64 images
        "mask_apply@train": (mask_apply, [
            torch.randn(512, 1024, generator=g),
            (torch.rand(1024, generator=g) > 0.4).float()], mask_counts),
        "blur2d@train": (blur2d, [torch.randn(512, 32, 32, generator=g)],
                         blur_counts),
        "flash_attention": (lambda *a: fa.flash_attention_model(
            *a, window=16), [q] + kv, fa.counts),
        "ssd_scan": (lambda *a: ssd.ssd_scan(*a, chunk=16),
                     _ssd(2, 40, 2, 16, 8, torch.float32, "cpu"), ssd.counts),
    }


@pytest.mark.parametrize("name", ["inverse_cdf", "mask_apply", "blur2d",
                                  "flash_attention", "ssd_scan",
                                  "mask_apply@train", "blur2d@train"])
def test_gradients_on_the_card_equal_the_cpus(sm90_card, name):
    """The backward on the card against the CPU's for each wrapper, B2
    and B3 also at imaging training's shapes; the blur's backward
    launches the blur kernel once."""
    fn, inputs, cnt = _grad_cases(sm90_card)[name]
    w = torch.randn(fn(*inputs).shape, generator=torch.Generator()
                    .manual_seed(4))
    grads = {}
    for dev in ("cpu", sm90_card):
        xs = [t.detach().to(dev).requires_grad_() for t in inputs]
        cnt.reset()
        y = fn(*xs)
        assert y.grad_fn is not None
        (y * w.to(dev)).sum().backward()
        torch.cuda.synchronize()
        grads[str(dev)] = [x.grad.cpu() for x in xs]
        if dev != "cpu":
            assert (cnt.launches, cnt.plain_calls) == (1, 0)
            blur = name.startswith("blur2d")
            assert cnt.backward_launches == (1 if blur else 0)
            assert cnt.backward_plain == (0 if blur else 1)
    tol = dict(rtol=1e-4, atol=1e-4) if name == "ssd_scan" else FP32
    for a, b in zip(grads[str(sm90_card)], grads["cpu"]):
        torch.testing.assert_close(a, b, **tol)


def test_trainer_on_the_card_launches_b5_and_matches_the_cpu(sm90_card):
    """One step of the mamba2 smoke config in fp32: four B5 launches (two
    layers, forward and the remat recompute), no plain call, and the
    loss, gradient norm and new parameters of the CPU's step."""
    cfg = get_config("mamba2-130m", smoke=True).replace(dtype="float32")
    tcfg = T.TrainConfig(lr=1e-3, warmup=2, total_steps=10)
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    step, _ = T.make_train_step(cfg, tcfg)
    out = {}
    for dev in ("cpu", sm90_card):
        state = T.train_state_from_params(
            M.map_params(lambda t: t.to(dev), params), tcfg)
        ssd.counts.reset()
        new, met = step(state, {"tokens": tok.to(dev)})
        out[str(dev)] = (new, met)
    assert (ssd.counts.launches, ssd.counts.plain_calls) == \
        (2 * cfg.num_layers, 0)
    (nc, mc), (ng, mg) = out["cpu"], out[str(sm90_card)]
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(mg["gnorm"].cpu(), mc["gnorm"], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(M.leaves(ng["params"]), M.leaves(nc["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2.5e-4)


@pytest.mark.parametrize("arch,kernel", [("mamba2-130m", "ssd_scan"),
                                         ("granite-moe-3b-a800m",
                                          "flash_attention")])
def test_dots_step_on_the_card_equals_full(sm90_card, arch, kernel):
    """One train step of a bf16 smoke config on the card under
    remat_policy "dots" and under "full", from one state and one batch (a
    MoE's routing under "full" pinned to the choices of "dots"): B5 or B4
    launched twice a layer under both (the forward and the recompute),
    all on the wgmma route, no plain call; the loss, the gradient norm and
    the new parameters of "full"."""
    cfg = get_config(arch, smoke=True)
    tcfg = T.TrainConfig(lr=1e-3, warmup=2, total_steps=10)
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    cnt = {"ssd_scan": ssd.counts, "flash_attention": fa.counts}[kernel]
    seen, out = moe.Tap(record=True), {}
    for policy in ("dots", "full"):
        tap = seen if policy == "dots" else moe.Tap(
            choices=[i for _, i in seen.routes])
        state = T.train_state_from_params(
            M.map_params(lambda t: t.to(sm90_card), params), tcfg)
        step, _ = T.make_train_step(cfg.replace(remat_policy=policy), tcfg,
                                    tap=tap)
        cnt.reset()
        out[policy] = step(state, {"tokens": tok.to(sm90_card)})
        torch.cuda.synchronize()
        L = cfg.num_layers
        assert (cnt.launches, cnt.plain_calls) == (2 * L, 0)
        assert cnt.routes == {"fma": 0, "wgmma": 2 * L}
    (nd, md), (nf, mf) = out["dots"], out["full"]
    torch.testing.assert_close(md["loss"], mf["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(md["gnorm"], mf["gnorm"], rtol=1e-3, atol=0)
    for a, b in zip(M.leaves(nd["params"]), M.leaves(nf["params"])):
        torch.testing.assert_close(a, b, **BF16)


def test_llm_checkpoint_from_the_card_restores_bitwise(sm90_card, tmp_path):
    """A train state on the card after two steps (granite-moe-3b-a800m's
    smoke config under `rma_arar_grouped`, so a mailbox is in it) written
    by `save_checkpoint` and read back by `restore_checkpoint` into
    another state on the card: every leaf on the card, its dtype, every
    bit."""
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.data import TokenStream
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    tcfg = T.TrainConfig(lr=1e-3, warmup=2, total_steps=10,
                         sync_mode="rma_arar_grouped")
    trainer = T.Trainer(cfg, tcfg, seed=0, device=sm90_card)
    state = trainer.run(TokenStream(cfg, 2, 40, device=sm90_card), 2,
                        log=lambda s: None)
    save_checkpoint(str(tmp_path), 2, state)
    like = T.init_train_state(torch.Generator(device=sm90_card).manual_seed(1),
                              cfg, tcfg, sm90_card)
    back = restore_checkpoint(str(tmp_path), 2, like)
    assert "mailbox" in back and int(back["step"]) == 2
    for a, b in zip(M.leaves(back), M.leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# the GAN training path


def _gan_run(dev, mode, seed=0):
    """A smoke-size run (R 4 as 2 x 2, K 16, E 8, h 1) made on the CPU:
    config, state (a non-zero mailbox), per-rank data and one epoch's
    draws, each moved to `dev`."""
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.tree import tree_map
    wcfg = W.WorkflowConfig(sync=sync.SyncConfig(mode=mode, h=1),
                            n_param_samples=16, events_per_sample=8,
                            gen_lr=2e-4, disc_lr=5e-4)
    g = torch.Generator().manual_seed(seed)
    data = get_problem("proxy1d").make_reference_data(g, 2_000, device="cpu")
    state, per_rank = W.init_run(g, 4, wcfg, data, "cpu")
    state["sync"]["mailbox"] = tree_map(
        lambda t: torch.randn(t.shape, generator=g), state["sync"]["mailbox"])
    draws = W.make_draws(g, wcfg, 4, per_rank.shape[1])
    move = lambda tree: tree_map(lambda t: t.to(dev), tree)   # noqa: E731
    return wcfg, move(state), per_rank.to(dev), move(draws)


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
def test_gan_epoch_on_the_card_matches_the_cpu(sm90_card, mode):
    """One epoch from the same state and draws on both devices: the
    losses at rtol 1e-5, each generator gradient within 1e-3 in relative
    norm, the card's exchange bitwise the CPU's on the card's gradients,
    and the card's new generator and its Adam state against the CPU's
    optimizer applied to the card's synced gradients."""
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map
    out = {}
    for dev in ("cpu", sm90_card):
        wcfg, state, data, draws = _gan_run(dev, mode)
        part, grads, metrics = W.rank_grads(state, data, draws, wcfg)
        synced, new_sync = W.make_schedule(wcfg).exchange(
            VmapComm(2, 2), grads, part["sync"], part["epoch"][0])
        new = W.rank_apply(part, synced, new_sync, wcfg)
        out[str(dev)] = tree_map(lambda t: t.cpu(), (part, grads, metrics,
                                                     synced, new))
    (pc, gc, mc, sc, nc), (pg, gg, mg, sg, ng) = out["cpu"], \
        out[str(sm90_card)]
    for k in ("d_loss", "g_loss"):
        torch.testing.assert_close(mg[k], mc[k], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        assert float((a - b).norm() / b.norm()) < 1e-3
    wcfg = _gan_run("cpu", mode)[0]
    s2, ns2 = W.make_schedule(wcfg).exchange(VmapComm(2, 2), gg, pg["sync"],
                                             pg["epoch"][0])
    for a, b in zip(tree_leaves((s2, ns2)), tree_leaves((sg, ng["sync"]))):
        assert torch.equal(a, b)
    want = W.rank_apply(pg, sg, ns2, wcfg)
    for a, b in zip(tree_leaves((ng["gen"], ng["gen_opt"])),
                    tree_leaves((want["gen"], want["gen_opt"]))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["conv_arar", "arar_arar", "rma_arar_arar",
                                  "dbtree"])
def test_bf16_exchange_on_the_card_is_bitwise_the_cpus(sm90_card, mode):
    """`payload_precision="bf16"`: the same fp32 gradients (at the
    generator's widths, 2 x 4 ranks) exchanged by the schedule on the card
    and on the CPU over 3 epochs (h 2: the outer ring due on alternate
    ones, the mailbox carried): the synced gradients and the sync state
    bitwise equal, the mailbox's masked leaves bf16 on both.  Each
    combine is a bf16 add or scale, computed in fp32 and rounded on both
    devices."""
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    wcfg = W.WorkflowConfig(sync=sync.SyncConfig(
        mode=mode, h=2, payload_precision="bf16"))
    rng = np.random.default_rng(7)
    widths = gan.gen_widths()
    grads = [[{"w": rng.standard_normal((8, a, b)).astype(np.float32),
               "b": rng.standard_normal((8, b)).astype(np.float32)}
              for a, b in zip(widths[:-1], widths[1:])] for _ in range(3)]
    out = {}
    for dev in ("cpu", sm90_card):
        sched = W.make_schedule(wcfg)
        st = sched.init_state(8, dev)
        for e, g in enumerate(grads):
            synced, st = sched.exchange(
                VmapComm(2, 4), tree_map(lambda a: torch.from_numpy(a).to(
                    dev), g), st, torch.tensor(e, device=dev))
        out[str(dev)] = tree_map(lambda t: t.cpu(), (synced, st))
    for (k, a), b in zip(tree_paths(out[str(sm90_card)]),
                         tree_leaves(out["cpu"])):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    mb = out["cpu"][1]["mailbox"]
    assert [layer["w"].dtype for layer in mb] == [torch.bfloat16] * 4
    assert [layer["b"].dtype for layer in mb] == [torch.float32] * 4


def test_gan_training_launches_b1_once_an_epoch(sm90_card):
    """The fake events are computed once an epoch: B1 launches once and
    its backward runs once, and nothing takes the plain version."""
    from repro_torch.core import workflow as W
    wcfg, _, _, _ = _gan_run("cpu", "rma_arar_arar")
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device=sm90_card)
    counts.reset()
    state, hist = W.train_stacked(0, wcfg, 2, 2, 3, data, device=sm90_card)
    assert (counts.launches, counts.plain_calls, counts.backward_plain) == \
        (3, 0, 3)
    assert bool(torch.isfinite(hist["d_loss"]).all())
    assert state["gen"][0]["w"].device.type == "cuda"


def test_gan_cadence_trains_on_b1_as_due_counts_says(sm90_card):
    """`PAPER` at smoke size and disc_every 2, gen_every 3 for 6 epochs
    (every combination of the two halves): B1 launches on each epoch where a
    half runs and its backward on the generator's epochs
    (`workflow.due_counts`), nothing takes the plain version, the state
    is finite and the skipped halves' losses are NaN."""
    import dataclasses
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_paths
    wcfg = dataclasses.replace(PAPER, n_param_samples=16,
                               events_per_sample=8, disc_every=2,
                               gen_every=3)
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device=sm90_card)
    counts.reset()
    state, hist = W.train_stacked(0, wcfg, 2, 2, 6, data,
                                  checkpoint_every=1, device=sm90_card)
    torch.cuda.synchronize()
    n_half, n_gen = W.due_counts(wcfg, 6)
    assert (counts.launches, counts.plain_calls, counts.backward_plain) == \
        (n_half, 0, n_gen) == (4, 0, 2)
    for k, t in tree_paths(state):
        assert t.device.type == "cuda" and bool(
            torch.isfinite(t.float()).all()), k
    for key, i in (("d_loss", 0), ("g_loss", 1)):
        ran = torch.tensor([W.due(wcfg, e)[i] for e in range(6)])
        assert torch.equal(hist[key].isnan().all(1).cpu(), ~ran), key


def test_depth_k_exchange_and_training_on_the_card(sm90_card):
    """`staleness` k > 1: (1) the depth-3 exchange (2 x 4 ranks, h 2, 8
    epochs, at fp32 and bf16, whole and at 65,536 B) on the card is
    bitwise the CPU's on the same gradients, outputs and SyncState, the
    read of epoch e the deposit of e - 3; (2) `PAPER` at smoke size and
    k 2 trains with B1 at `due_counts`, no plain call, and a finite
    [R, 2, ...] state."""
    import dataclasses
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    rng = np.random.default_rng(5)
    widths = gan.gen_widths()
    grads = [[{"w": rng.standard_normal((8, a, b)).astype(np.float32),
               "b": rng.standard_normal((8, b)).astype(np.float32)}
              for a, b in zip(widths[:-1], widths[1:])] for _ in range(8)]
    for prec in ("fp32", "bf16"):
        for chunk in (0, 65_536):
            wcfg = W.WorkflowConfig(sync=sync.SyncConfig(
                mode="rma_arar_arar", h=2, staleness=3,
                payload_precision=prec, ring_chunking=chunk))
            out = {}
            for dev in ("cpu", sm90_card):
                sched = W.make_schedule(wcfg)
                st, runs = sched.init_state(8, dev), []
                for e, g in enumerate(grads):
                    synced, st = sched.exchange(
                        VmapComm(2, 4), tree_map(lambda a: torch.from_numpy(
                            a).to(dev), g), st,
                        torch.tensor(e, dtype=torch.int32, device=dev))
                    runs.append(tree_map(lambda t: t.cpu(), (synced, st)))
                out[str(dev)] = runs
            for e, (got, want) in enumerate(zip(out[str(sm90_card)],
                                                out["cpu"])):
                for (k, a), b in zip(tree_paths(got), tree_leaves(want)):
                    assert a.dtype == b.dtype and torch.equal(a, b), \
                        (prec, chunk, e, k)
                # slot e % 3 holds epoch e's deposit: the ring-shifted
                # gradient, in the payload's dtype
                dep = got[1]["mailbox"][0]["w"][:, e % 3]
                ring = torch.from_numpy(grads[e][0]["w"]).reshape(
                    2, 4, *dep.shape[1:]).roll(1, 1).reshape(dep.shape)
                assert torch.equal(dep, ring.to(dep.dtype)), (prec, e)
    wcfg = dataclasses.replace(
        PAPER, n_param_samples=16, events_per_sample=8,
        sync=dataclasses.replace(PAPER.sync, staleness=2))
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device=sm90_card)
    counts.reset()
    state, hist = W.train_stacked(0, wcfg, 2, 2, 5, data, device=sm90_card)
    torch.cuda.synchronize()
    n_half, n_gen = W.due_counts(wcfg, 5)
    assert (counts.launches, counts.plain_calls, counts.backward_plain) == \
        (n_half, 0, n_gen) == (5, 0, 5)
    assert state["sync"]["mailbox"][0]["w"].shape[:2] == (4, 2)
    for k, t in tree_paths(state):
        assert t.device.type == "cuda" and bool(
            torch.isfinite(t.float()).all()), k
    assert bool(torch.isfinite(hist["d_loss"]).all())


@pytest.mark.parametrize("k", [1, 2])
def test_overlap_exchange_on_the_card_is_bitwise_the_cpus(sm90_card, k):
    """The overlapped pod boundary at h 2 (2 x 4 ranks, 6 epochs: ships
    at 1, 3, 5, due combines at 0, 2, 4), at depth k, fp32 and bf16,
    whole and at 65,536 B: outputs and SyncState bitwise the CPU's on the
    same gradients; the outer mailbox changes on the ship epochs only."""
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    rng = np.random.default_rng(7)
    widths = gan.gen_widths()
    grads = [[{"w": rng.standard_normal((8, a, b)).astype(np.float32),
               "b": rng.standard_normal((8, b)).astype(np.float32)}
              for a, b in zip(widths[:-1], widths[1:])] for _ in range(6)]
    for prec in ("fp32", "bf16"):
        for chunk in (0, 65_536):
            wcfg = W.WorkflowConfig(sync=sync.SyncConfig(
                mode="rma_arar_arar", h=2, staleness=k, overlap=True,
                payload_precision=prec, ring_chunking=chunk))
            out = {}
            for dev in ("cpu", sm90_card):
                sched = W.make_schedule(wcfg)
                st, runs = sched.init_state(8, dev), []
                for e, g in enumerate(grads):
                    synced, st = sched.exchange(
                        VmapComm(2, 4), tree_map(lambda a: torch.from_numpy(
                            a).to(dev), g), st,
                        torch.tensor(e, dtype=torch.int32, device=dev))
                    runs.append(tree_map(lambda t: t.cpu(), (synced, st)))
                out[str(dev)] = runs
            before = torch.zeros_like(out["cpu"][0][1]["outer_mailbox"])
            for e, (got, want) in enumerate(zip(out[str(sm90_card)],
                                                out["cpu"])):
                for (key, a), b in zip(tree_paths(got), tree_leaves(want)):
                    assert a.dtype == b.dtype and torch.equal(a, b), \
                        (prec, chunk, e, key)
                omb = got[1]["outer_mailbox"]
                assert omb.dtype == sync.payload_dtype_of(prec)
                assert torch.equal(omb, before) == (e % 2 == 0), (prec, e)
                before = omb


ADAPTIVE_CARD = [(ov, p, c) for ov in (False, True)
                 for p, c in (("fp32", 0), ("fp32", 65_536), ("bf16", 0))]


@pytest.mark.parametrize("overlap,prec,chunk", ADAPTIVE_CARD,
                         ids=[f"{'overlap' if ov else 'sync'}-{p}-{c}"
                              for ov, p, c in ADAPTIVE_CARD])
def test_adaptive_exchange_with_driven_skew_is_bitwise_the_cpus(
        sm90_card, overlap, prec, chunk):
    """Adaptive staleness at k_max 3, h 4 (2 x 4 ranks, 20 epochs), with
    skew driven in through tags set 3-5 epochs old before epochs 4-6:
    the outputs, the SyncState (payload, tags, controller) and the obs
    rows on the card are bitwise the CPU's on the same gradients; k_eff
    widens to 3 and narrows back to 1, and under overlap the stretched
    gate ships once in each cycle of 4."""
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    rng = np.random.default_rng(11)
    widths = gan.gen_widths()
    grads = [[{"w": rng.standard_normal((8, a, b)).astype(np.float32),
               "b": rng.standard_normal((8, b)).astype(np.float32)}
              for a, b in zip(widths[:-1], widths[1:])] for _ in range(20)]
    drive = {4: 3, 5: 4, 6: 5}
    wcfg = W.WorkflowConfig(sync=sync.SyncConfig(
        mode="rma_arar_arar", h=4, staleness=3, adaptive=True,
        overlap=overlap, payload_precision=prec, ring_chunking=chunk))
    out = {}
    for dev in ("cpu", sm90_card):
        sched = W.make_schedule(wcfg)
        st, runs = sched.init_state(8, dev), []
        for e, g in enumerate(grads):
            if e in drive:
                tags = st["mailbox"]["tag"]
                st["mailbox"]["tag"] = torch.where(tags >= 0,
                                                   tags - drive[e], tags)
            synced, st, row = sched.exchange_with_obs(
                VmapComm(2, 4), tree_map(lambda a: torch.from_numpy(
                    a).to(dev), g), st,
                torch.tensor(e, dtype=torch.int32, device=dev))
            runs.append(tree_map(lambda t: t.cpu(), (synced, st, row)))
        out[str(dev)] = runs
    for e, (got, want) in enumerate(zip(out[str(sm90_card)], out["cpu"])):
        for (key, a), b in zip(tree_paths(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (e, key)
    ks = [int(r[2]["k_eff"][0]) for r in out["cpu"]]
    ships = [int(r[2]["shipped"][0]) for r in out["cpu"]]
    assert max(ks) == 3 and ks[-1] == 1
    assert [sum(ships[c:c + 4]) for c in range(0, 20, 4)] == \
        ([1] * 5 if overlap else [0] * 5)


@pytest.mark.parametrize("name", ["proxy2d", "linear_blur", "imaging",
                                  "imaging_blur"])
def test_every_problem_trains_on_its_kernels(sm90_card, name):
    """3 epochs of each problem at smoke sizes: the forward model's
    kernels launch once an epoch and nothing takes a plain version; B1's
    backward once an epoch for the flat problems (none for the imaging
    readout's noise, whose parameters are constants), B2's backward in
    PyTorch and B3's as one B3 launch."""
    import dataclasses
    from repro_torch.configs.sagips_gan import REDUCED, for_problem
    from repro_torch.core import workflow as W
    wcfg = dataclasses.replace(for_problem(name, REDUCED),
                               n_param_samples=8, events_per_sample=16)
    data = get_problem(name).make_reference_data(
        torch.Generator().manual_seed(99), 1_000, device=sm90_card)
    for c in (counts, mask_counts, blur_counts):
        c.reset()
    state, hist = W.train_stacked(0, wcfg, 2, 2, 3, data, device=sm90_card)
    torch.cuda.synchronize()
    image = name.startswith("imaging")
    assert (counts.launches, counts.plain_calls, counts.backward_plain) == \
        (3, 0, 0 if image else 3)
    assert (mask_counts.launches, mask_counts.plain_calls,
            mask_counts.backward_plain) == \
        ((3, 0, 3) if name == "imaging" else (0, 0, 0))
    assert (blur_counts.launches, blur_counts.plain_calls,
            blur_counts.backward_launches) == \
        ((3, 0, 3) if name == "imaging_blur" else (0, 0, 0))
    assert bool(torch.isfinite(hist["d_loss"]).all())


def test_conv_generator_backward_is_fp32(sm90_card):
    """With cuDNN's TF32 on for the process, the conv generator's
    gradients on the card stay within 1e-5 in relative norm of a float64
    CPU reference (TF32 keeps ~3 digits, ~1e-3): the backward's convs run
    in full fp32, like the forward's, and the flag is unchanged after."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import convgen
    g = torch.Generator().manual_seed(4)
    gen = convgen.init_conv_generator(g, (32, 32), gan.NOISE_DIM, ranks=2,
                                      device="cpu")
    noise = torch.randn((2, 16, gan.NOISE_DIM), generator=g)
    cot = torch.randn((2, 16, 1024), generator=g)
    grads = {}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev, dt in ((sm90_card, torch.float32), ("cpu", torch.float64)):
            p = tree_map(lambda t: t.to(dev, dt).requires_grad_(), gen)
            out = convgen.conv_generator_apply(p, noise.to(dev, dt))
            grads[str(dev)] = torch.autograd.grad(out, tree_leaves(p),
                                                  cot.to(dev, dt))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    for a, b in zip(grads[str(sm90_card)], grads["cpu"]):
        a = a.double().cpu()
        assert float((a - b).norm() / b.norm()) < 1e-5


def test_gan_step_with_cpu_uniforms_raises_on_the_card(sm90_card):
    """A CUDA state whose sampler uniforms lie on the CPU reaches the
    sampler with CUDA parameters: it raises instead of taking the plain
    route, and nothing is counted."""
    from repro_torch.core import workflow as W
    wcfg, state, data, draws = _gan_run(sm90_card, "conv_arar")
    draws = dict(draws, u=draws["u"].cpu())
    counts.reset()
    with pytest.raises(ValueError, match="is on cuda"):
        W.rank_grads(state, data, draws, wcfg)
    assert (counts.launches, counts.plain_calls) == (0, 0)


# ----------------------------------------------------------------------------
# the proc runtime


def test_proc_runtime_on_the_card_is_bitwise_its_reference(sm90_card):
    """2 worker processes on the card, lock-step, 3 epochs: the stacked
    final state is bitwise the per-rank reference computed in this
    process on the card, and B1 launched once an epoch in each worker,
    forward and backward, with no plain call."""
    from repro_torch.core import sync, workflow as W
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.runtime.launch import lockstep_reference, run_proc
    wcfg = W.WorkflowConfig(sync=sync.SyncConfig(mode="rma_arar_arar", h=2),
                            n_param_samples=16, events_per_sample=8,
                            gen_lr=2e-4, disc_lr=5e-4)
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device=sm90_card)
    out = run_proc(wcfg, 1, 2, 3, data, seed=0, device=sm90_card,
                   timeout=600)
    ref = lockstep_reference(0, wcfg, 1, 2, 3, data, device=sm90_card)
    for (k, a), b in zip(tree_paths(out["state"]), tree_leaves(ref)):
        assert a.device.type == "cuda" and torch.equal(a, b), k
    assert out["counts"]["inverse_cdf"] == (6, 0, 0, 6)
    assert [s["device"] for s in out["summaries"]] == \
        [torch.cuda.get_device_name(0)] * 2


def test_obs_rows_on_the_card_equal_the_cpus(sm90_card, tmp_path):
    """The metrics channel (`ObsConfig(metrics=True, metrics_out=...)`):
    6 epochs of `PAPER` at smoke size, k 2, disc_every 2, gen_every 3, on
    the card and on the CPU from one seed: the history's obs tree and the
    metrics file's header and obs fields are equal, and on the card B1
    runs at `due_counts`, no plain call."""
    import dataclasses
    import json
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.obs import ObsConfig
    fields = ("epoch", "k_eff", "shipped", "ship_count", "exchange_count",
              "skew_ema", "deposit_age")
    hists, rows = {}, {}
    for dev in ("cpu", sm90_card):
        out = str(tmp_path / f"{torch.device(dev).type}.jsonl")
        wcfg = dataclasses.replace(
            PAPER, n_param_samples=16, events_per_sample=8, disc_every=2,
            gen_every=3, sync=dataclasses.replace(PAPER.sync, staleness=2),
            obs=ObsConfig(metrics=True, metrics_out=out))
        data = get_problem("proxy1d").make_reference_data(
            torch.Generator().manual_seed(99), 2_000, device=dev)
        counts.reset()
        _, hist = W.train_stacked(0, wcfg, 2, 2, 6, data, checkpoint_every=1,
                                  chunk=2, device=dev)
        hists[str(dev)] = {k: v.cpu() for k, v in hist["obs"].items()}
        with open(out) as f:
            lines = [json.loads(line) for line in f]
        rows[str(dev)] = [lines[0]] + [{k: r[k] for k in fields}
                                       for r in lines[1:]]
    torch.cuda.synchronize()
    n_half, n_gen = W.due_counts(wcfg, 6)
    assert (counts.launches, counts.plain_calls, counts.backward_plain) == \
        (n_half, 0, n_gen) == (4, 0, 2)
    card, cpu = hists[str(sm90_card)], hists["cpu"]
    assert list(card) == list(cpu)
    for k in cpu:
        assert card[k].dtype == cpu[k].dtype and torch.equal(card[k],
                                                             cpu[k]), k
    assert card["exchange_count"][:, 0].tolist() == [1, 1, 1, 2, 2, 2]
    assert rows[str(sm90_card)] == rows["cpu"]
    assert rows["cpu"][0]["payload_bytes"] == 203_264 and \
        [r["k_eff"] for r in rows["cpu"][1:]] == [2, 2, 2]
