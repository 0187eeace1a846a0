"""The port's LLM training path against the JAX package, on the CPU.

The same numpy inputs from a seed go through `repro` and `repro_torch`
(JAX's Pallas kernels in interpret mode, as its own tests run them):

  kernel B5       the plain SSD scan and the wrapper's CPU route against
                  `repro.kernels.ssd_scan.ssd_scan` and `ref.ssd_scan_ref`
                  on tests/test_kernels.py's sweep plus ragged S (rtol/atol
                  1e-3, the sweep's tolerance), chunk invariance at 1e-4,
                  the chunked form against the sequential one, causality
  gradients       of B1-B5 against `jax.grad` through the `custom_vjp`s of
                  `repro.kernels.ops`, fp32 rtol 1e-4 / atol 1e-5; B5 at
                  rtol/atol 1e-4 (the JAX package differentiates the
                  sequential recurrence, the port the chunked form: the
                  same function, summed in another order); every wrapper's
                  output has a grad_fn
  data, optim     `make_batch`/`TokenStream` bitwise; adam, adamw, sgd and
                  the schedules over 3 steps at fp32 rtol 1e-6
  train step      one `make_train_step` step of mamba2-smoke ("chunked"
                  and "pallas") and of tinyllama-smoke from one
                  JAX-initialised fp32 state and one batch: loss and every
                  gradient leaf at rtol 1e-4 / atol 1e-5, the new
                  parameters at atol lr_t / 4 (see `test_train_step_new_
                  params_match_jax`); the bf16 step in relative norm,
                  against the JAX package's own bf16 error
  serving         SSM prefill and decode logits and caches against
                  `repro.models.model.prefill`/`decode_step`
  CLI, configs    `python -m repro_torch.launch.train`, the mamba2-130m
                  config and its full size on the meta device

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and `chip_smoke.py`.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.data import TokenStream as JaxTokenStream
from repro.data import make_batch as jax_make_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import model as JM
from repro.models import ssm as jax_ssm
from repro.optim import optimizers as jax_opt
from repro.optim import schedules as jax_sched
from repro.training import trainer as JT

from repro_torch.checkpoint.store import lm_params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenStream, make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import imaging, inverse_cdf as icdf
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules
from repro_torch.serving import make_serve_step
from repro_torch.training import trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=1e-4, atol=1e-5)
SWEEP = dict(rtol=1e-3, atol=1e-3)      # tests/test_kernels.py's SSD sweep


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _ssd_inputs(B, S, H, P, N, seed=0):
    """x, dt (softplus of a normal), A (negative), Bc, Cc as fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
    A = -np.exp(rng.standard_normal(H))
    Bc = rng.standard_normal((B, S, N))
    Cc = rng.standard_normal((B, S, N))
    return [np.asarray(a, np.float32) for a in (x, dt, A, Bc, Cc)]


# ----------------------------------------------------------------------------
# kernel B5: the plain version and the wrapper's CPU route


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 3, 32, 16, 32), (1, 100, 2, 64, 128, 64),
    (1, 64, 1, 16, 8, 16), (2, 96, 4, 32, 32, 48),
    (1, 37, 2, 16, 8, 16), (2, 1, 2, 8, 4, 16),
])
def test_ssd_scan_matches_pallas_and_oracle(B, S, H, P, N, chunk):
    arrays = _ssd_inputs(B, S, H, P, N, seed=S + N)
    want = jax_ssd_scan(*arrays, chunk=chunk, interpret=True)
    oracle = jax_ref.ssd_scan_ref(*map(jnp.asarray, arrays))
    ssd.counts.reset()
    got = ssd.ssd_scan(*_t(*arrays), chunk=chunk)
    assert ssd.counts.plain_calls == 1 and ssd.counts.launches == 0
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **SWEEP)
    np.testing.assert_allclose(got.numpy(), _np(oracle), **SWEEP)
    np.testing.assert_allclose(ssd_scan_ref(*_t(*arrays)).numpy(),
                               _np(oracle), **SWEEP)


def test_ssd_scan_bf16_matches_pallas():
    arrays = _ssd_inputs(1, 48, 2, 32, 16, seed=5)
    x, dt, A, Bc, Cc = arrays
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bc, Cc)]
    want = jax_ssd_scan(bf[0], dt, A, bf[1], bf[2], chunk=16, interpret=True)
    tx, tdt, tA, tB, tC = _t(*arrays)
    got = ssd.ssd_scan(tx.bfloat16(), tdt, tA, tB.bfloat16(), tC.bfloat16(),
                       chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=2e-2, atol=2e-2 * float(np.abs(
                                   _np(want)).max()))


def test_ssd_chunk_and_tile_invariance():
    """As tests/test_kernels.py::test_ssd_chunk_invariance (chunks 16-128
    within 1e-4), plus a ragged S; the tile only matters on the card."""
    arrays = _t(*_ssd_inputs(1, 120, 2, 16, 8, seed=3))
    outs = [ssd.ssd_scan(*arrays, chunk=c, tile=tile)
            for c in (16, 32, 64, 128) for tile in ssd.TILES]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("S,Q", [(32, 8), (48, 16), (64, 16), (40, 16)])
def test_ssd_chunked_matches_sequential(S, Q):
    arrays = _t(*_ssd_inputs(2, S, 3, 8, 4, seed=S + Q))
    y, state = ssm.ssd_chunked_with_state(*arrays, Q)
    np.testing.assert_allclose(y.numpy(), ssm.ssd_sequential(*arrays).numpy(),
                               **SWEEP)
    np.testing.assert_allclose(ssm.ssd_chunked(*arrays, Q).numpy(),
                               y.numpy())
    # the final state against the JAX package's
    _, jstate = jax_ssm.ssd_chunked_with_state(
        *map(jnp.asarray, (a.numpy() for a in arrays)), Q)
    np.testing.assert_allclose(state.numpy(), _np(jstate), **FP32)


def test_ssd_causality():
    """Perturbing token t changes no output before t (tests/test_models)."""
    x, dt, A, Bc, Cc = _t(*_ssd_inputs(1, 32, 2, 8, 4, seed=0))
    y = ssd.ssd_scan(x, dt, A, Bc, Cc, chunk=8)
    x2 = x.clone()
    x2[:, 20] += 10.0
    y2 = ssd.ssd_scan(x2, dt, A, Bc, Cc, chunk=8)
    np.testing.assert_allclose(y[:, :20].numpy(), y2[:, :20].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float((y[:, 20:] - y2[:, 20:]).abs().max()) > 1e-3


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bc, Cc = _t(*_ssd_inputs(1, 16, 2, 8, 4))
    ssd.counts.reset()
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bc, Cc)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.double(), A, Bc, Cc)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, A, Bc.bfloat16(), Cc)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.half(), dt, A, Bc.half(), Cc.half())
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt[:, :8], A, Bc, Cc)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bc, Cc[..., :3])
    with pytest.raises(ValueError, match="tile"):
        ssd.ssd_scan(x, dt, A, Bc, Cc, tile=48)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, A, Bc, Cc, chunk=0)
    meta = [t.to("meta") for t in (x, dt, A, Bc, Cc)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd.ssd_scan(*meta)
    assert (ssd.counts.launches, ssd.counts.plain_calls) == (0, 0)


# ----------------------------------------------------------------------------
# gradients of B1-B5 against the JAX custom_vjps


def _icdf_case(rng):
    K, E, C = 5, 7, 2
    u = rng.uniform(size=(K, E, C))
    u[0, :3, 0] = (0.0, 1.0, 1e-8)            # the clip's edges
    mu, s, k = (rng.uniform(lo, hi, (K, C)) for lo, hi in
                ((-2, 2), (0.05, 1), (-1, 1)))
    return (u, mu, s, k), icdf.inverse_cdf_channels, \
        lambda *a: jax_ops.inverse_cdf_channels(*a)


def _icdf_2d_case(rng):
    u = rng.uniform(size=(6, 9))
    mu, s, k = (rng.uniform(lo, hi, 6) for lo, hi in
                ((-2, 2), (0.05, 1), (-1, 1)))
    return (u, mu, s, k), icdf.inverse_cdf, \
        lambda *a: jax_ops.inverse_cdf(*a)


def _mask_case(rng):
    x = rng.standard_normal((6, 40))
    m = (rng.uniform(size=40) > 0.4).astype(np.float64)
    return (x, m), imaging.mask_apply, lambda *a: jax_ops.mask_apply(*a)


def _blur_case(rng):
    return (rng.standard_normal((3, 8, 12)),), imaging.blur2d, \
        lambda *a: jax_ops.blur2d(*a)


def _flash_case(rng):
    B, S, KV, G, hd = 2, 40, 2, 2, 32
    q = rng.standard_normal((B, S, KV, G, hd))
    k, v = (rng.standard_normal((B, S, KV, hd)) for _ in range(2))
    return (q, k, v), lambda *a: fa.flash_attention_model(*a, window=16), \
        lambda *a: jax_ops.flash_attention(*a, True, 16)


def _ssd_case(rng):
    arrays = _ssd_inputs(2, 40, 2, 16, 8, seed=int(rng.integers(100)))
    return arrays, lambda *a: ssd.ssd_scan(*a, chunk=16), \
        lambda *a: jax_ops.ssd_scan(*a, 16)


GRAD_CASES = {"inverse_cdf_channels": (_icdf_case, icdf.counts, FP32),
              "inverse_cdf": (_icdf_2d_case, icdf.counts, FP32),
              "mask_apply": (_mask_case, imaging.mask_counts, FP32),
              "blur2d": (_blur_case, imaging.blur_counts, FP32),
              "flash_attention": (_flash_case, fa.counts, FP32),
              "ssd_scan": (_ssd_case, ssd.counts, dict(rtol=1e-4,
                                                       atol=1e-4))}


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_kernel_gradients_match_jax_custom_vjp(name):
    make, counts, tol = GRAD_CASES[name]
    rng = np.random.default_rng(7)
    arrays, port_fn, jax_fn = make(rng)
    arrays = [np.asarray(a, np.float32) for a in arrays]
    out_shape = np.shape(jax_fn(*map(jnp.asarray, arrays)))
    w = rng.standard_normal(out_shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w),
                    argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    xs = [t.requires_grad_() for t in _t(*arrays)]
    counts.reset()
    y = port_fn(*xs)
    assert y.grad_fn is not None
    (y * torch.from_numpy(w)).sum().backward()
    assert counts.plain_calls == 1 and counts.backward_plain == 1
    assert counts.launches == counts.backward_launches == 0
    for x, g in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), _np(g), **tol)


def test_every_wrapper_output_has_a_grad_fn():
    """Only when an input requires grad; the blur's backward is the blur."""
    rng = np.random.default_rng(0)
    for name, (make, _, _) in GRAD_CASES.items():
        arrays, port_fn, _ = make(rng)
        plain = _t(*arrays)
        assert port_fn(*plain).grad_fn is None, name
        xs = _t(*arrays)
        xs[0].requires_grad_()
        assert port_fn(*xs).grad_fn is not None, name
    x = torch.randn(2, 6, 6, requires_grad=True)
    g = torch.randn(2, 6, 6)
    imaging.blur2d(x).backward(g)
    torch.testing.assert_close(x.grad, imaging.blur2d(g))


# ----------------------------------------------------------------------------
# data and optimizers


def test_make_batch_and_token_stream_are_bitwise_jax():
    cfg = get_config("mamba2-130m", smoke=True)
    jcfg = jax_get_config("mamba2-130m", smoke=True)
    got = make_batch(cfg, 3, 17, seed=5, device="cpu")["tokens"]
    want = np.asarray(jax_make_batch(jcfg, 3, 17, seed=5)["tokens"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ours = TokenStream(cfg, 2, 9, seed=3, shard_index=1, num_shards=2,
                       device="cpu")
    theirs = JaxTokenStream(jcfg, 2, 9, seed=3, shard_index=1, num_shards=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours)["tokens"].numpy(),
                                      np.asarray(next(theirs)["tokens"]))
    # the same config as a vlm: its image-plus-prompt batch, bitwise too
    got = make_batch(cfg.replace(family="vlm"), 3, 17, seed=5, device="cpu")
    want = jax_make_batch(jcfg.replace(family="vlm"), 3, 17, seed=5)
    assert set(got) == set(want) == {"tokens", "vision"}
    assert got["vision"].shape == (3, 8, 1024)
    assert got["vision"].dtype == torch.bfloat16          # cfg.dtype
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["vision"].view(torch.int16).numpy(),
                                  np.asarray(want["vision"]).view(np.int16))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_momentum"])
def test_optimizer_three_steps_match_jax(name):
    """Schedule, moments, deltas and parameters after each of 3 steps of
    clipped gradients, fp32 (bf16 parameters for adamw)."""
    rng = np.random.default_rng(1)
    sched_j = jax_sched.linear_warmup_cosine(1e-2, 2, 5)
    sched_t = schedules.linear_warmup_cosine(1e-2, 2, 5)
    make = {"adam": (jax_opt.adam, opt.adam, {}),
            "adamw": (jax_opt.adamw, opt.adamw, {"weight_decay": 0.1}),
            "sgd": (jax_opt.sgd, opt.sgd, {}),
            "sgd_momentum": (jax_opt.sgd, opt.sgd, {"momentum": 0.9})}[name]
    oj, ot = make[0](sched_j, **make[2]), make[1](sched_t, **make[2])
    dtype = jnp.bfloat16 if name == "adamw" else jnp.float32
    pj = {"a": jnp.asarray(rng.standard_normal((4, 3)), dtype),
          "b": {"c": jnp.asarray(rng.standard_normal(5), jnp.float32)}}
    pt = {"a": torch.from_numpy(np.array(_np(pj["a"]))).to(
        torch.bfloat16 if name == "adamw" else torch.float32),
          "b": {"c": torch.from_numpy(np.array(_np(pj["b"]["c"])))}}
    sj, st = oj.init(pj), ot.init(pt)
    for i in range(3):
        g = {"a": rng.standard_normal((4, 3)) * 3,
             "b": {"c": rng.standard_normal(5) * 1e-3}}
        gj = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, pj)
        gt = {"a": torch.from_numpy(g["a"].astype(np.float32)).to(
            pt["a"].dtype), "b": {"c": torch.from_numpy(
                g["b"]["c"].astype(np.float32))}}
        gj, nj = jax_opt.clip_by_global_norm(gj, 1.0)
        gt, nt = opt.clip_by_global_norm(gt, 1.0)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        uj, sj = oj.update(gj, sj, pj)
        ut, st = ot.update(gt, st, pt)
        pj, pt = jax_opt.apply_updates(pj, uj), opt.apply_updates(pt, ut)
        np.testing.assert_allclose(
            float(sched_t(st["step"])), float(sched_j(sj["step"])),
            rtol=1e-6)
        assert int(st["step"]) == int(sj["step"]) == i + 1
        for key in ("mu", "nu", "mom"):
            if key in sj:
                np.testing.assert_allclose(st[key]["a"].numpy(),
                                           _np(sj[key]["a"]), rtol=1e-6)
        for a, b in ((pt["a"], pj["a"]), (pt["b"]["c"], pj["b"]["c"])):
            assert str(a.dtype)[6:] == str(b.dtype)
            np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 11, 50, 60])
def test_schedules_match_jax(step):
    s = torch.tensor(step, dtype=torch.int32)
    js = jnp.asarray(step, jnp.int32)
    for ours, theirs in (
            (schedules.linear_warmup_cosine(3e-4, 11, 50),
             jax_sched.linear_warmup_cosine(3e-4, 11, 50)),
            (schedules.cosine_decay(1.0, 40, 0.1),
             jax_sched.cosine_decay(1.0, 40, 0.1)),
            (schedules.constant(0.5), jax_sched.constant(0.5))):
        np.testing.assert_allclose(float(ours(s)), float(theirs(js)),
                                   rtol=1e-6, atol=1e-12)


# ----------------------------------------------------------------------------
# one training step against the JAX package


LR, WARMUP = 1e-3, 2


@functools.lru_cache(maxsize=None)
def _step_case(arch, impl, dtype="float32"):
    """One JAX-initialised state and one batch through both packages:
    {"jax"|"port": (loss, grads, new params, gnorm)} as numpy trees."""
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=dtype,
                                                    attn_impl=impl)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jt = JT.TrainConfig(lr=LR, warmup=WARMUP, total_steps=10)
    tt = T.TrainConfig(**dataclasses.asdict(jt))
    jstate = JT.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    tree = jax.tree.map(np.asarray, jstate["params"])
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jstep, _ = JT.make_train_step(jcfg, jt, donate=False)
    jnew, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
    # the JAX step's gradient, read back from its first Adam moment:
    # mu = (1 - b1) · g · min(1, clip / |g|) after one step
    scale = min(1.0, jt.grad_clip / float(jmet["gnorm"]))
    jl = jmet["loss"]
    jg = jax.tree.map(lambda m: m / (1 - 0.9) / scale, jnew["opt"]["mu"])
    params = lm_params_from_numpy(tree, "cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    ssd.counts.reset()
    fa.counts.reset()
    tl, _, tg = T._compute_grads(params, batch, cfg, tt)
    tstep, shardings = T.make_train_step(cfg, tt, donate=False)
    tnew, tmet = tstep(T.train_state_from_params(params, tt), batch)
    assert shardings is None and int(tnew["step"]) == 1
    assert torch.equal(tmet["loss"], tl)
    kernel = ssd.counts if cfg.family == "ssm" else fa.counts
    # two forwards per layer with remat (the step, the recompute), twice
    assert kernel.plain_calls == 2 * 2 * cfg.num_layers
    assert kernel.backward_plain == 2 * cfg.num_layers

    def tonp(t):
        return M.map_params(lambda x: x.float().numpy(), t)
    return {"jax": (float(jl), jax.tree.map(_np, jg),
                    jax.tree.map(_np, jnew["params"]), float(jmet["gnorm"])),
            "port": (float(tl), tonp(tg), tonp(tnew["params"]),
                     float(tmet["gnorm"]))}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


STEP_CASES = [("mamba2-130m", "chunked"), ("mamba2-130m", "pallas"),
              ("tinyllama-1.1b", "pallas"), ("qwen2-moe-a2.7b", "pallas"),
              ("granite-moe-3b-a800m", "pallas")]


@pytest.mark.parametrize("arch,impl", STEP_CASES)
def test_train_step_loss_and_gradients_match_jax(arch, impl):
    got, want = _step_case(arch, impl)["port"], _step_case(arch, impl)["jax"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    g, w = _flat(got[1]), _flat(want[1])
    assert set(g) == set(w)
    for key in w:
        np.testing.assert_allclose(g[key], w[key], err_msg=key, **FP32)


@pytest.mark.parametrize("arch,impl", STEP_CASES)
def test_train_step_new_params_match_jax(arch, impl):
    """Adam's first step moves a parameter by lr_t·g/(|g| + eps): where
    |g| is near eps (1e-8) the fp32 rounding of g moves that by up to
    lr_t.  So the new parameters are held at atol lr_t / 4 entry by entry,
    and 99.9% of them within 1e-6."""
    lr_t = LR / WARMUP
    got, want = _flat(_step_case(arch, impl)["port"][2]), \
        _flat(_step_case(arch, impl)["jax"][2])
    assert set(got) == set(want)
    far = total = 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=lr_t / 4, err_msg=key)
        far += int((np.abs(got[key] - want[key]) > 1e-6).sum())
        total += want[key].size
    assert far <= 1e-3 * total, (far, total)


def test_train_step_bf16_within_relative_norm():
    """bf16: the packages round at other places (ROADMAP queue C item 3),
    so the loss is held at rtol 2e-2 and each gradient leaf in relative
    norm: the port's bf16 gradient is at most twice as far from the JAX
    package's bf16 gradient as that is from the JAX fp32 gradient (bf16
    rounding alone moves the leaves by 1-4% here)."""
    case = _step_case("mamba2-130m", "chunked", "bfloat16")
    (tl, tg, _, _), (jl, jg, _, _) = case["port"], case["jax"]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    g, w = _flat(tg), _flat(jg)
    w32 = _flat(_step_case("mamba2-130m", "chunked")["jax"][1])

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    for key in w:
        assert rel(g[key], w[key]) <= 2 * rel(w[key], w32[key]), key


@pytest.mark.parametrize("arch,optimizer,clip", [
    ("granite-moe-3b-a800m", "adamw", 1.0), ("mamba2-130m", "adam", 0.0),
    ("tinyllama-1.1b", "sgd", 1.0)])
def test_leaf_by_leaf_step_is_the_whole_tree_update(arch, optimizer, clip):
    """Two steps with weight decay: the step's leaf-by-leaf update is
    bitwise the optimizer applied to the whole tree at once (clip by the
    global norm, `update`, `apply_updates`); the donating step (the
    Trainer's) writes the state it is given, the other leaves it as it
    was."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32", num_layers=1)
    tc = T.TrainConfig(lr=1e-3, warmup=2, total_steps=10, weight_decay=0.1,
                       optimizer=optimizer, grad_clip=clip)
    p0 = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batches = [make_batch(cfg, 2, 16, seed=i, device="cpu") for i in range(2)]
    want = T.train_state_from_params(M.map_params(torch.clone, p0), tc)
    optimizer_ = T._make_optimizer(tc)
    for batch in batches:
        _, _, grads = T._compute_grads(want["params"], batch, cfg, tc)
        if clip:
            grads, _ = opt.clip_by_global_norm(grads, clip)
        upd, new_opt = optimizer_.update(grads, want["opt"], want["params"])
        want = dict(want, params=opt.apply_updates(want["params"], upd),
                    opt=new_opt, step=want["step"] + 1)
    for donate in (False, True):
        state = T.train_state_from_params(M.map_params(torch.clone, p0), tc)
        step, _ = T.make_train_step(cfg, tc, donate=donate)
        for batch in batches:
            kept = M.map_params(torch.clone, state)
            new, met = step(state, batch)
            assert (new is state) == donate
            if not donate:       # the state it was given is as it was
                assert all(torch.equal(a, b) for a, b in
                           zip(M.leaves(state), M.leaves(kept)))
            state = new
        assert int(state["step"]) == 2
        assert all(torch.equal(a, b)
                   for a, b in zip(M.leaves(state), M.leaves(want)))


def test_trainer_runs_and_refuses_what_is_not_ported():
    cfg = get_config("mamba2-130m", smoke=True).replace(num_layers=1)
    tcfg = T.TrainConfig(warmup=1, total_steps=3,
                         sync_mode="rma_arar_grouped", microbatches=2)
    trainer = T.Trainer(cfg, tcfg, seed=0, device="cpu")
    assert trainer.state["mailbox"]["embed"].dtype == torch.float32
    seen, logs = [], []
    state = trainer.run(TokenStream(cfg, 4, 24, device="cpu"), 3,
                        log_every=1, log=logs.append,
                        on_step=lambda i, m: seen.append(float(m["loss"])))
    assert int(state["step"]) == 3 and len(seen) == 3 == len(logs)
    assert all(np.isfinite(seen))
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        T.make_train_step(cfg, tcfg, mesh=object())
    batch = make_batch(cfg, 1, 8, device="cpu")
    full = M.loss_fn(trainer.state["params"], batch, cfg)[0]
    dots = M.loss_fn(trainer.state["params"], batch,
                     cfg.replace(remat_policy="dots"))[0]
    assert torch.equal(dots, full)     # item 12's policy is ported
    with pytest.raises(ValueError, match="unknown remat_policy"):
        M.loss_fn(trainer.state["params"], batch,
                  cfg.replace(remat_policy="offload"))


def test_microbatches_accumulate_like_jax():
    jcfg = jax_get_config("mamba2-130m", smoke=True).replace(
        dtype="float32", num_layers=1)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jt = JT.TrainConfig(microbatches=2)
    params = JM.init(jax.random.PRNGKey(2), jcfg)
    toks = np.random.RandomState(3).randint(0, 257, (4, 16)).astype(np.int32)
    jl, _, jg = JT._compute_grads(params, {"tokens": jnp.asarray(toks)},
                                  jcfg, jt)
    tl, _, tg = T._compute_grads(
        lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(toks)}, cfg,
        T.TrainConfig(microbatches=2))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    g, w = _flat(M.map_params(lambda x: x.numpy(), tg)), \
        _flat(jax.tree.map(_np, jg))
    for key in w:
        np.testing.assert_allclose(g[key], w[key], err_msg=key, **FP32)


# ----------------------------------------------------------------------------
# SSM serving: prefill and decode


def test_ssm_prefill_and_decode_match_jax():
    """Prefill 20 tokens, then 6 decode steps: logits, the SSM state and
    the conv window after each; the serving path takes no B5 launch."""
    jcfg = jax_get_config("mamba2-130m", smoke=True).replace(dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(4)
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(1), jcfg))
    sub = tree["periods"]["sub0"]["ssm"]
    for key in ("conv_b", "D", "dt_bias", "gnorm"):     # every leaf counts
        sub[key] = (sub[key] + 0.1 * rng.standard_normal(sub[key].shape)
                    ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tree, "cpu")
    toks = rng.integers(0, jcfg.vocab_size, (2, 26))
    jtok = jnp.asarray(toks, jnp.int32)
    tok = torch.from_numpy(toks)
    want, jcache = JM.prefill(jparams, {"tokens": jtok[:, :20]}, jcfg, 26)
    ssd.counts.reset()
    got, cache = M.prefill(params, {"tokens": tok[:, :20]}, cfg, 26)
    np.testing.assert_allclose(got.numpy(), _np(want), **FP32)
    step = make_serve_step(cfg)
    for t in range(20, 26):
        for name in ("state", "conv"):
            np.testing.assert_allclose(
                cache["blocks"]["sub0"][name].numpy(),
                _np(jcache["blocks"]["sub0"][name]), **FP32)
        want, jcache = JM.decode_step(jparams, jtok[:, t:t + 1], jcache, jcfg)
        got, cache = step(params, tok[:, t:t + 1], cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **FP32)
        assert cache["pos"] == int(jcache["pos"]) == t + 1
    assert ssd.counts.launches == ssd.counts.plain_calls == 0


# ----------------------------------------------------------------------------
# configs, size and the CLI


def test_mamba_config_mirrors_jax_and_full_size_on_meta():
    assert "mamba2-130m" in ARCHS
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("mamba2-130m", smoke)) == \
            dataclasses.asdict(jax_get_config("mamba2-130m", smoke))
    cfg = get_config("mamba2-130m")
    params = M.init(torch.Generator(), cfg, device="meta")
    sub = params["periods"]["sub0"]["ssm"]
    assert sub["wx"].shape == (24, 768, 1536)
    assert sub["A_log"].dtype == torch.float32
    assert sub["wz"].dtype == torch.bfloat16
    assert "lm_head" not in params and "ln2" not in params["periods"]["sub0"]
    assert M.param_count(params) == 128_983_488


def test_lm_params_from_numpy_keeps_the_ssm_dtypes():
    jcfg = jax_get_config("mamba2-130m", smoke=True)          # bf16
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    sub = lm_params_from_numpy(tree, "cpu")["periods"]["sub0"]["ssm"]
    assert sub["wz"].dtype == torch.bfloat16
    assert sub["A_log"].dtype == sub["D"].dtype == sub["dt_bias"].dtype \
        == torch.float32
    np.testing.assert_array_equal(
        sub["A_log"].numpy(), tree["periods"]["sub0"]["ssm"]["A_log"])


def test_ssm_init_matches_jax_leaves():
    jcfg = jax_get_config("mamba2-130m", smoke=True)
    jtree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    ours = M.init(torch.Generator().manual_seed(0),
                  get_config("mamba2-130m", smoke=True), "cpu")
    j, t = _flat(jtree), _flat(ours)
    assert set(j) == set(t)
    for key in j:
        assert tuple(t[key].shape) == j[key].shape, key
        assert str(t[key].dtype)[6:] == str(j[key].dtype), key
    for key in ("A_log", "D", "dt_bias", "gnorm", "conv_b"):
        np.testing.assert_allclose(t[f"periods/sub0/ssm/{key}"].float(),
                                   j[f"periods/sub0/ssm/{key}"], rtol=1e-6)


def test_train_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "24"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step     2 loss" in out.stdout
    assert "SSD scan (B5): 0 kernel launches, 12 plain calls" in out.stdout


def test_train_cli_defaults_to_cuda_and_refuses_the_rest(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "mamba2-130m", "--smoke"])
    state = train_cli.main(["--arch", "mamba2-130m", "--smoke", "--device",
                            "cpu", "--steps", "1", "--batch", "1", "--seq",
                            "8", "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 1     # item 12: the checkpoint is written
    assert os.listdir(tmp_path) == ["step_00000001"]
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        train_cli.main(["--arch", "mamba2-130m", "--smoke", "--device",
                        "cpu", "--mesh", "multi"])
