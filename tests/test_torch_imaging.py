"""The port's imaging problems against the JAX package, on the CPU.

Layer by layer, the same numpy inputs from a seed go through `repro` and
`repro_torch`:

  kernels B2/B3   the plain `mask_apply`/`blur2d` against JAX's Pallas
                  kernels in interpret mode and its `kernels/ref.py`
                  oracles, on tests/test_kernels.py's sweep shapes: the
                  mask exact, the blur at rtol/atol 1e-6 (the tolerances
                  of tests/test_kernels.py); the blur's self-adjointness
  conv generator  a JAX stack at full channel widths, carried across by
                  `conv_generator_from_numpy`, with non-zero biases
  forward model   `sample_events` of `imaging` and `imaging_blur` against
                  both JAX lanes; site indices, truth and mask bitwise
  solver          REDUCED preset, a carried conv stack, the JAX draws
                  handed to the port: params, sigma and score at rtol
                  1e-4 / atol 1e-5, kept sets equal up to near-ties
  service         conv stacks through `register_problem(gen_stack=)`,
                  the MLP-only checkpoint route of both packages, obs_dim

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and `chip_smoke.py`.
"""
import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.checkpoint.store import save_checkpoint
from repro.core import gan as jax_gan
from repro.core import workflow as jax_workflow
from repro.kernels import ref as jax_ref
from repro.kernels.imaging import blur2d as jax_blur2d
from repro.kernels.imaging import mask_apply as jax_mask_apply
from repro.models import convgen as jax_convgen
from repro.problems import get_problem as jax_get_problem
from repro.problems import imaging as jax_imaging
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingError as JaxServingError
from repro.serving import SolveService as JaxSolveService

from repro_torch.checkpoint.store import conv_generator_from_numpy
from repro_torch.configs import serving as torch_presets
from repro_torch.core import gan, workflow
from repro_torch.kernels import imaging as kimaging
from repro_torch.kernels import inverse_cdf as kicdf
from repro_torch.kernels import ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convgen
from repro_torch.problems import get_problem
from repro_torch.problems import imaging
from repro_torch.serving import ServingConfig, ServingError, SolveService
from repro_torch.serving import service as service_mod

FP32 = dict(rtol=1e-4, atol=1e-5)
BLUR = dict(rtol=1e-6, atol=1e-6)
TIE_GAP = 1e-5          # kept sets may differ only within this of the cut
CPU = "cpu"
PROBLEMS = ("imaging", "imaging_blur")


def _bf16(a):
    """a rounded to bf16, as an fp32 numpy array both sides can take."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a, dtype),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


def _jax_conv_stack(ranks=2, seed=0, bias=0.1):
    """A JAX-initialised conv stack with non-zero biases on every layer."""
    keys = jax.random.split(jax.random.PRNGKey(seed), ranks)
    stack = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[jax_gan.init_generator(k, param_shape=(32, 32))
                           for k in keys])
    rng = np.random.default_rng(seed + 100)
    for layer in [stack["proj"]] + stack["convs"]:
        layer["b"] = layer["b"] + bias * rng.standard_normal(
            layer["b"].shape).astype(np.float32)
    return stack


def _flat(stack):
    """The JAX conv stack's path-flattened numpy arrays (checkpoint keys)."""
    flat = {f"proj/{k}": np.asarray(v) for k, v in stack["proj"].items()}
    for i, layer in enumerate(stack["convs"]):
        flat.update({f"convs/{i}/{k}": np.asarray(v)
                     for k, v in layer.items()})
    return flat


def _port_stack(jstack):
    return conv_generator_from_numpy(_flat(jstack), CPU)


def _jax_draws(cfg, R, C):
    """The JAX solver's draws, by its key splits (workflow.py:263-283)."""
    k_noise, k_u = jax.random.split(jax.random.PRNGKey(cfg.seed))
    noise = jax.random.normal(k_noise, (R, cfg.n_candidates,
                                        jax_gan.NOISE_DIM))
    u = jax.random.uniform(k_u, (R * cfg.n_candidates,
                                 cfg.events_per_candidate, C))
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(u))


def _jax_cfg(cfg, impl="jnp"):
    return jax_workflow.SolveConfig(
        n_candidates=cfg.n_candidates,
        events_per_candidate=cfg.events_per_candidate, top_frac=cfg.top_frac,
        seed=cfg.seed, sampler_impl=impl,
        sampler_interpret=True if impl == "pallas" else None)


def _jax_scores(prob, jcfg, jstack, ys, mask):
    """The JAX solver's candidates and scores [B, R·M], step by step as
    `repro.core.workflow.make_solver` computes them."""
    R = jax.tree.leaves(jstack)[0].shape[0]
    M, E = jcfg.n_candidates, jcfg.events_per_candidate
    k_noise, k_u = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    noise = jax.random.normal(k_noise, (R, M, jax_gan.NOISE_DIM))
    cands = jax.vmap(jax_gan.generate_params)(jstack, noise).reshape(R * M, -1)
    u = jax.random.uniform(k_u, (R * M, E, prob.noise_channels))
    events = prob.sample_events(cands, u, impl=jcfg.sampler_impl,
                                interpret=jcfg.sampler_interpret)
    events = events.reshape(R * M, E, -1)

    def moments(ev, w):
        n = jnp.maximum(w.sum(), 1.0)
        mean = (ev * w[:, None]).sum(axis=0) / n
        var = (((ev - mean) ** 2) * w[:, None]).sum(axis=0) / n
        return jnp.concatenate([mean, jnp.sqrt(var + 1e-12)])

    cand_mom = jax.vmap(lambda ev: moments(ev, jnp.ones((E,))))(events)
    scale = cand_mom.std(axis=0) + 1e-6

    def score_one(y, w):
        d = (cand_mom - moments(y, w.astype(y.dtype))[None, :]) / scale
        return -jnp.mean(d * d, axis=1)

    return cands, jax.vmap(score_one)(ys, mask)


def _requests(jprob, sizes, seed=5):
    out, key = [], jax.random.PRNGKey(seed)
    for n in sizes:
        key, k = jax.random.split(key)
        out.append(np.asarray(jprob.make_reference_data(k, int(n))))
    return out


def _batch(reqs, bucket):
    ys = np.zeros((len(reqs), bucket, reqs[0].shape[1]), np.float32)
    mask = np.zeros((len(reqs), bucket), bool)
    for i, y in enumerate(reqs):
        ys[i, :len(y)], mask[i, :len(y)] = y, True
    return ys, mask


def _tiny_cfg(max_batch=2):
    return ServingConfig(
        buckets=(16, 64), max_batch=max_batch, queue_capacity=16,
        cache_capacity=4, retry_after_s=0.01,
        solve=workflow.SolveConfig(n_candidates=8, events_per_candidate=8))


# ----------------------------------------------------------------------------
# kernels B2 and B3: the plain versions against JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,P", [(1, 32), (7, 100), (64, 1024), (300, 128)])
def test_mask_apply_matches_jax(K, P, dtype):
    rng = np.random.default_rng(K * 1000 + P)
    x = rng.standard_normal((K, P)).astype(np.float32)
    m = (rng.uniform(size=P) > 0.4).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    (xj, xt), (mj, mt) = _both(x, dtype), _both(m, dtype)
    y = kimaging.mask_apply(xt, mt)
    assert y.dtype == xt.dtype and y.shape == (K, P)
    got = y.float().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_mask_apply(xj, mj, interpret=True), np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(jax_ref.mask_apply_ref(xj, mj), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,H,W", [(1, 8, 8), (5, 32, 32), (20, 16, 24),
                                   (3, 1, 5)])
def test_blur2d_matches_jax(K, H, W, dtype):
    x = np.random.default_rng(K + H * W).standard_normal(
        (K, H, W)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    xj, xt = _both(x, dtype)
    y = kimaging.blur2d(xt)
    assert y.dtype == xt.dtype and y.shape == (K, H, W)
    got = y.float().numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_blur2d(xj, interpret=True), np.float32), **BLUR)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.blur2d_ref(xj), np.float32), **BLUR)


def test_blur2d_is_self_adjoint():
    rng = np.random.default_rng(9)
    x, y = (torch.from_numpy(rng.standard_normal((3, 16, 16)).astype(
        np.float32)) for _ in range(2))
    lhs = torch.vdot(kimaging.blur2d(x).flatten(), y.flatten())
    rhs = torch.vdot(x.flatten(), kimaging.blur2d(y).flatten())
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def test_blur_taps_and_constants_match_jax():
    from repro.kernels import imaging as jax_kimaging
    assert (ref.BLUR_W0, ref.BLUR_W1) == (jax_kimaging.BLUR_W0,
                                          jax_kimaging.BLUR_W1)
    for name in ("H", "W", "SIGMA", "OCC_ROWS", "OCC_COLS", "BLUR_STRIDE",
                 "PE_FREQS", "EVENT_DIM"):
        assert getattr(imaging, name) == getattr(jax_imaging, name), name


def test_imaging_wrappers_cpu_route_and_checks():
    """CPU tensors take the plain versions; what the kernels would refuse
    (shape, dtype, strides, device) raises on every device."""
    x = torch.randn(6, 40)
    m = (torch.rand(40) > 0.5).float()
    img = torch.randn(4, 8, 8)
    for c in (kimaging.mask_counts, kimaging.blur_counts):
        c.reset()
    kimaging.mask_apply(x, m, threads=64)
    kimaging.blur2d(img, rows=3)
    assert (kimaging.mask_counts.plain_calls, kimaging.mask_counts.launches,
            kimaging.blur_counts.plain_calls,
            kimaging.blur_counts.launches) == (1, 0, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kimaging.mask_apply(x.t().contiguous().t(), m[:6])
    with pytest.raises(ValueError, match="contiguous"):
        kimaging.blur2d(img.transpose(1, 2))
    with pytest.raises(TypeError):
        kimaging.mask_apply(x.double(), m)
    with pytest.raises(TypeError):
        kimaging.mask_apply(x, m.half())
    with pytest.raises(TypeError):
        kimaging.blur2d(img.half())
    with pytest.raises(ValueError):
        kimaging.mask_apply(x, m[:39])                      # [P] mismatch
    with pytest.raises(ValueError):
        kimaging.blur2d(x)                                  # not [K, H, W]
    for bad in (0, 16, 48 + 1, 2048):
        with pytest.raises(ValueError, match="threads"):
            kimaging.mask_apply(x, m, threads=bad)
    with pytest.raises(ValueError, match="rows"):
        kimaging.blur2d(img, rows=0)
    meta = torch.empty((4, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kimaging.blur2d(meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kimaging.mask_apply(meta[0], torch.empty(8, device="meta"))
    assert kimaging.mask_counts.plain_calls == 1
    assert kimaging.blur_counts.plain_calls == 1


def test_readout_hands_the_sampler_a_contiguous_u(monkeypatch):
    """JAX draws the noise from u[..., 1], a stride-2 view; the sampler
    takes a contiguous u, so the readout copies, and a strided u into the
    sampler raises."""
    seen = []

    def spy(u, mu, s, k):
        seen.append((tuple(u.shape), u.is_contiguous()))
        return kicdf.inverse_cdf(u, mu, s, k)

    monkeypatch.setattr(imaging, "inverse_cdf", spy)
    u = torch.rand(5, 7, 2)
    for name in PROBLEMS:
        get_problem(name).sample_events(torch.rand(5, 1024), u)
    assert seen == [((5, 7), True)] * 2
    with pytest.raises(ValueError, match="contiguous"):
        kicdf.inverse_cdf(u[..., 1], torch.zeros(5), torch.full((5,), 0.05),
                          torch.zeros(5))


# ----------------------------------------------------------------------------
# the conv generator


def test_conv_generator_constants_and_init():
    assert convgen.CONV_CHANNELS == jax_convgen.CONV_CHANNELS
    assert convgen.UPSAMPLE_STAGES == jax_convgen.UPSAMPLE_STAGES
    assert convgen.LEAK == jax_convgen.LEAK == gan.LEAK
    for shape in ((32, 32), (16, 8)):
        assert convgen.base_grid(shape) == jax_convgen.base_grid(shape)
        assert convgen.conv_gen_widths(shape, 135) == \
            jax_convgen.conv_gen_widths(shape, 135)
    with pytest.raises(ValueError):
        convgen.base_grid((30, 32))
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=16,
                               device=CPU, param_shape=(32, 32))
    assert isinstance(stack, dict)
    assert gan.param_count(stack) == 16 * 292545
    jone = jax_gan.init_generator(jax.random.PRNGKey(0), param_shape=(32, 32))
    for key, leaf in convgen.flatten(stack).items():
        assert tuple(leaf.shape) == (16,) + _flat(jone)[key].shape, key
    w = stack["proj"]["w"]
    assert abs(float(w.std()) - (2.0 / 135) ** 0.5) < 0.01
    w1 = stack["convs"][1]["w"]
    assert abs(float(w1.std()) - (2.0 / (9 * 32)) ** 0.5) < 0.01
    assert all(float(t.abs().max()) == 0.0 for k, t in
               convgen.flatten(stack).items() if k.endswith("b"))


@pytest.mark.parametrize("bias", [0.0, 0.3])
def test_conv_generator_carried_over_matches_jax(bias):
    """Full channel widths, 2 ranks, a few candidates; non-zero biases
    catch a transposed HWIO weight or an NCHW read of the projection."""
    jstack = _jax_conv_stack(2, seed=1, bias=bias)
    noise = np.random.default_rng(2).standard_normal(
        (2, 6, jax_gan.NOISE_DIM)).astype(np.float32)
    p = gan.generate_params(_port_stack(jstack), torch.from_numpy(noise))
    p_jax = jax.vmap(jax_gan.generate_params)(jstack, noise)
    assert p.shape == (2, 6, 1024) and p.is_contiguous()
    np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), **FP32)
    # one generator, no rank axis: JAX's per-rank function
    one = jax.tree.map(lambda a: a[1], jstack)
    stack_of_one = conv_generator_from_numpy(
        {k: v[None] for k, v in _flat(one).items()}, CPU)
    p1 = gan.generate_params(stack_of_one, torch.from_numpy(noise[1:]))[0]
    np.testing.assert_allclose(p1.numpy(), np.asarray(
        jax_convgen.conv_generator_apply(one, noise[1])), **FP32)
    single = convgen.conv_generator_apply(
        gan.map_leaves(lambda t: t[0], stack_of_one),
        torch.from_numpy(noise[1]))
    np.testing.assert_array_equal(single.numpy(), p1.numpy())


def test_conv_runs_with_tf32_off_scoped_to_the_call(monkeypatch):
    """The conv sees cuDNN TF32 off and cuDNN otherwise as it was; the
    process-wide flags are as before once the call returns."""
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
              cudnn.deterministic)
    seen = []
    real = convgen.F.conv2d

    def spy(*args, **kwargs):
        seen.append((cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
                     cudnn.deterministic))
        return real(*args, **kwargs)

    monkeypatch.setattr(convgen.F, "conv2d", spy)
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=2,
                               device=CPU, param_shape=(32, 32))
    gan.generate_params(stack, torch.randn(2, 3, gan.NOISE_DIM))
    assert seen == [(False,) + before[1:]] * 3
    assert (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic) == before


def test_conv_generator_from_numpy_validates():
    flat = _flat(_jax_conv_stack(2))
    assert gan.param_count(conv_generator_from_numpy(flat, CPU)) == \
        2 * 292545
    for mutate, match in (
            (lambda f: f.pop("convs/1/b"), "leaves"),
            (lambda f: f.update({"convs/3/w": f["convs/2/w"]}), "leaves"),
            (lambda f: f.update({"proj/w": f["proj/w"][0]}), "stacked"),
            (lambda f: f.update({"convs/0/w": f["convs/0/w"][:, :2]}),
             "HWIO"),
            (lambda f: f.update({"convs/1/b": f["convs/1/b"][:1]}), "HWIO"),
            (lambda f: f.update({"convs/1/w": f["convs/1/w"][..., :16, :],
                                 }), "previous conv"),
            (lambda f: f.update({"convs/0/w": f["convs/0/w"][..., :30, :],
                                 "convs/1/w": f["convs/1/w"][..., :30, :]}),
             "divide")):
        bad = dict(flat)
        mutate(bad)
        with pytest.raises(ValueError, match=match):
            conv_generator_from_numpy(bad, CPU)


# ----------------------------------------------------------------------------
# the forward model


def test_truth_mask_and_registry_match_jax():
    for name in PROBLEMS:
        prob, jprob = get_problem(name), jax_get_problem(name)
        for attr in ("n_params", "obs_dim", "noise_channels", "param_shape",
                     "events_per_sample", "solve_threshold"):
            assert getattr(prob, attr) == getattr(jprob, attr), (name, attr)
        truth = prob.true_params(CPU).numpy()
        np.testing.assert_array_equal(
            truth.view(np.uint32),
            np.asarray(jprob.true_params()).view(np.uint32))
    np.testing.assert_array_equal(
        imaging.MASK.view(np.uint32),
        np.asarray(jax_imaging.MASK).view(np.uint32))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("K,E", [(3, 5), (37, 16)])
def test_sample_events_matches_jax(name, K, E, impl):
    rng = np.random.default_rng(K * 10 + E)
    params = rng.uniform(0.01, 0.99, (K, 1024)).astype(np.float32)
    u = rng.uniform(size=(K, E, 2)).astype(np.float32)
    u[0, :3, 0] = (0.0, 1.0 - 2 ** -24, 0.5)       # first, last, middle site
    y = get_problem(name).sample_events(torch.from_numpy(params),
                                        torch.from_numpy(u)).numpy()
    y_jax = np.asarray(jax_get_problem(name).sample_events(
        params, u, impl=impl, interpret=True))
    assert y.shape == (K * E, 15) and y.dtype == np.float32
    n_sites = 1024 if name == "imaging" else 256
    idx = imaging.site_index(torch.from_numpy(u[..., 0]), n_sites).numpy()
    idx_jax = np.asarray(jnp.clip((u[..., 0] * n_sites).astype(jnp.int32),
                                  0, n_sites - 1))
    np.testing.assert_array_equal(idx, idx_jax)
    np.testing.assert_array_equal(y[:, :2], y_jax[:, :2])    # (row, col)
    np.testing.assert_allclose(y, y_jax, **FP32)


def test_make_reference_data_matches_jax_in_distribution():
    """Different random streams, the same distribution: the readings'
    positions and values agree in their moments."""
    for name in PROBLEMS:
        y = get_problem(name).make_reference_data(
            torch.Generator().manual_seed(0), 20000, device=CPU).numpy()
        y_jax = np.asarray(jax_get_problem(name).make_reference_data(
            jax.random.PRNGKey(0), 20000))
        assert y.shape == (20000, 15) and np.isfinite(y).all()
        np.testing.assert_allclose(y.mean(0), y_jax.mean(0), atol=0.02)
        np.testing.assert_allclose(y.std(0), y_jax.std(0), atol=0.02)


# ----------------------------------------------------------------------------
# the solve


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", PROBLEMS)
def test_solver_matches_jax(name, impl):
    """REDUCED preset, a carried 2-rank conv stack, the JAX draws."""
    cfg = torch_presets.REDUCED
    R, bucket = 2, cfg.buckets[-1]
    prob, jprob = get_problem(name), jax_get_problem(name)
    jstack = _jax_conv_stack(R, seed=3)
    reqs = _requests(jprob, np.linspace(2, bucket, cfg.max_batch).astype(int))
    ys, mask = _batch(reqs, bucket)
    jcfg = _jax_cfg(cfg.solve, impl)

    solver = workflow.make_solver(prob, cfg.solve, _jax_draws(cfg.solve, R, 2))
    stack = _port_stack(jstack)
    ys_t, mask_t = torch.from_numpy(ys), torch.from_numpy(mask)
    out = solver(stack, ys_t, mask_t)
    out_jax = jax.jit(jax_workflow.make_solver(jprob, jcfg))(
        jstack, jnp.asarray(ys), jnp.asarray(mask))

    k = solver.keep(R)
    cands_j, scores_j = _jax_scores(jprob, jcfg, jstack, jnp.asarray(ys),
                                    jnp.asarray(mask))
    top_j, idx_j = jax.lax.top_k(scores_j, k)
    np.testing.assert_allclose(
        np.asarray(jnp.take(cands_j, idx_j, axis=0).mean(axis=1)),
        np.asarray(out_jax["params"]), rtol=1e-6)
    cands, scores = solver.scores(stack, ys_t, mask_t)
    np.testing.assert_allclose(cands.numpy(), np.asarray(cands_j), **FP32)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), **FP32)
    idx = torch.topk(scores, k, dim=1).indices.numpy()
    scores_j, idx_j = np.asarray(scores_j), np.asarray(idx_j)
    same = []
    for b in range(len(reqs)):
        diff = set(idx[b].tolist()) ^ set(idx_j[b].tolist())
        cut = np.sort(scores_j[b])[::-1][k - 1]
        assert all(abs(scores_j[b, i] - cut) < TIE_GAP for i in diff), b
        if not diff:
            same.append(b)
    assert len(same) >= len(reqs) - 1
    for key in ("params", "sigma", "score"):
        np.testing.assert_allclose(out[key].numpy()[same],
                                   np.asarray(out_jax[key])[same], **FP32)
    assert out["params"].shape == (len(reqs), 1024)


# ----------------------------------------------------------------------------
# the service


@pytest.mark.parametrize("name", PROBLEMS)
def test_service_serves_a_conv_stack_as_jax_does(name, monkeypatch):
    """Both services, one carried conv stack, the same requests and draws:
    finite results that agree, and the forward kernels' plain versions
    ran once per solver call (CPU tensors)."""
    monkeypatch.setattr(service_mod, "solve_draws",
                        lambda cfg, R, problem, device: tuple(
                            t.to(device) for t in
                            _jax_draws(cfg, R, problem.noise_channels)))
    cfg = _tiny_cfg()
    jstack = _jax_conv_stack(2, seed=7)
    reqs = _requests(jax_get_problem(name), [3, 16, 40], seed=11)
    svc = SolveService(cfg, device=CPU)
    svc.register_problem(name, gen_stack=_port_stack(jstack))
    jsvc = JaxSolveService(JaxServingConfig(
        buckets=cfg.buckets, max_batch=cfg.max_batch,
        queue_capacity=cfg.queue_capacity, cache_capacity=cfg.cache_capacity,
        retry_after_s=cfg.retry_after_s, solve=_jax_cfg(cfg.solve)))
    jsvc.register_problem(name, gen_stack=jstack)
    for c in (kicdf.counts, kimaging.mask_counts, kimaging.blur_counts):
        c.reset()
    tickets = [svc.submit(name, y) for y in reqs]
    jtickets = [jsvc.submit(name, y) for y in reqs]
    assert svc.run_until_empty() == jsvc.run_until_empty() == len(reqs)
    for t, jt in zip(tickets, jtickets):
        out = t.result(timeout=60)
        assert out["params"].shape == (1024,)
        assert all(np.isfinite(v).all() for v in out.values())
        for key in ("params", "sigma", "score"):
            np.testing.assert_allclose(out[key], jt.result()[key], **FP32)
    calls = svc.cache.stats["compiles"] + 2      # 2 builds + 2 batches
    forward = kimaging.mask_counts if name == "imaging" \
        else kimaging.blur_counts
    other = kimaging.blur_counts if name == "imaging" \
        else kimaging.mask_counts
    assert kicdf.counts.plain_calls == forward.plain_calls == calls == 4
    assert other.plain_calls == 0
    assert kicdf.counts.launches == forward.launches == 0


def test_service_refuses_stacks_that_do_not_fit():
    svc = SolveService(_tiny_cfg(), device=CPU)
    g = torch.Generator().manual_seed(0)
    small = gan.init_generator(g, ranks=2, device=CPU, param_shape=(16, 16))
    with pytest.raises(ServingError, match="param_shape"):
        svc.register_problem("imaging", gen_stack=small)
    conv = gan.init_generator(g, ranks=2, device=CPU, param_shape=(32, 32))
    swapped = gan.map_leaves(lambda t: t, conv)
    swapped["convs"][1]["w"] = swapped["convs"][1]["w"].transpose(3, 4)
    with pytest.raises(ServingError, match="param_shape"):
        svc.register_problem("imaging_blur", gen_stack=swapped)
    ragged = gan.map_leaves(lambda t: t, conv)
    ragged["convs"][2]["b"] = ragged["convs"][2]["b"][:1]
    with pytest.raises(ServingError, match="rank axis"):
        svc.register_problem("imaging", gen_stack=ragged)
    with pytest.raises(ServingError, match="MLP"):
        svc.register_problem("proxy1d", gen_stack=conv)
    with pytest.raises(ServingError, match="neither"):
        svc.register_problem("imaging", gen_stack={"proj": {}})
    # an MLP stack with the problem's 1024 outputs is served, as by JAX
    svc.register_problem("imaging", gen_stack=gan.init_generator(
        g, n_params=1024, ranks=2, device=CPU))
    svc.register_problem("imaging_blur", gen_stack=conv)
    assert svc.problems() == ("imaging", "imaging_blur")


def test_service_enforces_obs_dim_15():
    svc = SolveService(_tiny_cfg(), device=CPU)
    svc.register_problem("imaging", gen_stack=gan.init_generator(
        torch.Generator().manual_seed(0), ranks=2, device=CPU,
        param_shape=(32, 32)))
    with pytest.raises(ServingError, match="15"):
        svc.submit("imaging", np.zeros((4, 2), np.float32))
    with pytest.raises(ServingError, match="15"):
        svc.submit("imaging", np.zeros((4, 16), np.float32))
    svc.submit("imaging", np.zeros((4, 15), np.float32))
    assert svc.run_until_empty() == 1


def test_conv_checkpoint_refused_by_both_services(tmp_path):
    """The checkpoint route restores the MLP only, in the JAX package and
    in the port: a JAX-written conv checkpoint is a ServingError in both."""
    save_checkpoint(str(tmp_path), 5, {"gen": _jax_conv_stack(2)})
    jsvc = JaxSolveService(JaxServingConfig(buckets=(64,), max_batch=2))
    with pytest.raises(JaxServingError):
        jsvc.register_problem("imaging", checkpoint_dir=str(tmp_path))
    svc = SolveService(_tiny_cfg(), device=CPU)
    for name in PROBLEMS:
        with pytest.raises(ServingError, match="conv generator"):
            svc.register_problem(name, checkpoint_dir=str(tmp_path))


def test_serve_cli_demo_serves_image_problems_with_an_mlp(capsys):
    """The CLI's demo mode mirrors the JAX CLI: an untrained 2-rank MLP
    with the problem's 1024 outputs."""
    svc = serve_cli.main(["--problem", "imaging", "--problem",
                          "imaging_blur", "--preset", "reduced", "--device",
                          "cpu", "--requests", "2"])
    out = capsys.readouterr().out
    assert svc.served == 4
    assert out.count("MLP prior stack, 135 -> 1024") == 2
    for name in PROBLEMS:
        _, stack = svc._problems[name]
        assert isinstance(stack, list) and stack[-1]["w"].shape == (2, 128,
                                                                   1024)
    assert "mask_apply: 0 kernel launches" in out
    assert "blur2d: 0 kernel launches" in out
