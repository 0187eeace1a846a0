"""Every problem of the JAX registry in the port, against the JAX package.

The same inputs go through `repro` and `repro_torch` on the CPU, made from
a numpy seed or drawn by JAX in the reference's own key-split order and
handed to the port (`jax_draws`, as tests/test_torch_gan.py does); the
Pallas kernels run in interpret mode.  fp32 rtol 1e-4 / atol 1e-5 unless
a test says otherwise.

  registry        `available()`, the truths and every constant
  forward model   `sample_events` of proxy2d and linear_blur against the
                  JAX "jnp" and "pallas" paths, forward and gradient
  networks        the gradient reaches the generator for all five
                  problems, against JAX's; the conv generator's weight
                  mask and FusionSpec (offsets and flat payload bitwise);
                  Adam over the conv generator with an [R] step
  training        3 epochs of proxy2d, linear_blur and imaging from a JAX
                  `init_run` state in both ring modes; fused and unfused
                  exchange bitwise for all five
  solve           the solver of proxy2d and linear_blur against JAX's
  checkpoints     a proxy2d store read by JAX and served by both
                  services; an imaging store restored by JAX's reader into
                  the conv template, and resumed bitwise
  CLI             `python -m repro_torch.launch.train_gan --problem ...`

The card's side is `chip_smoke.py` phases 25-28.
"""
import functools

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_latest as jax_restore_latest
from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import gan as JG
from repro.core import sync as JS
from repro.core import workflow as JW
from repro.optim import adam as jax_adam
from repro.problems import available as jax_available
from repro.problems import get_problem as jax_get_problem
from repro.problems import linear as jax_linear
from repro.problems import proxy2d as jax_proxy2d
from repro.problems import synthetic_events as jax_synthetic_events
from repro.serving.service import load_generator_stack as jax_load_stack

from repro_torch.checkpoint.store import (gan_state_from_numpy,
                                          load_generator_stack)
from repro_torch.core import gan, sync, workflow
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.kernels.imaging import blur_counts, mask_counts
from repro_torch.kernels.inverse_cdf import counts as icdf_counts
from repro_torch.optim import adam
from repro_torch.problems import available, get_problem, linear, proxy2d
from repro_torch.problems import synthetic_events

from test_torch_gan import jax_draws
from test_torch_serving import TIE_GAP, _jax_cfg, _jax_draws, _jax_scores

FP32 = dict(rtol=1e-4, atol=1e-5)
FLAT = ("proxy2d", "linear_blur")
ALL = ("proxy1d", "proxy2d", "linear_blur", "imaging", "imaging_blur")
# smoke sizes: R 4 as 2 x 2; the image problems at a smaller batch and
# the capped generator step of `configs.sagips_gan.for_problem`
SMOKE = dict(n_param_samples=16, events_per_sample=8, gen_lr=2e-4,
             disc_lr=5e-4)
IMAGE_SMOKE = dict(SMOKE, n_param_samples=8, gen_lr=5e-5)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _wcfgs(problem, mode="rma_arar_arar", h=1, fuse=True):
    """The same settings as a JAX and a port WorkflowConfig."""
    args = dict(IMAGE_SMOKE if get_problem(problem).param_shape else SMOKE,
                problem=problem)
    return (JW.WorkflowConfig(sync=JS.SyncConfig(mode=mode, h=h,
                                                 fuse_tensors=fuse), **args),
            workflow.WorkflowConfig(sync=sync.SyncConfig(
                mode=mode, h=h, fuse_tensors=fuse), **args))


@functools.lru_cache(maxsize=None)
def _jax_init_run(problem):
    """A JAX `init_run` of 4 ranks at the smoke sizes (the state depends
    on neither the ring mode nor h), made once per problem."""
    jcfg, _ = _wcfgs(problem)
    data = jax.jit(lambda k: jax_get_problem(problem).make_reference_data(
        k, 1_000))(jax.random.PRNGKey(99))
    return jax.jit(JW.init_run, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), 4, jcfg, data)


def _port_state(jstate):
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    return gan_state_from_numpy(flat, "cpu")


def _assert_state_close(pstate, jstate):
    """Every leaf at fp32 tolerance, elementwise: the conv generator too,
    though its convs sum in another order than JAX's patches + einsum."""
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()
            if not k.startswith("rng")}
    got = dict(tree_paths(pstate))
    assert set(got) == set(flat)
    for k, want in flat.items():
        assert tuple(got[k].shape) == want.shape, k
        np.testing.assert_allclose(_np(got[k]), want, err_msg=k, **FP32)


# ----------------------------------------------------------------------------
# the registry


def test_registry_and_constants_match_jax():
    assert available() == jax_available() == tuple(sorted(ALL))
    for name in ALL:
        p, j = get_problem(name), jax_get_problem(name)
        for attr in ("n_params", "obs_dim", "noise_channels",
                     "solve_threshold", "param_shape", "events_per_sample"):
            assert getattr(p, attr) == getattr(j, attr), (name, attr)
        np.testing.assert_array_equal(_np(p.true_params("cpu")),
                                      np.asarray(j.true_params()))
    np.testing.assert_array_equal(linear.A, np.asarray(jax_linear.A))
    assert linear.SIGMA == jax_linear.SIGMA and \
        linear._X_RANGE == jax_linear._X_RANGE
    assert proxy2d._RHO_RANGE == jax_proxy2d._RHO_RANGE
    assert proxy2d.N_CHANNELS == jax_proxy2d.N_CHANNELS


# ----------------------------------------------------------------------------
# the forward model of the flat problems


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", FLAT)
def test_sample_events_match_jax(name, impl):
    """Forward and gradient w.r.t. params (a random cotangent) against
    the JAX problem's "jnp" path and its Pallas path in interpret mode;
    one plain call of B1 on u [K, E, C], one backward."""
    p, j = get_problem(name), jax_get_problem(name)
    rng = np.random.default_rng(len(name) + len(impl))
    K, E = 6, 9
    params = rng.uniform(0.02, 0.98, (K, p.n_params)).astype(np.float32)
    u = rng.uniform(size=(K, E, p.noise_channels)).astype(np.float32)
    cot = rng.standard_normal((K * E, p.obs_dim)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda pp: j.sample_events(
        pp, jnp.asarray(u), impl=impl, interpret=True), jnp.asarray(params))
    (g_j,) = vjp(jnp.asarray(cot))
    icdf_counts.reset()
    pt = _t(params).requires_grad_()
    y = p.sample_events(pt, _t(u))
    (g,) = torch.autograd.grad(y, pt, _t(cot))
    assert (icdf_counts.plain_calls, icdf_counts.backward_plain) == (1, 1)
    assert y.shape == (K * E, p.obs_dim)
    np.testing.assert_allclose(_np(y), np.asarray(y_j), **FP32)
    np.testing.assert_allclose(_np(g), np.asarray(g_j), **FP32)


# ----------------------------------------------------------------------------
# the networks


@pytest.mark.parametrize("name", ALL)
def test_gradient_reaches_the_generator(name):
    """As tests/test_problems.py::test_gradient_flows_discriminator_to_
    generator: from the discriminator through the problem's forward model
    into the generator, nonzero and finite, and equal to JAX's from the
    same weights and draws."""
    p, j = get_problem(name), jax_get_problem(name)
    kg, kd, ke = jax.random.split(jax.random.PRNGKey(3), 3)
    jgen = JG.init_generator(kg, n_params=j.n_params,
                             param_shape=j.param_shape)
    jdisc = JG.init_discriminator(kd, obs_dim=j.obs_dim)
    K, E = 8, 4

    def objective(gp):
        fake, _ = jax_synthetic_events(j, gp, ke, K, E)
        return JG.gen_loss(jdisc, fake)
    jgrad = jax.jit(jax.grad(objective))(jgen)
    k1, k2 = jax.random.split(ke)
    noise = _t(jax.random.normal(k1, (K, JG.NOISE_DIM)))[None]
    u = _t(jax.random.uniform(k2, (K, E, j.noise_channels)))[None]
    # stacked R = 1, as the trainer holds them
    pgen = tree_map(lambda a: _t(a)[None].requires_grad_(), jgen)
    pdisc = tree_map(lambda a: _t(a)[None], jdisc)
    fake, _ = synthetic_events(p, pgen, noise, u)
    grads = torch.autograd.grad(gan.gen_loss(pdisc, fake).sum(),
                                tree_leaves(pgen))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0
    for g, want in zip(grads, jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(_np(g[0]), np.asarray(want), **FP32)


def test_conv_weight_mask_and_fusion_spec_match_jax():
    """The conv generator's mask is JAX's; the FusionSpec follows the
    tree's order (convs/0..2, then proj: `jax.tree.leaves` sorts dict
    keys), so offsets, sizes and the flat payload are JAX's, bitwise."""
    jcfg, pcfg = _wcfgs("imaging")
    jspec, pspec = JW.make_schedule(jcfg).spec, workflow.make_schedule(
        pcfg).spec
    jgen = JG.init_generator(jax.random.PRNGKey(0), param_shape=(32, 32))
    pgen = tree_map(_t, jgen)
    assert gan.weight_mask(pgen) == JG.weight_mask(jgen)
    assert pspec.total == jspec.total == 290_448    # the weights only
    assert [(s.masked, s.shape, s.size, s.offset) for s in pspec.slots] == \
        [(s.masked, tuple(s.shape), s.size, s.offset) for s in jspec.slots]
    assert [path for path, _ in tree_paths(pspec.slots_tree)][:2] == \
        ["convs/0/b", "convs/0/w"]
    R = 3
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda a: rng.standard_normal(
        (R,) + a.shape).astype(np.float32), jgen)
    flat = pspec.flatten(tree_map(_t, grads), stacked=True)
    np.testing.assert_array_equal(
        _np(flat), np.asarray(jspec.flatten(jax.tree.map(jnp.asarray, grads),
                                            stacked=True)))
    back = pspec.unflatten(flat, tree_map(_t, grads), stacked=True)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(grads)):
        np.testing.assert_array_equal(_np(a), b)


def test_adam_over_the_conv_generator():
    """Adam over the conv generator's dict tree with an [R] step: three
    steps against the JAX package's `jax.vmap`ped Adam."""
    R = 2
    rng = np.random.default_rng(5)
    jgen = JG.init_generator(jax.random.PRNGKey(1), param_shape=(32, 32))
    params = jax.tree.map(lambda a: np.stack([np.asarray(a)] * R), jgen)
    opt, jopt = adam(1e-3), jax_adam(1e-3)
    st = tree_map(lambda *xs: torch.stack(xs), *[
        opt.init(tree_map(lambda a: _t(a[r]), params)) for r in range(R)])
    jst = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    assert st["step"].shape == (R,)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        upd, st = opt.update(tree_map(_t, g), st)
        jupd, jst = jax.vmap(jopt.update)(jax.tree.map(jnp.asarray, g), jst)
        for a, b in zip(tree_leaves(upd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    for (path, a), b in zip(tree_paths(st), jax.tree.leaves(jst)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-9, err_msg=path)


# ----------------------------------------------------------------------------
# training


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
@pytest.mark.parametrize("name", ["proxy2d", "linear_blur", "imaging"])
def test_three_epochs_match_jax(name, mode):
    """3 epochs of the port's epoch function against JAX's jitted epoch
    at h 1 from a JAX `init_run` state, the draws replayed from the JAX
    state's rng each epoch: losses every epoch, then every leaf of the
    state, the conv generator's included, elementwise."""
    jcfg, pcfg = _wcfgs(name, mode)
    jstate, jdata = _jax_init_run(name)
    pstate, pdata = _port_state(jstate), _t(jdata)
    jepoch = JW.make_epoch_fn_vmap(2, 2, jcfg)
    pepoch = workflow.make_epoch_fn(2, 2, pcfg)
    jstate = jax.tree.map(jnp.copy, jstate)
    C = get_problem(name).noise_channels
    for e in range(3):
        _, draws = jax_draws(jstate["rng"], jcfg, jdata.shape[1], C)
        jstate, jm = jepoch(jstate, jdata)
        pstate, pm = pepoch(pstate, pdata, draws, e)
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(_np(pm[k]), np.asarray(jm[k]),
                                       err_msg=k, **FP32)
    _assert_state_close(pstate, jstate)


@pytest.mark.parametrize("name", ALL)
def test_fused_and_unfused_exchange_agree_bitwise(name):
    """As tests/test_problems.py::test_train_vmap_epoch_and_fusion_parity:
    one epoch with the fused payload and one without, from one state and
    one set of draws, give the same generator bit for bit, and every leaf
    of the state stays finite."""
    p = get_problem(name)
    outs = {}
    for fuse in (False, True):
        _, pcfg = _wcfgs(name, "arar_arar", h=2, fuse=fuse)
        g = torch.Generator().manual_seed(1)
        data = p.make_reference_data(g, 400, device="cpu")
        state, per_rank = workflow.init_run(g, 4, pcfg, data, "cpu")
        draws = workflow.make_draws(g, pcfg, 4, per_rank.shape[1])
        outs[fuse], metrics = workflow.make_epoch_fn(2, 2, pcfg)(
            state, per_rank, draws, 0)
        assert metrics["residuals"].shape == (4, p.n_params)
    for a, b in zip(tree_leaves(outs[False]["gen"]),
                    tree_leaves(outs[True]["gen"])):
        assert torch.equal(a, b)
    for path, leaf in tree_paths(outs[True]):
        assert bool(torch.isfinite(leaf.float()).all()), path


@pytest.mark.parametrize("name", ALL)
def test_train_stacked_counts_each_kernel(name):
    """`train_stacked` trains every problem on CPU tensors: 3 epochs
    finite, the forward model's wrappers called once an epoch on their
    plain versions (B1's backward where the gradient reaches it: not for
    the imaging readout's noise, whose parameters are constants)."""
    _, pcfg = _wcfgs(name, "rma_arar_arar", h=2)
    data = get_problem(name).make_reference_data(
        torch.Generator().manual_seed(99), 500, device="cpu")
    for c in (icdf_counts, mask_counts, blur_counts):
        c.reset()
    state, hist = workflow.train_stacked(0, pcfg, 2, 2, 3, data,
                                         device="cpu")
    image = get_problem(name).param_shape is not None
    assert (icdf_counts.launches, icdf_counts.plain_calls,
            icdf_counts.backward_plain) == (0, 3, 0 if image else 3)
    assert (mask_counts.plain_calls, mask_counts.backward_plain) == (
        (3, 3) if name == "imaging" else (0, 0))
    assert (blur_counts.plain_calls, blur_counts.backward_plain) == (
        (3, 3) if name == "imaging_blur" else (0, 0))
    for path, leaf in tree_paths(state):
        assert bool(torch.isfinite(leaf.float()).all()), path
    assert bool(torch.isfinite(hist["d_loss"]).all())


# ----------------------------------------------------------------------------
# the solve


@pytest.mark.parametrize("name", FLAT)
def test_solver_matches_jax(name):
    """A 2-rank stack, a tiny SolveConfig and JAX's solve draws, as
    tests/test_torch_serving.py::test_solver_matches_jax does for proxy1d
    at the presets: candidates and scores
    at fp32 tolerance, kept sets equal up to near-ties, and the estimate
    of each request whose kept set is the same."""
    p, j = get_problem(name), jax_get_problem(name)
    cfg, R = workflow.SolveConfig(n_candidates=32, events_per_candidate=16,
                                  top_frac=0.25), 2
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        JG.init_generator(k, n_params=j.n_params) for k in keys])
    key, reqs = jax.random.PRNGKey(5), []
    for n in (40, 100, 200):
        key, k = jax.random.split(key)
        reqs.append(np.asarray(j.make_reference_data(k, n)))
    ys = np.zeros((len(reqs), 256, p.obs_dim), np.float32)
    mask = np.zeros((len(reqs), 256), bool)
    for i, y in enumerate(reqs):
        ys[i, :len(y)], mask[i, :len(y)] = y, True
    jcfg = _jax_cfg(cfg)
    out_j = jax.jit(JW.make_solver(j, jcfg))(jstack, jnp.asarray(ys),
                                             jnp.asarray(mask))
    cands_j, scores_j = jax.jit(_jax_scores, static_argnums=(0, 1))(
        j, jcfg, jstack, jnp.asarray(ys), jnp.asarray(mask))
    solver = workflow.make_solver(p, cfg, _jax_draws(cfg, R,
                                                     p.noise_channels))
    stack = tree_map(_t, jstack)
    cands, scores = solver.scores(stack, _t(ys), _t(mask))
    np.testing.assert_allclose(_np(cands), np.asarray(cands_j), **FP32)
    np.testing.assert_allclose(_np(scores), np.asarray(scores_j), **FP32)
    out = solver(stack, _t(ys), _t(mask))
    k = solver.keep(R)
    idx = torch.topk(scores, k, dim=1).indices.numpy()
    idx_j = np.asarray(jax.lax.top_k(scores_j, k)[1])
    scores_j = np.asarray(scores_j)
    same = []
    for b in range(len(reqs)):
        diff = set(idx[b].tolist()) ^ set(idx_j[b].tolist())
        cut = np.sort(scores_j[b])[::-1][k - 1]
        assert all(abs(scores_j[b, i] - cut) < TIE_GAP for i in diff), b
        if not diff:
            same.append(b)
    assert same
    for key_ in ("params", "sigma", "score"):
        np.testing.assert_allclose(_np(out[key_])[same],
                                   np.asarray(out_j[key_])[same], **FP32)


# ----------------------------------------------------------------------------
# checkpoints and the CLI


def test_proxy2d_checkpoint_read_by_jax_and_served_by_both(tmp_path):
    _, pcfg = _wcfgs("proxy2d")
    data = get_problem("proxy2d").make_reference_data(
        torch.Generator().manual_seed(99), 1_000, device="cpu")
    state, _ = workflow.train_stacked(1, pcfg, 2, 2, 2, data,
                                      checkpoint_every=2,
                                      checkpoint_dir=str(tmp_path),
                                      device="cpu")
    jcfg, _ = _wcfgs("proxy2d")
    like = JW.init_state(jax.random.PRNGKey(0), 4, jcfg)
    restored, step = jax_restore_latest(str(tmp_path), like)
    assert step == 2
    flat, got = jax_flatten(restored), dict(tree_paths(state))
    for k, want in jax_flatten(like).items():
        if k != "rng":
            assert flat[k].shape == want.shape == tuple(got[k].shape), k
            np.testing.assert_array_equal(np.asarray(flat[k]), _np(got[k]))
    pstack, _ = load_generator_stack(str(tmp_path), "cpu")
    jstack, _ = jax_load_stack(str(tmp_path), jax_get_problem("proxy2d"))
    for a, b in zip(tree_leaves(pstack), jax.tree.leaves(jstack)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    from repro.configs.serving import REDUCED as JAX_REDUCED
    from repro.serving import SolveService as JaxSolveService
    from repro_torch.configs.serving import REDUCED
    from repro_torch.serving import SolveService
    y = _np(data[:40])
    for svc in (SolveService(REDUCED, device="cpu"),
                JaxSolveService(JAX_REDUCED)):
        svc.register_problem("proxy2d", checkpoint_dir=str(tmp_path))
        ticket = svc.submit("proxy2d", y)
        svc.run_until_empty()
        params = np.asarray(ticket.result()["params"])
        assert params.shape == (10,) and ((params > 0) & (params < 1)).all()


def test_imaging_checkpoint_restored_by_jax_and_resumed_bitwise(tmp_path):
    """The port's imaging store holds the JAX keys (gen/convs/0/w, ...,
    gen/proj/b, HWIO conv weights) and JAX's reader restores it into its
    conv template; a resume from it is bitwise the uninterrupted run."""
    _, pcfg = _wcfgs("imaging", h=2)
    data = get_problem("imaging").make_reference_data(
        torch.Generator().manual_seed(99), 500, device="cpu")
    full, fh = workflow.train_stacked(2, pcfg, 2, 2, 4, data,
                                      checkpoint_every=2, device="cpu")
    part = str(tmp_path / "run")
    half, _ = workflow.train_stacked(2, pcfg, 2, 2, 2, data,
                                     checkpoint_every=2,
                                     checkpoint_dir=part, device="cpu")
    jcfg, _ = _wcfgs("imaging", h=2)
    like = JW.init_state(jax.random.PRNGKey(0), 4, jcfg)
    restored, step = jax_restore_latest(part, like)
    assert step == 2
    flat, got = jax_flatten(restored), dict(tree_paths(half))
    assert "gen/convs/0/w" in got and "gen/proj/b" in got
    assert got["gen/convs/0/w"].shape == (4, 3, 3, 32, 32)
    for k, want in jax_flatten(like).items():
        if k != "rng":
            assert flat[k].shape == want.shape == tuple(got[k].shape), k
            np.testing.assert_array_equal(np.asarray(flat[k]), _np(got[k]))
    resumed, rh = workflow.train_stacked(2, pcfg, 2, 2, 4, data,
                                         checkpoint_every=2,
                                         checkpoint_dir=part, resume=True,
                                         device="cpu")
    for (k, a), b in zip(tree_paths(resumed), tree_leaves(full)):
        assert torch.equal(a, b), k
    assert torch.equal(rh["d_loss"], fh["d_loss"][-2:])      # epochs 2, 3


@pytest.mark.parametrize("name", ["proxy2d", "imaging_blur"])
def test_train_gan_cli_on_the_cpu(name, capsys):
    from repro_torch.launch import train_gan
    train_gan.main(["--device", "cpu", "--problem", name, "--ranks", "4",
                    "--epochs", "4", "--events", "2000", "--param-samples",
                    "8"])
    out = capsys.readouterr().out
    assert f"problem={name}" in out
    if name == "imaging_blur":
        assert "0 kernel launches, 4 plain calls, 0 backward passes" in out
        assert "blur (B3): 0 kernel launches, 4 plain calls, 4 backward" \
            in out
        assert "1024 pixels" in out
    else:
        assert "0 kernel launches, 4 plain calls, 4 backward passes" in out
        assert "p9:" in out
    assert "serving-path solve" in out
