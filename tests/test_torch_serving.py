"""The port's proxy1d solve service against the JAX package, on the CPU.

Layer by layer, the same inputs go through `repro` and `repro_torch`:

  forward model   `sample_events` (both JAX sampler routes), residuals
  generator       a JAX `init_generator` stack carried over through numpy
                  and `generator_from_numpy` (rtol 1e-5)
  solver          `make_solver` for REDUCED and DEFAULT at R=2, with the
                  JAX draws rebuilt from the key splits of
                  `repro/core/workflow.py` (lines 264–280) and handed to
                  the port; params, sigma and score at rtol 1e-4 /
                  atol 1e-5, and equal kept sets up to near-ties
  service         `SolveService` of both packages on the same stack,
                  requests and draws; the port's copies of the bucket,
                  cache, queue and counter layers on the cases of
                  tests/test_serving.py and tests/test_obs.py
  checkpoint      a JAX `save_checkpoint` with a bf16 leaf, read bitwise

TF32 is switched off for the whole module (it only matters on a card,
where a float32 matmul may otherwise run in TF32).
"""
import threading

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.analysis.faults import InterleavingDriver
from repro.checkpoint.store import save_checkpoint
from repro.core import gan as jax_gan
from repro.core import pipeline as jax_pipeline
from repro.core import residuals as jax_residuals
from repro.core import workflow as jax_workflow
from repro.problems import get_problem as jax_get_problem
from repro.serving import SolveService as JaxSolveService
from repro.serving import ServingConfig as JaxServingConfig

from repro_torch.checkpoint.store import (generator_from_numpy,
                                          load_generator_stack, widen_bf16)
from repro_torch.configs import serving as torch_presets
from repro_torch.core import gan, pipeline, residuals, workflow
from repro_torch.kernels.inverse_cdf import counts
from repro_torch.launch import serve as serve_cli
from repro_torch.obs.counters import Counters, LatencyHistogram
from repro_torch.problems import available, get_problem
from repro_torch.serving import (Backpressure, BoundedRequestQueue,
                                 CompileCache, RequestTooLarge, ServingConfig,
                                 ServingError, SolveService, bucket_for,
                                 make_buckets, pad_events)
from repro_torch.serving import queue as serving_queue
from repro_torch.serving import service as service_mod
from repro_torch.serving.bucketing import validate_buckets

FP32 = dict(rtol=1e-4, atol=1e-5)
TIE_GAP = 1e-5          # kept sets may differ only within this of the cut
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    """fp32 matmuls in full fp32 (TF32 off), restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _jax_stack(ranks=2, seed=0, n_params=6):
    keys = jax.random.split(jax.random.PRNGKey(seed), ranks)
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jax_gan.init_generator(k, n_params=n_params)
                          for k in keys])


def _port_stack(jstack):
    """The JAX stack carried over the way a checkpoint carries it."""
    flat = {f"{i}/{leaf}": np.asarray(layer[leaf])
            for i, layer in enumerate(jstack) for leaf in ("w", "b")}
    return generator_from_numpy(flat, CPU)


def _jax_draws(cfg, R, C):
    """The JAX solver's draws, by its key splits (workflow.py:264-280)."""
    key = jax.random.PRNGKey(cfg.seed)
    k_noise, k_u = jax.random.split(key)
    noise = jax.random.normal(k_noise, (R, cfg.n_candidates,
                                        jax_gan.NOISE_DIM))
    u = jax.random.uniform(k_u, (R * cfg.n_candidates,
                                 cfg.events_per_candidate, C))
    return (torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(u)))


def _jax_cfg(cfg, impl="jnp"):
    return jax_workflow.SolveConfig(
        n_candidates=cfg.n_candidates,
        events_per_candidate=cfg.events_per_candidate, top_frac=cfg.top_frac,
        seed=cfg.seed, sampler_impl=impl,
        sampler_interpret=True if impl == "pallas" else None)


def _jax_scores(prob, jcfg, jstack, ys, mask):
    """The JAX solver's candidate scores [B, R·M], computed step by step
    as `repro.core.workflow.make_solver` does; the caller checks that they
    reproduce its output before trusting them for the kept sets."""
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


def _requests(prob_jax, sizes, seed=5):
    out = []
    key = jax.random.PRNGKey(seed)
    for n in sizes:
        key, k = jax.random.split(key)
        out.append(np.asarray(prob_jax.make_reference_data(k, n)))
    return out


def _batch(ys_list, bucket):
    B = len(ys_list)
    ys = np.zeros((B, bucket, 2), np.float32)
    mask = np.zeros((B, bucket), bool)
    for i, y in enumerate(ys_list):
        ys[i], mask[i] = pad_events(y, bucket)
    return ys, mask


# ----------------------------------------------------------------------------
# forward model and residuals


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("K,E", [(5, 7), (130, 33)])
def test_sample_events_matches_jax(K, E, impl):
    rng = np.random.default_rng(K + E)
    params = rng.uniform(0.01, 0.99, (K, 6)).astype(np.float32)
    u = rng.uniform(size=(K, E, 2)).astype(np.float32)
    y = pipeline.sample_events(torch.from_numpy(params), torch.from_numpy(u))
    y_jax = jax_pipeline.sample_events(params, u, impl=impl, interpret=True)
    assert y.shape == (K * E, 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **FP32)


def test_problem_constants_match_jax():
    prob, jprob = get_problem("proxy1d"), jax_get_problem("proxy1d")
    assert available() == ("imaging", "imaging_blur", "linear_blur",
                           "proxy1d", "proxy2d")
    for attr in ("n_params", "obs_dim", "noise_channels",
                 "events_per_sample", "solve_threshold", "param_shape"):
        assert getattr(prob, attr) == getattr(jprob, attr), attr
    np.testing.assert_array_equal(prob.true_params(CPU).numpy(),
                                  np.asarray(jprob.true_params()))
    for name in ("_MU_RANGE", "_S_RANGE", "_K_RANGE", "EVENTS_PER_SAMPLE",
                 "PARAM_SAMPLES", "N_PARAMS"):
        assert getattr(pipeline, name) == getattr(jax_pipeline, name), name


def test_make_reference_data_shape_and_truth():
    """Different random streams, the same distribution: the port's and
    JAX's reference data agree in their moments."""
    n = 20000
    y = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(0), n, device=CPU).numpy()
    y_jax = np.asarray(jax_pipeline.make_reference_data(
        jax.random.PRNGKey(0), n))
    assert y.shape == (n, 2) and y.dtype == np.float32
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y.mean(0), y_jax.mean(0), atol=0.05)
    np.testing.assert_allclose(y.std(0), y_jax.std(0), rtol=0.05)


def test_residuals_match_jax_including_the_clamp():
    truth = np.array([0.35, 0.0, -1e-8, 3e-7, -0.2, 1e-6], np.float32)
    pred = np.random.default_rng(0).uniform(size=(4, 6)).astype(np.float32)
    r = residuals.normalized_residuals(torch.from_numpy(pred),
                                       torch.from_numpy(truth))
    r_jax = jax_residuals.normalized_residuals(pred, truth)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_jax))
    assert np.isfinite(r.numpy()).all()
    default = residuals.mean_abs_residual(torch.from_numpy(pred))
    np.testing.assert_allclose(
        float(default), float(jax_residuals.mean_abs_residual(pred)),
        rtol=1e-6)


# ----------------------------------------------------------------------------
# generator


def test_paper_exact_generator_widths():
    g = torch.Generator().manual_seed(0)
    one = gan.init_generator(g, device=CPU)
    assert gan.GEN_WIDTHS == jax_gan.GEN_WIDTHS and gan.LEAK == jax_gan.LEAK
    assert gan.param_count(one) == 51206
    stack = gan.init_generator(g, ranks=16, device=CPU)
    assert gan.param_count(stack) == 16 * 51206
    w0 = stack[0]["w"]
    assert w0.shape == (16, 135, 128)
    # Kaiming normal: std sqrt(2 / fan_in), zero bias
    assert abs(float(w0.std()) - (2.0 / 135) ** 0.5) < 0.01
    assert all(float(layer["b"].abs().max()) == 0.0 for layer in stack)


def test_generator_stack_carried_over_matches_jax():
    jstack = _jax_stack(ranks=3)
    noise = np.random.default_rng(1).standard_normal(
        (3, 10, jax_gan.NOISE_DIM)).astype(np.float32)
    p = gan.generate_params(_port_stack(jstack), torch.from_numpy(noise))
    p_jax = jax.vmap(jax_gan.generate_params)(jstack, noise)
    assert p.shape == (3, 10, 6)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), rtol=1e-5)


# ----------------------------------------------------------------------------
# solver


def test_solve_draws_shapes_and_seed():
    cfg = torch_presets.REDUCED.solve
    prob = get_problem("proxy1d")
    noise, u = workflow.solve_draws(cfg, 3, prob, CPU)
    assert noise.shape == (3, cfg.n_candidates, gan.NOISE_DIM)
    assert u.shape == (3 * cfg.n_candidates, cfg.events_per_candidate, 2)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    again = workflow.solve_draws(cfg, 3, prob, CPU)
    assert torch.equal(noise, again[0]) and torch.equal(u, again[1])
    with pytest.raises(ValueError):
        workflow.SolveConfig(top_frac=0.0)
    with pytest.raises(ValueError):
        workflow.SolveConfig(n_candidates=0)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("preset", ["REDUCED", "DEFAULT"])
def test_solver_matches_jax(preset, impl):
    """R=2 stack, JAX's own draws handed to the port; the JAX solver runs
    with the jnp sampler and with the Pallas one (interpret mode)."""
    cfg = getattr(torch_presets, preset)
    R, bucket = 2, cfg.buckets[-1]
    prob, jprob = get_problem("proxy1d"), jax_get_problem("proxy1d")
    jstack = _jax_stack(R, seed=3)
    reqs = _requests(jprob, np.linspace(2, bucket, cfg.max_batch).astype(int))
    ys, mask = _batch(reqs, bucket)
    jcfg = _jax_cfg(cfg.solve, impl)

    solver = workflow.make_solver(prob, cfg.solve,
                                  _jax_draws(cfg.solve, R, 2))
    stack = _port_stack(jstack)
    ys_t, mask_t = torch.from_numpy(ys), torch.from_numpy(mask)
    out = solver(stack, ys_t, mask_t)
    out_jax = jax.jit(jax_workflow.make_solver(jprob, jcfg))(
        jstack, jnp.asarray(ys), jnp.asarray(mask))

    # kept sets: the JAX scores, checked against the JAX solver's output
    k = solver.keep(R)
    assert k == max(1, int(round(cfg.solve.top_frac * R
                                 * cfg.solve.n_candidates)))
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
    assert out["params"].shape == (len(reqs), 6)


def test_padding_masked_out_of_results():
    """The same observations in two buckets, with garbage in the padding
    rows, give identical results."""
    prob = get_problem("proxy1d")
    cfg = workflow.SolveConfig(n_candidates=8, events_per_candidate=8)
    solver = workflow.make_solver(prob, cfg,
                                  workflow.solve_draws(cfg, 2, prob, CPU))
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=2,
                               device=CPU)
    y = prob.make_reference_data(torch.Generator().manual_seed(3), 10,
                                 device=CPU).numpy()
    outs = []
    for bucket, fill in ((16, 0.0), (64, 123.456)):
        padded, mask = pad_events(y, bucket)
        padded[~mask] = fill
        outs.append(solver(stack, torch.from_numpy(padded[None]),
                           torch.from_numpy(mask[None])))
    np.testing.assert_allclose(outs[0]["params"], outs[1]["params"],
                               rtol=1e-6)
    np.testing.assert_allclose(outs[0]["score"], outs[1]["score"], rtol=1e-5)


def test_top_frac_one_is_prior_mean():
    prob = get_problem("proxy1d")
    cfg = workflow.SolveConfig(n_candidates=8, events_per_candidate=8,
                               top_frac=1.0)
    solver = workflow.make_solver(prob, cfg,
                                  workflow.solve_draws(cfg, 2, prob, CPU))
    stack = gan.init_generator(torch.Generator().manual_seed(0), ranks=2,
                               device=CPU)
    outs = []
    for seed in (1, 2):
        y = prob.make_reference_data(torch.Generator().manual_seed(seed), 12,
                                     device=CPU).numpy()
        padded, mask = pad_events(y, 16)
        outs.append(solver(stack, torch.from_numpy(padded[None]),
                           torch.from_numpy(mask[None]))["params"])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


# ----------------------------------------------------------------------------
# service


def _tiny_cfg(max_batch=4):
    return ServingConfig(
        buckets=(16, 64), max_batch=max_batch, queue_capacity=16,
        cache_capacity=4, retry_after_s=0.01,
        solve=workflow.SolveConfig(n_candidates=8, events_per_candidate=8))


def _prior(ranks=2, seed=0):
    return gan.init_generator(torch.Generator().manual_seed(seed),
                              ranks=ranks, device=CPU)


def _ref_data(n, seed):
    return get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(seed), n, device=CPU).numpy()


def _inject_jax_draws(monkeypatch):
    monkeypatch.setattr(service_mod, "solve_draws",
                        lambda cfg, R, problem, device: tuple(
                            t.to(device) for t in
                            _jax_draws(cfg, R, problem.noise_channels)))


@pytest.mark.parametrize("preset", ["REDUCED", "DEFAULT"])
def test_service_matches_jax_service(preset, monkeypatch):
    """Both services, the same stack, requests and draws: every ticket's
    params, sigma and score agree; queue and cache stats are equal."""
    _inject_jax_draws(monkeypatch)
    cfg = getattr(torch_presets, preset)
    jcfg = JaxServingConfig(
        buckets=cfg.buckets, max_batch=cfg.max_batch,
        queue_capacity=cfg.queue_capacity, cache_capacity=cfg.cache_capacity,
        retry_after_s=cfg.retry_after_s, solve=_jax_cfg(cfg.solve))
    jprob = jax_get_problem("proxy1d")
    jstack = _jax_stack(2, seed=7)
    sizes = [3, cfg.buckets[0], cfg.buckets[0] + 1, cfg.buckets[-1], 5, 9]
    reqs = _requests(jprob, sizes, seed=11)

    svc = SolveService(cfg, device=CPU)
    svc.register_problem("proxy1d", gen_stack=_port_stack(jstack))
    jsvc = JaxSolveService(jcfg)
    jsvc.register_problem("proxy1d", gen_stack=jstack)
    tickets = [svc.submit("proxy1d", y) for y in reqs]
    jtickets = [jsvc.submit("proxy1d", y) for y in reqs]
    assert svc.run_until_empty() == jsvc.run_until_empty() == len(reqs)
    for t, jt in zip(tickets, jtickets):
        assert t.bucket == jt.bucket
        for key in ("params", "sigma", "score"):
            np.testing.assert_allclose(t.result()[key], jt.result()[key],
                                       **FP32)
    s, js = svc.stats(), jsvc.stats()
    assert s["queue"] == js["queue"] and s["cache"] == js["cache"]
    assert s["warm"] == js["warm"] and s["served"] == js["served"]


def test_service_matches_direct_solver():
    prob = get_problem("proxy1d")
    cfg = _tiny_cfg()
    svc = SolveService(cfg, device=CPU)
    stack = _prior()
    svc.register_problem("proxy1d", gen_stack=stack)
    y = _ref_data(12, 5)
    ticket = svc.submit("proxy1d", y)
    assert svc.run_until_empty() == 1
    via_service = ticket.result(timeout=30)
    solver = workflow.make_solver(prob, cfg.solve,
                                  workflow.solve_draws(cfg.solve, 2, prob, CPU))
    padded, mask = pad_events(y, ticket.bucket)
    direct = solver(stack, torch.from_numpy(padded[None]),
                    torch.from_numpy(mask[None]))
    np.testing.assert_allclose(via_service["params"], direct["params"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(via_service["sigma"], direct["sigma"][0],
                               rtol=1e-5)


def test_service_batches_share_one_executable():
    svc = SolveService(_tiny_cfg(max_batch=4), device=CPU)
    svc.register_problem("proxy1d", gen_stack=_prior())
    small = [_ref_data(8 + i, i) for i in range(6)]   # all in bucket 16
    big = _ref_data(40, 9)                              # bucket 64
    counts.reset()
    tickets = [svc.submit("proxy1d", y) for y in small]
    t_big = svc.submit("proxy1d", big)
    assert svc.run_until_empty() == 7
    for t in tickets + [t_big]:
        assert t.done() and np.isfinite(t.result()["params"]).all()
    stats = svc.stats()
    assert stats["cache"]["compiles"] == 2       # one per touched bucket
    assert stats["queue"]["drained"] == 7 and svc.served == 7
    # one sampler call per build (dummy batch) and per drained batch:
    # 2 builds + 2 bucket-16 drains + 1 bucket-64 drain, all plain on CPU
    assert counts.plain_calls == 5 and counts.launches == 0


def test_service_snapshot_rates_and_latency_lanes():
    svc = SolveService(_tiny_cfg(), device=CPU)
    svc.register_problem("proxy1d", gen_stack=_prior())

    def wave(n):
        for i in range(n):
            svc.submit("proxy1d", _ref_data(12, 100 * n + i))
        svc.run_until_empty()

    wave(2)                                  # cold: cache miss
    wave(1)                                  # warm: hit
    snap = svc.snapshot()
    assert snap["served"] == 3 and snap["queue_depth"] == 0
    assert snap["reject_rate"] == 0.0
    assert snap["retry_after_s"] == pytest.approx(0.01)
    assert snap["cache_hit_rate"] == pytest.approx(0.5)
    assert snap["counters"]["queue.admitted"] == 3
    assert snap["counters"]["queue.drained"] == 3
    lane = snap["latency"]["proxy1d/b16"]
    assert lane["count"] == 3 and lane["p50_s"] > 0 and lane["mean_s"] > 0


def test_missing_checkpoint_clear_error(tmp_path):
    svc = SolveService(_tiny_cfg(), device=CPU)
    with pytest.raises(ServingError) as ei:
        svc.register_problem("proxy1d", checkpoint_dir=str(tmp_path))
    msg = str(ei.value)
    assert "proxy1d" in msg and str(tmp_path) in msg
    assert "train" in msg.lower()


def test_unknown_or_unregistered_problem_clear_error():
    svc = SolveService(_tiny_cfg(), device=CPU)
    with pytest.raises(ServingError):
        svc.register_problem("no_such_problem", gen_stack=[])
    with pytest.raises(ServingError) as ei:
        svc.submit("proxy1d", np.zeros((4, 2), np.float32))
    assert "register_problem" in str(ei.value)
    svc.register_problem("proxy1d", gen_stack=_prior())
    with pytest.raises(ServingError):            # wrong obs_dim
        svc.submit("proxy1d", np.zeros((4, 3), np.float32))
    with pytest.raises(RequestTooLarge):
        svc.submit("proxy1d", np.zeros((65, 2), np.float32))
    with pytest.raises(ServingError, match="135 -> 6"):   # wrong widths
        svc.register_problem("proxy1d", gen_stack=gan.init_generator(
            torch.Generator().manual_seed(0), n_params=5, ranks=2,
            device=CPU))


def test_service_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert SolveService(_tiny_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SolveService(_tiny_cfg())


def test_serve_cli_on_cpu(capsys):
    svc = serve_cli.main(["--problem", "proxy1d", "--preset", "reduced",
                          "--warm", "--stats", "--device", "cpu",
                          "--requests", "4"])
    out = capsys.readouterr().out
    assert svc.served == 4 and "[stats] latency" in out
    assert "0 kernel launches" in out


# ----------------------------------------------------------------------------
# the port's copies of the bucket, cache, queue and counter layers


def test_bucket_for_smallest_admitting():
    ladder = (16, 64, 256)
    assert bucket_for(1, ladder) == 16
    assert bucket_for(16, ladder) == 16
    assert bucket_for(17, ladder) == 64
    assert bucket_for(64, ladder) == 64
    assert bucket_for(65, ladder) == 256
    assert bucket_for(256, ladder) == 256
    with pytest.raises(RequestTooLarge):
        bucket_for(257, ladder)
    with pytest.raises(ValueError):
        bucket_for(0, ladder)


def test_make_and_validate_buckets():
    assert make_buckets(1000, base=64, growth=4) == (64, 256, 1024)
    assert make_buckets(64, base=64, growth=4) == (64,)
    for bad in ((), (0, 4), (4, 4), (64, 16)):
        with pytest.raises(ValueError):
            validate_buckets(bad)


def test_bucket_assignment_every_size():
    """Every n <= max(buckets) lands in exactly one bucket, the smallest
    admitting one."""
    ladder = (16, 64, 256, 1024)
    for n in range(1, 1025):
        b = bucket_for(n, ladder)
        assert b == [x for x in ladder if n <= x][0]
        assert all(n > x for x in ladder if x < b)


def test_pad_events_shapes_and_mask():
    y = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, mask = pad_events(y, 16)
    assert padded.shape == (16, 2) and mask.shape == (16,)
    assert mask.sum() == 5 and mask[:5].all() and not mask[5:].any()
    np.testing.assert_array_equal(padded[:5], y)
    with pytest.raises(ValueError):
        pad_events(y, 4)


def test_cache_lru_eviction_order():
    c = CompileCache(capacity=2)
    build = lambda tag: (lambda: tag)
    assert c.get("a", build("A")) == "A"
    assert c.get("b", build("B")) == "B"
    assert c.keys() == ["a", "b"]
    c.get("c", build("C"))
    assert "a" not in c and "b" in c and "c" in c
    assert c.stats["evictions"] == 1
    assert c.get("a", build("A2")) == "A2"
    assert "b" not in c
    assert c.stats["compiles"] == 4


def test_cache_hit_refreshes_recency():
    c = CompileCache(capacity=2)
    c.get("a", lambda: 1)
    c.get("b", lambda: 2)
    c.get("a", lambda: 99)
    assert c.get("a", lambda: 99) == 1
    c.get("c", lambda: 3)
    assert c.keys() == ["a", "c"] and "b" not in c
    assert c.stats["hits"] == 2


def test_cache_capacity_one():
    c = CompileCache(capacity=1)
    assert c.get("a", lambda: 1) == 1
    assert c.get("b", lambda: 2) == 2
    assert len(c) == 1 and "a" not in c
    assert c.get("a", lambda: 10) == 10
    assert c.stats == {"hits": 0, "misses": 3, "compiles": 3,
                       "evictions": 2}
    with pytest.raises(ValueError):
        CompileCache(capacity=0)


def test_queue_full_rejects_not_blocks():
    q = BoundedRequestQueue(capacity=2, retry_after_s=0.25)
    q.submit(("p", 16), "r0")
    q.submit(("p", 64), "r1")
    with pytest.raises(Backpressure) as ei:
        q.submit(("p", 16), "r2")
    assert ei.value.retry_after_s == 0.25
    assert len(q) == 2 and q.stats["rejected"] == 1
    assert q.drain(("p", 16), 8) == ["r0"]
    q.submit(("p", 16), "r2")
    assert len(q) == 2


def test_queue_fifo_per_lane_after_drain():
    q = BoundedRequestQueue(capacity=16)
    for i in range(3):
        q.submit(("p", 16), f"a{i}")
        q.submit(("p", 64), f"b{i}")
    assert q.next_key() == ("p", 16)
    assert q.drain(("p", 16), 2) == ["a0", "a1"]
    assert q.next_key() == ("p", 64)
    assert q.drain(("p", 64), 8) == ["b0", "b1", "b2"]
    assert q.drain(("p", 16), 8) == ["a2"]
    assert q.next_key() is None and len(q) == 0


def test_concurrent_submitters_one_drainer_exactly_once():
    q = BoundedRequestQueue(capacity=8, retry_after_s=0.001)
    n_sub, per = 4, 25
    served, lock = [], threading.Lock()
    stop = threading.Event()

    def submitter(tid):
        for i in range(per):
            while True:
                try:
                    q.submit(("p", 16), (tid, i))
                    break
                except Backpressure as e:
                    stop.wait(e.retry_after_s)

    def drainer():
        while not stop.is_set() or len(q):
            batch = q.drain(("p", 16), 4)
            if batch:
                with lock:
                    served.extend(batch)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_sub)]
    d = threading.Thread(target=drainer)
    d.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "submitter deadlocked"
    stop.set()
    d.join(timeout=30)
    assert not d.is_alive(), "drainer deadlocked"
    assert sorted(served) == sorted((t, i) for t in range(n_sub)
                                    for i in range(per))
    assert q.stats["admitted"] == q.stats["drained"] == n_sub * per


def test_gated_interleaving_no_drop_or_double_serve():
    q = BoundedRequestQueue(capacity=8)
    with InterleavingDriver(set_hook=serving_queue.set_hook) as drv:
        gate = drv.gate("queue.submit", hit=2)
        q.submit(("p", 16), "first")
        victim_done = threading.Event()

        def victim():
            q.submit(("p", 16), "second")
            victim_done.set()

        t = threading.Thread(target=victim)
        t.start()
        gate.wait_reached()
        assert q.drain(("p", 16), 8) == ["first"]
        assert len(q) == 0
        gate.release()
        t.join(timeout=20)
        assert victim_done.is_set(), "parked submitter never completed"
        assert q.drain(("p", 16), 8) == ["second"]
        assert q.stats["admitted"] == 2 and q.stats["drained"] == 2


def test_gated_drainers_never_split_a_drain():
    q = BoundedRequestQueue(capacity=16)
    for i in range(6):
        q.submit(("p", 16), i)
    got = {}
    with InterleavingDriver(set_hook=serving_queue.set_hook) as drv:
        gate = drv.gate("queue.drain", hit=1)

        def drainer(name):
            got[name] = q.drain(("p", 16), 4)

        a = threading.Thread(target=drainer, args=("a",))
        a.start()
        gate.wait_reached()
        drainer("b")
        gate.release()
        a.join(timeout=20)
        assert not a.is_alive()
    assert sorted(got["a"] + got["b"]) == list(range(6))
    assert len(got["a"]) == 4 and len(got["b"]) == 2


def test_queue_reject_recorded_before_raise_under_gate():
    c = Counters()
    q = BoundedRequestQueue(1, retry_after_s=0.01, counters=c)
    q.submit(("p", 16), "fill")
    with InterleavingDriver(set_hook=serving_queue.set_hook) as drv:
        gate = drv.gate("queue.reject", hit=1)
        res = {}

        def victim():
            try:
                q.submit(("p", 16), "one-too-many")
            except Backpressure as e:
                res["retry_after"] = e.retry_after_s

        t = threading.Thread(target=victim)
        t.start()
        gate.wait_reached()                  # parked pre-raise
        assert q.stats["rejected"] == 1
        assert c.get("queue.rejected") == 1
        gate.release()
        t.join(timeout=20)
        assert not t.is_alive() and res["retry_after"] == 0.01


def test_latency_histogram_snapshot_fields():
    h = LatencyHistogram()
    for v in (0.001, 0.001, 0.002, 0.1):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 4
    assert snap["sum_s"] == pytest.approx(0.104)
    assert 0 < snap["p50_s"] <= snap["p90_s"] <= snap["p99_s"]
    assert snap["p99_s"] >= 0.1
    assert LatencyHistogram().snapshot()["p50_s"] == 0.0


def test_counters_inc_observe_snapshot():
    c = Counters()
    c.inc("a")
    c.inc("a", 2)
    c.observe("lane", 0.01)
    snap = c.snapshot()
    assert snap["counters"] == {"a": 3} and c.get("a") == 3
    assert snap["latency"]["lane"]["count"] == 1
    assert c.get("missing") == 0


# ----------------------------------------------------------------------------
# checkpoints: JAX writes, the port reads


def test_jax_checkpoint_loads_bitwise_with_a_bf16_leaf(tmp_path):
    jstack = _jax_stack(2, seed=4)
    jstack[1]["w"] = jstack[1]["w"].astype(jnp.bfloat16)
    save_checkpoint(str(tmp_path), 7, {"gen": jstack, "disc": _jax_stack(1),
                                       "epoch": jnp.int32(7)},
                    metadata={"problem": "proxy1d"})
    stack, step = load_generator_stack(str(tmp_path), CPU)
    assert step == 7 and len(stack) == len(jstack)
    for layer, jlayer in zip(stack, jstack):
        for leaf in ("w", "b"):
            want = np.asarray(jlayer[leaf].astype(jnp.float32))
            got = layer[leaf].numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
    bits = np.array([0x3F80, 0xC000, 0x0001, 0x7F80], np.uint16)
    np.testing.assert_array_equal(widen_bf16(bits)[:2], [1.0, -2.0])
    assert np.isinf(widen_bf16(bits)[3])


def test_corrupt_newest_step_skipped_with_warning(tmp_path):
    jstack = _jax_stack(2)
    save_checkpoint(str(tmp_path), 1, {"gen": jstack})
    save_checkpoint(str(tmp_path), 2, {"gen": jstack})
    npz = tmp_path / "step_00000002" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:1000])    # killed mid-save
    with pytest.warns(UserWarning, match="step_2"):
        stack, step = load_generator_stack(str(tmp_path), CPU)
    assert step == 1 and stack[0]["w"].shape == (2, 135, 128)
    assert load_generator_stack(str(tmp_path / "empty"), CPU) == (None, None)


def test_structural_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"disc": _jax_stack(1)})
    with pytest.raises(KeyError, match="no generator"):
        load_generator_stack(str(tmp_path), CPU)
    one = jax_gan.init_generator(jax.random.PRNGKey(0))      # not stacked
    flat = {f"{i}/{leaf}": np.asarray(layer[leaf])
            for i, layer in enumerate(one) for leaf in ("w", "b")}
    with pytest.raises(ValueError, match="stacked"):
        generator_from_numpy(flat, CPU)
    del flat["1/b"]
    with pytest.raises(ValueError, match="leaves"):
        generator_from_numpy(flat, CPU)
    svc = SolveService(_tiny_cfg(), device=CPU)
    with pytest.raises(ServingError, match="unusable"):
        svc.register_problem("proxy1d", checkpoint_dir=str(tmp_path))


def test_trained_jax_checkpoint_served_by_the_port(tmp_path, monkeypatch):
    """A generator stack trained by the JAX package, saved to its store,
    served by the port: under the problem's residual bar, and equal to the
    JAX service's answer on the same draws."""
    from repro.core.sync import SyncConfig
    _inject_jax_draws(monkeypatch)
    jprob = jax_get_problem("proxy1d")
    wcfg = jax_workflow.WorkflowConfig(
        sync=SyncConfig(mode="rma_arar_arar", h=10), n_param_samples=16,
        events_per_sample=8, gen_lr=2e-4, disc_lr=5e-4)
    data = jprob.make_reference_data(jax.random.PRNGKey(99), 2000)
    state, _ = jax_workflow.train_vmap(jax.random.PRNGKey(0), wcfg, 2, 2,
                                       300, data, chunk=100)
    save_checkpoint(str(tmp_path), 300, {"gen": state["gen"]})
    cfg = ServingConfig(buckets=(64,), max_batch=2, queue_capacity=8,
                        cache_capacity=2, solve=workflow.SolveConfig(
                            n_candidates=32, events_per_candidate=16))
    svc = SolveService(cfg, device=CPU)
    assert svc.register_problem("proxy1d",
                                checkpoint_dir=str(tmp_path)) == 300
    ticket = svc.submit("proxy1d", np.asarray(data[:64]))
    assert svc.run_until_empty() == 1
    out = ticket.result(timeout=60)
    prob = get_problem("proxy1d")
    residual = float(prob.mean_abs_residual(torch.from_numpy(out["params"])))
    assert residual < prob.solve_threshold

    jsvc = JaxSolveService(JaxServingConfig(
        buckets=(64,), max_batch=2, queue_capacity=8, cache_capacity=2,
        solve=_jax_cfg(cfg.solve)))
    jsvc.register_problem("proxy1d", gen_stack=state["gen"])
    jt = jsvc.submit("proxy1d", np.asarray(data[:64]))
    jsvc.run_until_empty()
    for key in ("params", "sigma", "score"):
        np.testing.assert_allclose(out[key], jt.result()[key], **FP32)
