"""The port's GAN training path against the JAX package, on the CPU.

The same inputs go through `repro` and `repro_torch`.  torch cannot replay
`jax.random`, so the random draws of an epoch are made by JAX in the
reference's own key-split order (`jax_draws`: `workflow.py:336`, `:315`,
`problems/__init__.py:121–125`) and handed to the port:

  networks        parameter counts, `weight_mask`, the fused payload's
                  offsets; `discriminate`, `disc_loss`, `gen_loss` at fp32
                  rtol 1e-4 / atol 1e-5, and with disc_compute="bf16" in
                  relative norm (ROADMAP.md queue C item 3)
  sampling        `synthetic_events` with the Pallas kernel in interpret
                  mode and with "jnp" (fp32 tolerance)
  exchange        `sync_gradients` for all six modes, fused and unfused,
                  at (O, I) in {(1, 4), (2, 2), (2, 4)}, on epochs with the
                  outer ring due and not due: bitwise for the ring modes
                  (mailbox included), fp32 tolerance for the means of
                  allreduce and dbtree; the fused ring modes again with
                  the bf16 payload, bitwise (tests/test_torch_precision.py
                  holds the rest of bf16); `FusionSpec` round trips on
                  explicit examples; `SyncConfig`'s errors
  optimizer       Adam with the [R] step of a stacked state
  training        one step (losses, generator gradients, the whole new
                  state) from a JAX `init_run` state, and 3 epochs in
                  rma_arar_arar and conv_arar at h 1, at fp32 tolerance;
                  the ensemble response; the bars of
                  tests/test_system.py::test_workflow_end_to_end_healthy
                  on CPU tensors through B1's plain version
  checkpoints     the JAX store reads the port's checkpoint, both services
                  serve its generator, `resume` is bitwise
  CLI             `python -m repro_torch.launch.train_gan`, both backends

The card's side (one epoch against the CPU, B1's counts) is in
tests/test_torch_cuda.py and `chip_smoke.py` phases 22–24.
"""
import dataclasses
import functools
import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_latest as jax_restore_latest
from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import gan as JG
from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ensemble import ensemble_response as jax_ensemble
from repro.core.ring import VmapComm as JaxVmapComm
from repro.optim import adam as jax_adam
from repro.problems import get_problem as jax_get_problem
from repro.problems import synthetic_events as jax_synthetic_events
from repro.serving.service import load_generator_stack as jax_load_stack

from repro_torch.checkpoint.store import (gan_state_from_numpy,
                                          latest_step, load_generator_stack,
                                          save_checkpoint)
from repro_torch.configs import sagips_gan
from repro_torch.core import gan, sync, workflow
from repro_torch.core.ensemble import ensemble_response
from repro_torch.core.ring import VmapComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.kernels.inverse_cdf import counts as icdf_counts
from repro_torch.optim import adam
from repro_torch.problems import get_problem, synthetic_events

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 3e-2          # bf16 forward in relative norm (queue C item 3)
# smoke sizes: R 4 as 2 x 2, K 16, E 8, 5,000 reference events
SMOKE = dict(n_param_samples=16, events_per_sample=8, gen_lr=2e-4,
             disc_lr=5e-4)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wcfgs(mode="rma_arar_arar", h=5, **kw):
    """The same settings as a JAX and a port WorkflowConfig."""
    args = dict(SMOKE, **kw)
    fuse = args.pop("fuse_tensors", True)
    return (JW.WorkflowConfig(sync=JS.SyncConfig(mode=mode, h=h,
                                                 fuse_tensors=fuse), **args),
            workflow.WorkflowConfig(sync=sync.SyncConfig(
                mode=mode, h=h, fuse_tensors=fuse), **args))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def jax_draws(rng, jcfg, n_sub, noise_channels=2):
    """One epoch's draws for every rank, replaying the reference's key
    splits under its `jax.vmap`: (new rng [R, 2], port draws)."""
    K, E = jcfg.n_param_samples, jcfg.events_per_sample

    def one(key):
        new, k_boot, k_gen = jax.random.split(key, 3)
        idx = jax.random.randint(k_boot, (jcfg.disc_batch,), 0, n_sub)
        k1, k2 = jax.random.split(k_gen)
        noise = jax.random.normal(k1, (K, JG.NOISE_DIM))
        u = jax.random.uniform(k2, (K, E, noise_channels))
        return new, idx, noise, u
    new, idx, noise, u = jax.vmap(one)(rng)
    return new, {"noise": _t(noise), "u": _t(u),
                 "idx": _t(idx).to(torch.int64)}


@functools.lru_cache(maxsize=None)
def _jax_init_run():
    """A JAX `init_run` of 4 ranks at the smoke sizes (its state does not
    depend on the ring mode or h), made once for the module (jitted: only
    its being a JAX state matters, and the port takes it as it is)."""
    jcfg, _ = _wcfgs()
    data = jax.jit(lambda k: jax_get_problem("proxy1d").make_reference_data(
        k, 5_000))(jax.random.PRNGKey(99))
    return jax.jit(JW.init_run, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), 4, jcfg, data)


def jax_run(mode="rma_arar_arar", h=5):
    """The JAX `init_run` state and data split (2 x 2 ranks), the port's
    copy of both, and the configs of `mode` and `h`."""
    jcfg, pcfg = _wcfgs(mode, h)
    jstate, jdata = _jax_init_run()
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    return jcfg, pcfg, jstate, jdata, gan_state_from_numpy(flat, "cpu"), \
        _t(jdata)


def assert_state_close(pstate, jstate, tol=FP32):
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()
            if not k.startswith("rng")}
    got = dict(tree_paths(pstate))
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(_np(got[k]), v, err_msg=k, **tol)


# ----------------------------------------------------------------------------
# networks


def test_param_counts_weight_mask_and_payload_layout():
    g = torch.Generator().manual_seed(0)
    gen_p = gan.init_generator(g, device="cpu")
    disc_p = gan.init_discriminator(g, device="cpu")
    assert gan.param_count(gen_p) == 51_206
    assert gan.param_count(disc_p) == 50_049
    assert gan.disc_widths() == JG.disc_widths() == (2, 192, 192, 64, 1)
    jgen = JG.init_generator(jax.random.PRNGKey(0))
    assert gan.weight_mask(gen_p) == JG.weight_mask(jgen)
    # the fused payload: w0..w3, D = 50,816 fp32 at the JAX offsets
    spec = sync.FusionSpec.build(gen_p, gan.weight_mask(gen_p))
    jspec = JS.FusionSpec.build(jgen, JG.weight_mask(jgen))
    assert spec.total == jspec.total == 50_816
    assert [(s.masked, s.shape, s.offset) for s in spec.slots] == \
        [(s.masked, s.shape, s.offset) for s in jspec.slots]
    wspec = workflow.make_schedule(workflow.WorkflowConfig()).spec
    assert (wspec.total, wspec.payload_dtype) == (50_816, torch.float32)


def _disc_inputs(seed, R=3, N=50):
    rng = np.random.default_rng(seed)
    layers = []
    for a, b in zip(JG.DISC_WIDTHS[:-1], JG.DISC_WIDTHS[1:]):
        layers.append({"w": (rng.standard_normal((R, a, b))
                             * np.sqrt(2 / a)).astype(np.float32),
                       "b": (0.1 * rng.standard_normal((R, b))
                             ).astype(np.float32)})
    real = rng.standard_normal((R, N, 2)).astype(np.float32)
    fake = (rng.standard_normal((R, N, 2)) * 1.5 + 0.3).astype(np.float32)
    return layers, real, fake


def _jax_disc_fns(layers, real, fake, cdt):
    jl = jax.tree.map(jnp.asarray, layers)
    d = jax.vmap(lambda p, e: JG.discriminate(p, e, cdt))(jl, real)
    dl = jax.vmap(lambda p, r, f: JG.disc_loss(p, r, f, cdt))(jl, real, fake)
    gl = jax.vmap(lambda p, f: JG.gen_loss(p, f, cdt))(jl, fake)
    return [np.asarray(x, np.float32) for x in (d, dl, gl)]


def _port_disc_fns(layers, real, fake, cdt):
    pl = tree_map(_t, layers)
    return [_np(x) for x in (gan.discriminate(pl, _t(real), cdt),
                             gan.disc_loss(pl, _t(real), _t(fake), cdt),
                             gan.gen_loss(pl, _t(fake), cdt))]


def test_discriminator_and_losses_match_jax_fp32():
    layers, real, fake = _disc_inputs(1)
    want = _jax_disc_fns(layers, real, fake, None)
    got = _port_disc_fns(layers, real, fake, None)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **FP32)
    # unstacked: one rank's parameters and events
    one = tree_map(lambda a: _t(a[0]), layers)
    np.testing.assert_allclose(
        _np(gan.disc_loss(one, _t(real[0]), _t(fake[0]))), want[1][0], **FP32)


def test_discriminator_bf16_in_relative_norm():
    """disc_compute="bf16": parameters and events cast once, fp32 logits
    out.  Held to the JAX package's bf16 in relative norm (the packages
    round at other places, queue C item 3), and each package's bf16 is
    as far from its own fp32."""
    layers, real, fake = _disc_inputs(2)
    cdt_j, cdt_p = JG.compute_dtype_of("bf16"), gan.compute_dtype_of("bf16")
    assert cdt_p == torch.bfloat16 and gan.compute_dtype_of("fp32") is None
    with pytest.raises(ValueError, match="disc_compute"):
        gan.compute_dtype_of("fp16")
    want = _jax_disc_fns(layers, real, fake, cdt_j)
    got = _port_disc_fns(layers, real, fake, cdt_p)
    exact = _port_disc_fns(layers, real, fake, None)
    for w, g, e in zip(want, got, exact):
        assert g.dtype == np.float32
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < BF16_REL, rel
        assert np.linalg.norm(g - e) / np.linalg.norm(e) < BF16_REL


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_synthetic_events_match_jax(impl):
    """The replayed draws through the port equal `repro.problems
    .synthetic_events` on the reference's keys, so the helper replays the
    key splits and the port's forward pass matches."""
    jprob, R, K, E = jax_get_problem("proxy1d"), 2, 5, 7
    jgen = jax.tree.map(lambda a: a[:R], _jax_init_run()[0]["gen"])
    jcfg = JW.WorkflowConfig(n_param_samples=K, events_per_sample=E)
    rng = jax.random.split(jax.random.PRNGKey(4), R)
    _, draws = jax_draws(rng, jcfg, n_sub=10)
    # rank by rank, as `rank_grads` calls it under its vmap (one compile
    # of the interpreted kernel serves both ranks)
    ev, pr = zip(*(jax_synthetic_events(
        jprob, jax.tree.map(lambda a: a[r], jgen),
        jax.random.split(rng[r], 3)[2], K, E, impl=impl, interpret=True)
        for r in range(R)))
    pgen = tree_map(lambda a: _t(a), jax.tree.map(np.asarray, jgen))
    icdf_counts.reset()
    events, params = synthetic_events(get_problem("proxy1d"), pgen,
                                      draws["noise"], draws["u"])
    assert (icdf_counts.plain_calls, icdf_counts.launches) == (1, 0)
    assert events.shape == (R, K * E, 2) and params.shape == (R, K, 6)
    np.testing.assert_allclose(_np(events), np.stack(ev), **FP32)
    np.testing.assert_allclose(_np(params), np.stack(pr), **FP32)


# ----------------------------------------------------------------------------
# the exchange


def _grads(R, seed):
    """Per-rank trees at the generator's widths (gradients, or the
    generators of an ensemble), as numpy."""
    rng = np.random.default_rng(seed)
    widths = JG.GEN_WIDTHS
    return [{"w": rng.standard_normal((R, a, b)).astype(np.float32),
             "b": rng.standard_normal((R, b)).astype(np.float32)}
            for a, b in zip(widths[:-1], widths[1:])]


def _sync_cases():
    """(mode, fuse, (O, I), epoch, payload) with the ids the fp32 cases
    always had; the bf16 payload for the fused ring modes, which are the
    ones `SyncConfig` takes it for."""
    for mode, (fuse, f), oi, (epoch, e) in itertools.product(
            JS.MODES, ((True, "fused"), (False, "unfused")),
            ((1, 4), (2, 2), (2, 4)), ((0, "outer_due"), (3, "not_due"))):
        ident = f"{mode}-{f}-{oi[0]}x{oi[1]}-{e}"
        yield pytest.param(mode, fuse, oi, epoch, "fp32", id=ident)
        if fuse and mode in JS.RING_MODES:
            yield pytest.param(mode, fuse, oi, epoch, "bf16",
                               id=f"{ident}-bf16")


@pytest.mark.parametrize("mode,fuse,OI,epoch,payload", list(_sync_cases()))
def test_sync_gradients_match_jax(mode, fuse, OI, epoch, payload):
    """Bitwise for the ring modes (at bf16 too: pack, combine and unpack
    round where XLA rounds; dbtree's bf16 sum and `/ R` as well), fp32
    tolerance for the fp32 means of allreduce and dbtree."""
    O, I = OI
    R = O * I
    g, mb = _grads(R, 10 + R), _grads(R, 20 + R)
    jcfg = JS.SyncConfig(mode=mode, h=3, fuse_tensors=fuse,
                         payload_precision=payload)
    pcfg = sync.SyncConfig(mode=mode, h=3, fuse_tensors=fuse,
                           payload_precision=payload)
    jmask = JG.weight_mask(g)
    js, jmb = JS.sync_gradients(JaxVmapComm(O, I), jcfg,
                                jax.tree.map(jnp.asarray, g),
                                jax.tree.map(jnp.asarray, mb), epoch, jmask)
    ps, pmb = sync.sync_gradients(VmapComm(O, I), pcfg, tree_map(_t, g),
                                  tree_map(_t, mb), torch.tensor(epoch),
                                  gan.weight_mask(g))
    for (path, got), want in zip(tree_paths({"s": ps, "m": pmb}),
                                 jax.tree.leaves({"s": js, "m": jmb})):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        if mode in ("allreduce", "dbtree") and payload == "fp32":
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=path)
    if mode != "rma_arar_arar":       # only the RMA mode writes a mailbox
        # (an fp32 mailbox handed to the bf16 payload crosses its pack and
        # unpack, as in JAX: a run's own mailbox is bf16 already)
        rounded = tree_map(lambda m, b: _np(_t(b).to(torch.bfloat16).float())
                           if m and payload == "bf16" else b,
                           gan.weight_mask(g), mb)
        for a, b in zip(tree_leaves(pmb), tree_leaves(rounded)):
            np.testing.assert_array_equal(_np(a), b)


def test_schedule_state_and_exchange_match_jax():
    """StaticSchedule's SyncState has the JAX leaves and shapes, and two
    exchanges through it (mailbox carried) are bitwise the JAX ones."""
    jcfg, pcfg = _wcfgs("rma_arar_arar", h=2)
    js, ps = JW.make_schedule(jcfg), workflow.make_schedule(pcfg)
    jst, pst = js.init_state(4), ps.init_state(4, "cpu")
    assert {k: tuple(v.shape) for k, v in tree_paths(pst)} == \
        {k: v.shape for k, v in jax_flatten(jst).items()}
    for e in range(2):
        g = _grads(4, 30 + e)
        jsync, jst = js.exchange(JaxVmapComm(2, 2), jax.tree.map(
            jnp.asarray, g), jst, e)
        psync, pst = ps.exchange(VmapComm(2, 2), tree_map(_t, g), pst,
                                 torch.tensor(e))
    for got, want in zip(tree_leaves({"a": psync, "b": pst}),
                         jax.tree.leaves({"a": jsync, "b": jst})):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("stacked", [False, True])
def test_fusion_spec_round_trip(stacked):
    """Explicit examples (the JAX package's property test is flaky under
    hypothesis, queue C): an MLP-shaped tree, a mask with no weight, and
    a dict-keyed tree whose sorted order is not its insertion order."""
    lead = (3,) if stacked else ()
    trees = [
        [{"w": torch.randn(lead + (4, 5)), "b": torch.randn(lead + (5,))},
         {"w": torch.randn(lead + (5, 2)), "b": torch.randn(lead + (2,))}],
        {"z": torch.randn(lead + (2, 2)), "a": torch.randn(lead + (3,))},
    ]
    masks = [[{"w": True, "b": False}, {"w": True, "b": False}],
             {"z": True, "a": True}]
    for tree, mask in zip(trees, masks):
        example = tree_map(lambda t: t[0] if stacked else t, tree)
        spec = sync.FusionSpec.build(example, mask)
        flat = spec.flatten(tree, stacked)
        assert flat.shape == lead + (spec.total,)
        back = spec.unflatten(flat, tree, stacked)
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            assert torch.equal(a, b)
        # JAX's offsets and flat payload for the same tree
        jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
        jspec = JS.FusionSpec.build(jax.tree.map(
            lambda t: jax.ShapeDtypeStruct(t.shape[1:] if stacked
                                           else t.shape, t.dtype), jtree),
            mask)
        np.testing.assert_array_equal(
            _np(flat), np.asarray(jspec.flatten(jtree, stacked)))
    # no masked leaf: an empty payload, and the exchange passes through
    spec = sync.FusionSpec.build(trees[0], [{"w": False, "b": False}] * 2)
    assert spec.total == 0 and spec.zero_payload(2).shape == (2, 0)


# (JAX config, port config) pairs that the JAX package refuses
_BAD_SYNC = [
    dict(mode="nope"), dict(payload_precision="fp8"),
    dict(payload_precision="bf16", fuse_tensors=False),
    dict(payload_precision="bf16", mode="allreduce"), dict(staleness=0),
    dict(staleness=2, mode="arar_arar"), dict(overlap=True, mode="dbtree"),
    dict(overlap=True, mode="arar_arar", fuse_tensors=False),
    dict(adaptive=True, mode="conv_arar"),
    dict(adaptive=True, mode="rma_arar_arar", fuse_tensors=False),
    dict(ring_chunking=-1), dict(ring_chunking=64, fuse_tensors=False),
    dict(ring_chunking=64, mode="ensemble")]


@pytest.mark.parametrize("kw", _BAD_SYNC, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_sync_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JS.SyncConfig(**kw)
    with pytest.raises(ValueError) as got:
        sync.SyncConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(staleness=2, mode="rma_arar_arar"),
    dict(overlap=True, mode="arar_arar"),
    dict(adaptive=True, mode="rma_arar_arar"),
    dict(ring_chunking=4096, mode="arar_arar")],
    ids=["staleness", "overlap", "adaptive", "chunking"])
def test_schedule_features_raise_with_their_item(kw):
    """The features of queue A item 3 still to port raise with the item;
    the chunked ring (3b) is ported and takes the JAX config as is."""
    want = JS.SyncConfig(**kw)          # valid in the JAX package
    if "ring_chunking" in kw:
        assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
            dataclasses.asdict(want)
        return
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        sync.SyncConfig(**kw)


def test_workflow_features_raise_with_their_item():
    for kw in (dict(disc_every=2), dict(gen_every=3), dict(obs=True)):
        with pytest.raises(NotImplementedError, match="queue A item 3"):
            workflow.WorkflowConfig(**kw)
    with pytest.raises(ValueError, match="cadences"):
        workflow.WorkflowConfig(disc_every=0)
    with pytest.raises(NotImplementedError, match="queue A item 3c"):
        sagips_gan.throughput()
    img = sagips_gan.for_problem("imaging")
    assert (img.n_param_samples, img.events_per_sample, img.gen_lr) == \
        (64, 32, 5e-5)
    # imaging trains the conv generator (queue A item 5, done)
    state, per_rank = workflow.init_run(torch.Generator(), 2, img,
                                        torch.zeros(10, 15), "cpu")
    assert set(state["gen"]) == {"proj", "convs"}
    assert state["gen"]["convs"][0]["w"].shape == (2, 3, 3, 32, 32)
    assert per_rank.shape == (2, 5, 15)
    with pytest.raises(KeyError, match="registered"):
        sagips_gan.for_problem("no_such_problem")


def test_presets_match_jax():
    from repro.configs import sagips_gan as jax_presets
    for name in ("PAPER", "REDUCED"):
        j, p = getattr(jax_presets, name), getattr(sagips_gan, name)
        for f in ("n_param_samples", "events_per_sample", "data_fraction",
                  "gen_lr", "disc_lr", "problem"):
            assert getattr(p, f) == getattr(j, f), (name, f)
        assert (p.sync.mode, p.sync.h) == (j.sync.mode, j.sync.h)


def test_adam_over_a_stacked_state():
    """An [R] step broadcasts over each leaf's rank axis: three steps on a
    stack equal each rank's own Adam (0-d step) and the JAX package's
    `jax.vmap`ped Adam."""
    rng = np.random.default_rng(5)
    R = 3
    params = [{"w": rng.standard_normal((R, 4, 2)).astype(np.float32),
               "b": rng.standard_normal((R, 2)).astype(np.float32)}]
    grads = [[{k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in params[0].items()}] for _ in range(3)]
    opt, jopt = adam(1e-2), jax_adam(1e-2)
    st = tree_map(lambda *xs: torch.stack(xs), *[
        opt.init(tree_map(lambda a: _t(a[r]), params)) for r in range(R)])
    assert st["step"].shape == (R,)
    jst = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    ranks = [opt.init(tree_map(lambda a: _t(a[r]), params))
             for r in range(R)]
    for g in grads:
        upd, st = opt.update(tree_map(_t, g), st)
        jupd, jst = jax.vmap(jopt.update)(jax.tree.map(jnp.asarray, g), jst)
        for r in range(R):
            u_r, ranks[r] = opt.update(tree_map(lambda a: _t(a[r]), g),
                                       ranks[r])
            for a, b in zip(tree_leaves(upd), tree_leaves(u_r)):
                assert torch.equal(a[r], b)
        for a, b in zip(tree_leaves(upd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    assert st["step"].tolist() == [3] * R


# ----------------------------------------------------------------------------
# training


def test_one_step_matches_jax():
    """rank_grads + exchange + rank_apply from a JAX `init_run` state with
    JAX's draws, h 1 so the outer ring runs: losses, generator gradients
    and every leaf of the new state at fp32 tolerance."""
    jcfg, pcfg, jstate, jdata, pstate, pdata = jax_run("rma_arar_arar", h=1)
    assert_state_close(pstate, jstate, dict(rtol=0, atol=0))
    _, draws = jax_draws(jstate["rng"], jcfg, jdata.shape[1])
    jpart, jg, jm = jax.jit(jax.vmap(lambda s, d: JW.rank_grads(
        s, d, jcfg)))(jstate, jdata)
    ppart, pg, pm = workflow.rank_grads(pstate, pdata, draws, pcfg)
    for k in ("d_loss", "g_loss", "pred_params", "residuals"):
        np.testing.assert_allclose(_np(pm[k]), np.asarray(jm[k]), err_msg=k,
                                   **FP32)
    for a, b in zip(tree_leaves(pg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **FP32)
    jsched, psched = JW.make_schedule(jcfg), workflow.make_schedule(pcfg)
    jsync, jns = jsched.exchange(JaxVmapComm(2, 2), jg, jpart["sync"], 0)
    psync, pns = psched.exchange(VmapComm(2, 2), pg, ppart["sync"],
                                 ppart["epoch"][0])
    jnew = jax.vmap(lambda s, g, n: JW.rank_apply(s, g, n, jcfg))(
        jpart, jsync, jns)
    assert_state_close(workflow.rank_apply(ppart, psync, pns, pcfg), jnew)


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
def test_three_epochs_match_jax(mode):
    """3 epochs of the port's epoch function against JAX's jitted epoch
    at h 1, the draws replayed from the JAX state's rng each epoch."""
    jcfg, pcfg, jstate, jdata, pstate, pdata = jax_run(mode, h=1)
    jepoch = JW.make_epoch_fn_vmap(2, 2, jcfg)
    pepoch = workflow.make_epoch_fn(2, 2, pcfg)
    jstate = jax.tree.map(jnp.copy, jstate)
    for _ in range(3):
        _, draws = jax_draws(jstate["rng"], jcfg, jdata.shape[1])
        jstate, jm = jepoch(jstate, jdata)
        pstate, pm = pepoch(pstate, pdata, draws)
        np.testing.assert_allclose(_np(pm["d_loss"]),
                                   np.asarray(jm["d_loss"]), **FP32)
        np.testing.assert_allclose(_np(pm["g_loss"]),
                                   np.asarray(jm["g_loss"]), **FP32)
    assert_state_close(pstate, jstate)


def test_ensemble_response_matches_jax():
    gen = tree_map(lambda a: 0.1 * a, _grads(4, 8))   # 4 distinct generators
    noise = np.random.default_rng(9).standard_normal((32, 135)).astype(
        np.float32)
    jp, js = jax_ensemble(jax.tree.map(jnp.asarray, gen), jnp.asarray(noise))
    pp, ps = ensemble_response(tree_map(_t, gen), _t(noise))
    np.testing.assert_allclose(_np(pp), np.asarray(jp), **FP32)
    np.testing.assert_allclose(_np(ps), np.asarray(js), **FP32)


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
def test_workflow_end_to_end_healthy(mode):
    """The bars of tests/test_system.py::test_workflow_end_to_end_healthy
    for a port run on CPU tensors: 60 epochs, history every 10, every
    state leaf finite, the ensemble in (0, 1), d_loss falling.  B1 runs
    its plain version once an epoch, forward and backward."""
    _, pcfg = _wcfgs(mode, h=5)
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 5_000, device="cpu")
    icdf_counts.reset()
    state, hist = workflow.train_stacked(0, pcfg, 2, 2, 60, data,
                                         checkpoint_every=10, device="cpu")
    assert (icdf_counts.launches, icdf_counts.plain_calls,
            icdf_counts.backward_plain) == (0, 60, 60)
    for path, leaf in tree_paths(state):
        assert bool(torch.isfinite(leaf.float()).all()), path
    assert hist["d_loss"].shape == (7, 4)     # epochs 0, 10, ..., 50, 59
    noise = torch.randn((64, 135), generator=torch.Generator().manual_seed(7))
    p_hat, _ = ensemble_response(state["gen"], noise)
    assert float(p_hat.min()) > 0 and float(p_hat.max()) < 1
    d = _np(hist["d_loss"]).mean(axis=1)
    assert d[-1] < d[0] and d.min() < 1.42, d


# ----------------------------------------------------------------------------
# checkpoints and the CLI


def test_checkpoint_read_by_jax_and_served_by_both(tmp_path):
    _, pcfg = _wcfgs("rma_arar_arar", h=1)
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device="cpu")
    state, _ = workflow.train_stacked(1, pcfg, 2, 2, 2, data,
                                      checkpoint_every=2,
                                      checkpoint_dir=str(tmp_path),
                                      device="cpu")
    jcfg, _ = _wcfgs("rma_arar_arar", h=1)
    like = JW.init_state(jax.random.PRNGKey(0), 4, jcfg)
    restored, step = jax_restore_latest(str(tmp_path), like)
    assert step == 2
    flat = jax_flatten(restored)
    assert "rng" in flat                # the port's generator state
    got = dict(tree_paths(state))
    for k, want in jax_flatten(like).items():
        if k == "rng":
            continue
        assert flat[k].shape == want.shape == tuple(got[k].shape), k
        assert flat[k].dtype == want.dtype, k
        np.testing.assert_array_equal(np.asarray(flat[k]), _np(got[k]))
    assert int(flat["epoch"][0]) == 2 and flat["gen_opt/step"].shape == (4,)
    # both services' checkpoint routes read the trained stack
    pstack, pstep = load_generator_stack(str(tmp_path), "cpu")
    jstack, jstep = jax_load_stack(str(tmp_path), jax_get_problem("proxy1d"))
    assert pstep == jstep == 2
    for a, b, c in zip(tree_leaves(pstack), jax.tree.leaves(jstack),
                       tree_leaves(state["gen"])):
        assert torch.equal(a, c)
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # ... and each service solves a request with it
    from repro.configs.serving import REDUCED as JAX_REDUCED
    from repro.serving import SolveService as JaxSolveService
    from repro_torch.configs.serving import REDUCED
    from repro_torch.serving import SolveService
    y = _np(data[:40])
    for svc in (SolveService(REDUCED, device="cpu"),
                JaxSolveService(JAX_REDUCED)):
        svc.register_problem("proxy1d", checkpoint_dir=str(tmp_path))
        ticket = svc.submit("proxy1d", y)
        svc.run_until_empty()
        params = np.asarray(ticket.result()["params"])
        assert params.shape == (6,) and np.isfinite(params).all()
        assert ((params > 0) & (params < 1)).all()


def test_resume_is_bitwise(tmp_path):
    _, pcfg = _wcfgs("rma_arar_arar", h=2)
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(99), 2_000, device="cpu")
    full, fh = workflow.train_stacked(2, pcfg, 2, 2, 6, data,
                                      checkpoint_every=3, device="cpu")
    part = str(tmp_path / "run")
    workflow.train_stacked(2, pcfg, 2, 2, 3, data, checkpoint_every=3,
                           checkpoint_dir=part, device="cpu")
    resumed, rh = workflow.train_stacked(2, pcfg, 2, 2, 6, data,
                                         checkpoint_every=3,
                                         checkpoint_dir=part, resume=True,
                                         device="cpu")
    for (k, a), b in zip(tree_paths(resumed), tree_leaves(full)):
        assert torch.equal(a, b), k
    assert torch.equal(rh["d_loss"], fh["d_loss"][-2:])     # epochs 3, 5
    assert sorted(os.listdir(part)) == ["step_00000003", "step_00000006"]
    assert latest_step(part) == 6 and latest_step(str(tmp_path)) is None


def test_gan_state_from_numpy_refuses_other_trees():
    with pytest.raises(ValueError, match="top-level keys"):
        gan_state_from_numpy({"gen/0/w": np.zeros((1, 2, 2))}, "cpu")


def test_save_checkpoint_keeps_bf16_bits(tmp_path):
    from repro_torch.checkpoint.store import read_step, restore_latest
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 4, {"x": [t]})
    assert read_step(str(tmp_path), 4)["x/0"].tolist() == [1.0, -2.5,
                                                           3.140625]
    back, step = restore_latest(str(tmp_path), {"x": [torch.zeros(
        3, dtype=torch.bfloat16)]})
    assert step == 4 and torch.equal(back["x"][0], t)


def test_train_gan_cli_on_the_cpu(capsys):
    from repro_torch.launch import train_gan
    train_gan.main(["--device", "cpu", "--preset", "reduced", "--ranks", "4",
                    "--epochs", "12", "--events", "2000"])
    out = capsys.readouterr().out
    assert "0 kernel launches, 12 plain calls, 12 backward passes" in out
    assert "final ensemble prediction vs truth" in out
    assert "serving-path solve" in out
    # the proc backend: 2 worker processes, one line each, B1's counts
    # summed over them
    train_gan.main(["--device", "cpu", "--backend", "proc", "--num-procs",
                    "2", "--epochs", "3", "--param-samples", "8",
                    "--events", "2000"])
    out = capsys.readouterr().out
    assert "2 worker processes (1 x 2), lock-step" in out
    for r in (0, 1):
        assert f"rank {r} on cpu: 3 epochs from 0, epoch p50" in out
    assert ("summed over the workers: 0 kernel launches, 6 plain calls, 6 "
            "backward passes") in out
    assert "serving-path solve" in out
    for argv, item in ((["--sync-schedule", "overlap"], "item 3"),
                       (["--disc-every", "2"], "item 3")):
        with pytest.raises(NotImplementedError, match=item):
            train_gan.main(["--device", "cpu"] + argv)


def test_train_gan_cli_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    from repro_torch.launch import train_gan
    with pytest.raises(RuntimeError, match="is_available"):
        train_gan.main(["--epochs", "1"])
