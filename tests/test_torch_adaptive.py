"""Adaptive staleness (`SyncConfig(adaptive=True)`, `AdaptiveSchedule`,
ROADMAP.md queue A item 3g) of the port against the JAX package, on the
CPU.

The schedule reads its max-depth mailbox k_eff epochs old, k_eff in
[1, k_max] moved by an EMA controller of the skew that the deposits'
epoch tags show, and under overlap stretches the ship gate by k_eff:

  factory     `make_schedule` routes on `adaptive`, the name, the config
              errors word for word
  controller  `adaptive_controller_step` and `adaptive_k_eff` bitwise
              JAX's on seeded skew sequences, k_max 1-6, deadband 0 and
              the default: k_eff in [1, k_max], widen then narrow, the
              deadband never adds transitions (the rows of
              tests/test_schedule.py, as explicit examples)
  tag         `make_deposit_tag`'s layouts, made on the device
  exchange    `AdaptiveSchedule.exchange_with_obs` on `VmapComm` 2 x 4
              against JAX's: k_max 1 and 3, with and without overlap,
              fp32 and bf16, whole and chunked, at zero skew and with
              skew driven in through old tags (k_eff widens, then
              narrows); outputs, SyncState and obs row bitwise; the
              `rma_adaptive_k3` and `rma_adaptive_overlap_k3` rows of
              tests/test_chunked_ring.py at the generator's width; the
              ship once a cycle while k_eff jumps
  degenerate  zero-skew adaptive bitwise depth-1 rma_arar_arar, with and
              without overlap
  trajectory  6 epochs from a JAX-initialised adaptive state against
              JAX's epoch function, every epoch and at (2, 3)
  layout      `init_state` against `jax.eval_shape`, the checkpoint both
              ways and `gan_state_from_numpy`
  proc        2 lock-step workers, adaptive + overlap at 2 x 1, bitwise
              `lockstep_reference` with k_eff 1; a free run with rank 1
              60 ms late an epoch measures skew and widens k_eff, with
              the tracer's `skew_ema` and `k_eff` counters
  CLI         both adaptive schedules on both backends

Where the controller's EMA is not 0, JAX's exchange runs op by op: XLA
on the CPU fuses `(1 - a)·ema + a·s` under `jax.jit` and may round it
once less (0.92000002 against 0.92000008 at epoch 5 of the driven
case), while the port rounds each op, as JAX does op by op and as the
card does.  Zero-skew runs hold jitted JAX bitwise.

The card's side is in tests/test_torch_cuda.py and `chip_smoke.py`
phases 48-49.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_latest as jax_restore_latest
from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ring import VmapComm as JaxVmapComm
from repro.core.ring import make_deposit_tag as jax_make_deposit_tag

from repro_torch.checkpoint.store import gan_state_from_numpy, restore_latest
from repro_torch.core import sync, workflow
from repro_torch.core.ring import VmapComm, make_deposit_tag
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.problems import get_problem
from repro_torch.runtime import JitterConfig
from repro_torch.runtime.launch import lockstep_reference, run_proc

from test_torch_chunked import CHUNK, _assert_bitwise
from test_torch_gan import (FP32, SMOKE, _jax_init_run, _np, _t,
                            assert_state_close, jax_draws)

O, I = 2, 4
R = O * I
MASK = {"w": True, "b": False}
READ_BACKS = ("item", "tolist", "__int__", "__index__", "__float__",
              "__bool__")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wcfgs(k=3, overlap=False, precision="fp32", chunk=0, h=2, small=True,
           adaptive=True, **kw):
    """The same proxy1d settings, rma_arar_arar, adaptive at k_max `k`,
    as a JAX and a port config (`small`: 8 x 4 events a rank, else the
    smoke sizes)."""
    s = dict(mode="rma_arar_arar", h=h, staleness=k, overlap=overlap,
             adaptive=adaptive, payload_precision=precision,
             ring_chunking=chunk)
    sizes = dict(n_param_samples=8, events_per_sample=4) if small else SMOKE
    kw = dict(sizes, problem="proxy1d", **kw)
    return (JW.WorkflowConfig(sync=JS.SyncConfig(**s), **kw),
            workflow.WorkflowConfig(sync=sync.SyncConfig(**s), **kw))


def _data(n=400):
    return get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(7), n, device="cpu")


def _bitwise(got, want, what):
    for (k, a), b in zip(tree_paths(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {k}"


def _small_scheds(k, overlap, precision, chunk, h=4):
    """JAX's and the port's `AdaptiveSchedule` over a small tree, a
    [3, 4] weight (it rides the ring) and a [4] bias (it does not)."""
    s = dict(mode="rma_arar_arar", h=h, staleness=k, overlap=overlap,
             adaptive=True, payload_precision=precision,
             ring_chunking=chunk)
    wire = sync.payload_dtype_of(precision)
    pspec = sync.FusionSpec.build({"w": torch.zeros(3, 4),
                                   "b": torch.zeros(4)}, MASK,
                                  payload_dtype=wire, chunk_bytes=chunk)
    jspec = JS.FusionSpec.build(
        {"w": jax.ShapeDtypeStruct((3, 4), jnp.float32),
         "b": jax.ShapeDtypeStruct((4,), jnp.float32)}, MASK,
        payload_dtype=jnp.bfloat16 if precision == "bf16" else jnp.float32,
        chunk_bytes=chunk)
    return (JS.make_schedule(JS.SyncConfig(**s), MASK, jspec),
            sync.make_schedule(sync.SyncConfig(**s), MASK, pspec))


def _small_grads(e):
    rng = np.random.default_rng(500 + e)
    return {"w": rng.standard_normal((R, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((R, 4)).astype(np.float32)}


# ----------------------------------------------------------------------------
# the factory and the config


def test_factory_routes_on_adaptive_and_names_match_jax():
    for kw, name in ((dict(mode="rma_arar_arar", staleness=3,
                           adaptive=True), "adaptive"),
                     (dict(mode="rma_arar_arar", staleness=3, adaptive=True,
                           overlap=True), "adaptive"),
                     (dict(mode="rma_arar_arar", staleness=3), "sync"),
                     (dict(mode="rma_arar_arar", overlap=True), "overlap")):
        p = workflow.make_schedule(workflow.WorkflowConfig(
            sync=sync.SyncConfig(**kw)))
        j = JW.make_schedule(JW.WorkflowConfig(sync=JS.SyncConfig(**kw)))
        assert p.name == j.name == name
        assert isinstance(p, sync.AdaptiveSchedule) == \
            isinstance(j, JS.AdaptiveSchedule)
        assert p.payload_bytes == j.payload_bytes
    assert sync.AdaptiveSchedule(sync.SyncConfig(
        mode="rma_arar_arar", staleness=5, adaptive=True), None,
        None).k_max == 5


GOOD = [dict(mode="rma_arar_arar", adaptive=True),
        dict(mode="rma_arar_arar", staleness=4, adaptive=True),
        dict(mode="rma_arar_arar", staleness=3, adaptive=True, overlap=True,
             payload_precision="bf16", ring_chunking=4096)]
BAD = [dict(mode="arar_arar", adaptive=True),
       dict(mode="allreduce", adaptive=True),
       dict(mode="rma_arar_arar", adaptive=True, fuse_tensors=False)]


@pytest.mark.parametrize("kw", GOOD + BAD, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_config_matches_jax(kw):
    if kw in GOOD:
        assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
            dataclasses.asdict(JS.SyncConfig(**kw))
        return
    with pytest.raises(ValueError) as want:
        JS.SyncConfig(**kw)
    with pytest.raises(ValueError) as got:
        sync.SyncConfig(**kw)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------------
# the controller


def _skews(seed, n=60):
    """A seeded skew sequence: runs of lag, noise around the rounding
    boundaries, negative values and zeros."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-10, 10, n // 3),
             np.where(np.arange(n // 3) % 2, 0.3, 0.7) + rng.normal(
                 0, 0.05, n // 3),
             np.repeat(rng.uniform(0, 6, n // 15), 5)]
    return np.concatenate(parts).astype(np.float32)


def _controller(step, skews, k_max, deadband, tensor, lead=()):
    ctrl = {"skew_ema": tensor(np.zeros(lead, np.float32)),
            "k_eff": tensor(np.ones(lead, np.int32))}
    out = []
    for s in skews:
        ctrl = step(ctrl, tensor(np.full(lead, s, np.float32)), k_max,
                    deadband=deadband)
        out.append((np.asarray(ctrl["skew_ema"]).copy(),
                    np.asarray(ctrl["k_eff"]).copy()))
    return out


def _transitions(ks):
    return sum(a != b for a, b in zip(ks, ks[1:]))


CONTROLLER = [(k, d) for k in range(1, 7)
              for d in (0.0, sync.ADAPT_DEADBAND)]


@pytest.mark.parametrize("k_max,deadband", CONTROLLER,
                         ids=[f"k{k}-db{d}" for k, d in CONTROLLER])
def test_controller_is_bitwise_jax_and_bounded(k_max, deadband):
    assert (sync.ADAPT_ALPHA, sync.ADAPT_DEADBAND) == \
        (JS.ADAPT_ALPHA, JS.ADAPT_DEADBAND)
    for seed in range(3):
        skews = _skews(100 * k_max + seed)
        got = _controller(sync.adaptive_controller_step, skews, k_max,
                          deadband, torch.from_numpy, lead=(2,))
        want = _controller(JS.adaptive_controller_step, skews, k_max,
                           deadband, jnp.asarray, lead=(2,))
        for i, ((ge, gk), (we, wk)) in enumerate(zip(got, want)):
            assert ge.dtype == we.dtype and gk.dtype == wk.dtype
            np.testing.assert_array_equal(ge, we, err_msg=f"step {i}")
            np.testing.assert_array_equal(gk, wk, err_msg=f"step {i}")
            assert 1 <= gk.min() and gk.max() <= k_max
    # the deadband never adds transitions, counted from depth 1
    for seed in range(3):
        skews = _skews(7 + seed)
        raw = [int(k[0]) for _, k in _controller(
            sync.adaptive_controller_step, skews, k_max, 0.0,
            torch.from_numpy, lead=(1,))]
        held = [int(k[0]) for _, k in _controller(
            sync.adaptive_controller_step, skews, k_max, deadband,
            torch.from_numpy, lead=(1,))]
        assert _transitions([1] + held) <= _transitions([1] + raw)


def test_controller_widens_then_narrows_and_holds_at_a_boundary():
    ks = [int(k) for _, k in _controller(
        sync.adaptive_controller_step, [5.0] * 40 + [0.0] * 60, 4,
        sync.ADAPT_DEADBAND, torch.tensor)]
    assert ks[39] == 4 and ks[:40] == sorted(ks[:40]) and ks[-1] == 1
    flap = [0.7 if i % 2 == 0 else 0.3 for i in range(60)]
    raw = [int(k) for _, k in _controller(
        sync.adaptive_controller_step, flap, 4, 0.0, torch.tensor)]
    held = [int(k) for _, k in _controller(
        sync.adaptive_controller_step, flap, 4, sync.ADAPT_DEADBAND,
        torch.tensor)]
    assert _transitions(raw[20:]) > 10
    assert _transitions(held) == 0 and set(held) == {1}


def test_k_eff_is_an_integer_clip_rounding_half_to_even():
    ema = np.array([0.0, 2.4, 100.0, -100.0, 0.5, 1.5, 2.5, -0.5],
                   np.float32)
    got = sync.adaptive_k_eff(torch.from_numpy(ema), 5)
    want = np.asarray(JS.adaptive_k_eff(jnp.asarray(ema), 5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 3, 5, 1, 2, 2, 4, 1]


# ----------------------------------------------------------------------------
# the deposit tag


def test_deposit_tag_layouts(monkeypatch):
    epoch = torch.tensor(7, dtype=torch.int32)
    for name in READ_BACKS:
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    stacked = make_deposit_tag(epoch, 5)
    worker = make_deposit_tag(epoch, 1)
    wide = make_deposit_tag(torch.tensor(7, dtype=torch.int64), 3)
    monkeypatch.undo()
    want = np.asarray(jax_make_deposit_tag(jnp.asarray(7), n_ranks=5))
    assert stacked.dtype == torch.int32 and stacked.shape == (5,)
    np.testing.assert_array_equal(stacked.numpy(), want)
    assert worker.shape == (1,) and worker.tolist() == [7]
    assert wide.dtype == torch.int32 and wide.tolist() == [7] * 3
    assert jax_make_deposit_tag(jnp.asarray(7)).shape == ()


# ----------------------------------------------------------------------------
# the exchange on VmapComm against JAX's

# skew driven in: before epoch e the tags of every written slot are set
# this many epochs older, in both packages' states (k_eff 1 -> 3 -> 1 at
# k_max 3 over DRIVEN_EPOCHS)
DRIVE = {4: 3, 5: 4, 6: 5}
DRIVEN_EPOCHS = 20
EXCHANGE = ([(k, ov, p, c, "zero") for k in (1, 3) for ov in (False, True)
             for p in ("fp32", "bf16") for c in (0, 16)
             if k == 3 or (p, c) == ("fp32", 0)]
            + [(3, ov, p, c, "driven") for ov in (False, True)
               for p, c in (("fp32", 0), ("bf16", 16))]
            + [(1, True, "fp32", 0, "driven")])


def _age_tags(jst, pst, by):
    tags = np.asarray(jst["mailbox"]["tag"])
    old = np.where(tags >= 0, tags - by, tags).astype(np.int32)
    jst = dict(jst, mailbox=dict(jst["mailbox"], tag=jnp.asarray(old)))
    pst = dict(pst, mailbox=dict(pst["mailbox"], tag=torch.from_numpy(old)))
    return jst, pst


@pytest.mark.parametrize(
    "k,overlap,precision,chunk,skew", EXCHANGE,
    ids=[f"k{k}-{'overlap' if ov else 'sync'}-{p}-{c}-{s}"
         for k, ov, p, c, s in EXCHANGE])
def test_exchange_is_bitwise_jax(k, overlap, precision, chunk, skew):
    """`exchange_with_obs` at h 4 on 2 x 4 ranks: outputs, SyncState and
    obs rows bitwise JAX's (op by op where skew is driven).  At zero skew
    k_eff stays 1 over 12 epochs; driven, it widens to 3 and narrows
    back to 1 at k_max 3, and under overlap the gate, stretched to open
    up to k_eff epochs before due, ships once in each cycle of 4."""
    jsched, psched = _small_scheds(k, overlap, precision, chunk)
    assert psched.spec.n_segments == jsched.spec.n_segments
    assert (psched.spec.n_segments > 1) == bool(chunk)
    jst, pst = jsched.init_state(R), psched.init_state(R, "cpu")
    _assert_bitwise(pst, jax.tree.leaves(jst), "init_state")
    def exchange(g, st, e):
        return jsched.exchange_with_obs(JaxVmapComm(O, I), g, st, e)
    if skew == "zero":
        exchange = jax.jit(exchange)
    ks, ships = [], []
    for e in range(DRIVEN_EPOCHS if skew == "driven" else 12):
        if skew == "driven" and e in DRIVE:
            jst, pst = _age_tags(jst, pst, DRIVE[e])
        g = _small_grads(e)
        jout, jst, jrow = exchange(jax.tree.map(jnp.asarray, g), jst,
                                   jnp.asarray(e))
        pout, pst, prow = psched.exchange_with_obs(
            VmapComm(O, I), tree_map(torch.from_numpy, g), pst,
            torch.tensor(e, dtype=torch.int32))
        _assert_bitwise((pout, pst, prow), jax.tree.leaves(
            (jout, jst, jrow)), f"epoch {e}")
        ks.append(int(prow["k_eff"][0]))
        ships.append(int(prow["shipped"][0]))
        assert bool((prow["k_eff"] == prow["k_eff"][0]).all())
    assert all(1 <= v <= k for v in ks)
    if skew == "zero":
        assert not bool(pst["ctrl"]["skew_ema"].any())
    if skew == "zero" or k == 1:
        assert set(ks) == {1}
    else:
        assert max(ks) == 3 and ks[-1] == 1
    if overlap:
        assert [sum(ships[c:c + 4]) for c in range(0, len(ships), 4)] == \
            [1] * (len(ships) // 4)
        if k == 3 and skew == "driven":
            assert ships[6] and ships[9]    # 2 and 3 epochs before due
    else:
        assert not any(ships)
    # storage stays flat and in the wire dtype; every slot tagged
    assert pst["mailbox"]["payload"].shape == (R, k, 12)
    assert pst["mailbox"]["payload"].dtype == \
        sync.payload_dtype_of(precision)
    assert bool((pst["mailbox"]["tag"] >= 0).all())


COMBOS = {"rma_adaptive_k3": dict(overlap=False),
          "rma_adaptive_overlap_k3": dict(overlap=True)}


@pytest.mark.parametrize("label", sorted(COMBOS))
def test_combos_rows_at_the_generators_width(label):
    """The adaptive rows of tests/test_chunked_ring.py: 3 epochs of the
    proxy1d generator's payload at h 2, 65,536 B chunked bitwise whole,
    and both bitwise JAX's."""
    runs = {}
    for chunk in (0, CHUNK):
        jcfg, pcfg = _wcfgs(3, chunk=chunk, **COMBOS[label])
        jsched, psched = JW.make_schedule(jcfg), workflow.make_schedule(pcfg)
        assert (psched.spec.n_segments > 1) == bool(chunk)
        exchange = jax.jit(lambda g, st, e: jsched.exchange(
            JaxVmapComm(O, I), g, st, e))
        jst, pst, outs = jsched.init_state(R), psched.init_state(R, "cpu"), []
        for e in range(3):
            rng = np.random.default_rng(17 * e)
            g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
                np.float32), jsched._grads_example(R))
            jout, jst = exchange(jax.tree.map(jnp.asarray, g), jst,
                                 jnp.asarray(e))
            pout, pst = psched.exchange(VmapComm(O, I), tree_map(_t, g),
                                        pst, torch.tensor(e))
            _assert_bitwise((pout, pst), jax.tree.leaves((jout, jst)),
                            f"{label} {chunk} B epoch {e}")
            outs.append((pout, pst))
        runs[chunk] = outs
    for e in range(3):
        _assert_bitwise(runs[CHUNK][e], list(tree_leaves(runs[0][e])),
                        f"{label} epoch {e}: chunked vs whole")


def test_ship_fires_once_a_cycle_while_k_eff_jumps():
    """The row of tests/test_schedule.py: the EMA injected before epochs
    2, 3, 6, 7 puts the lead at 2 on the epoch two before due and back at
    1 on the one before; the ship fires once in each cycle of h 4, as in
    JAX, and the outer mailbox changes exactly then."""
    jsched, psched = _small_scheds(3, True, "fp32", 0, h=4)
    jst, pst = jsched.init_state(R), psched.init_state(R, "cpu")
    inject = {2: 1.25, 3: 0.0, 6: 1.25, 7: 0.0}
    ships, prev = [], pst["outer_mailbox"]
    for e in range(12):
        if e in inject:
            jst["ctrl"]["skew_ema"] = jnp.full((R,), inject[e], jnp.float32)
            pst["ctrl"]["skew_ema"] = torch.full((R,), inject[e])
        g = _small_grads(300 + e)
        jout, jst, jrow = jsched.exchange_with_obs(
            JaxVmapComm(O, I), jax.tree.map(jnp.asarray, g), jst,
            jnp.asarray(e))
        pout, pst, prow = psched.exchange_with_obs(
            VmapComm(O, I), tree_map(torch.from_numpy, g), pst,
            torch.tensor(e, dtype=torch.int32))
        _assert_bitwise((pout, pst, prow), jax.tree.leaves(
            (jout, jst, jrow)), f"epoch {e}")
        ships.append(not torch.equal(pst["outer_mailbox"], prev))
        assert bool(prow["shipped"][0]) == ships[-1]
        prev = pst["outer_mailbox"]
    for c in range(3):
        assert sum(ships[c * 4:(c + 1) * 4]) == 1, (c, ships)
    assert ships[2] and ships[6]       # the stretched gate opened early


def test_exchange_reads_nothing_back(monkeypatch):
    _, pcfg = _wcfgs(3, overlap=True, precision="bf16", chunk=CHUNK)
    sched = workflow.make_schedule(pcfg)
    st = sched.init_state(R, "cpu")
    g = tree_map(lambda t: torch.randn(t.shape), sched.spec.zeros(R))
    for name in READ_BACKS:
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for e in range(3):
        _, st, row = sched.exchange_with_obs(
            VmapComm(O, I), g, st, torch.tensor(e, dtype=torch.int32))
    monkeypatch.undo()
    assert st["mailbox"]["tag"][0].tolist() == [0, 1, 2]
    assert row["k_eff"].tolist() == [1] * R


# ----------------------------------------------------------------------------
# zero skew: bitwise depth-1 rma_arar_arar


@pytest.mark.parametrize("k_max,overlap", [(1, False), (3, False),
                                           (3, True)])
def test_zero_skew_is_bitwise_depth_one(k_max, overlap):
    """2 x 2 ranks, h 2 (a hot pod boundary), 3 epochs of
    `train_stacked`: adaptive at k_max equals static depth 1 (with the
    same overlap) in every leaf outside "sync"."""
    states = {}
    for adaptive in (False, True):
        _, wcfg = _wcfgs(k_max if adaptive else 1, overlap,
                         adaptive=adaptive)
        states[adaptive], _ = workflow.train_stacked(
            0, wcfg, 2, 2, 3, _data(), device="cpu")
    for key in ("gen", "gen_opt", "disc", "disc_opt", "epoch"):
        _bitwise(states[True][key], states[False][key], key)
    ctrl = states[True]["sync"]["ctrl"]
    assert ctrl["k_eff"].tolist() == [1] * 4
    assert not bool(ctrl["skew_ema"].any())


# ----------------------------------------------------------------------------
# the trajectory against JAX's epoch function

TRAJECTORY = [dict(), dict(disc_every=2, gen_every=3)]


@pytest.mark.parametrize("cadence", TRAJECTORY,
                         ids=["every-epoch", "cadence-2-3"])
def test_trajectory_matches_jax(cadence):
    """6 epochs adaptive at k_max 3 with overlap at h 2 from a JAX
    `init_run` state (its adaptive sync state from the JAX schedule)
    with JAX's draws: losses with their NaNs, predicted parameters, then
    every state leaf, the controller and the tags included."""
    jcfg, pcfg = _wcfgs(3, overlap=True, small=False, **cadence)
    jstate, jdata = _jax_init_run()
    jstate = dict(jax.tree.map(jnp.copy, jstate),
                  sync=JW.make_schedule(jcfg).init_state(4))
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    pstate, pdata = gan_state_from_numpy(flat, "cpu"), _t(jdata)
    assert pstate["sync"]["mailbox"]["tag"].dtype == torch.int32
    jepoch = JW.make_epoch_fn_vmap(2, 2, jcfg)
    pepoch = workflow.make_epoch_fn(2, 2, pcfg)
    draw = jax.jit(lambda rng: jax_draws(rng, jcfg, jdata.shape[1],
                                         to_port=False))
    for e in range(6):
        draws = {k: _t(v) for k, v in draw(jstate["rng"]).items()}
        draws["idx"] = draws["idx"].to(torch.int64)
        jstate, jm = jepoch(jstate, jdata)
        pstate, pm = pepoch(pstate, pdata, draws, e)
        for k, ran in zip(("d_loss", "g_loss"), workflow.due(pcfg, e)):
            assert bool(pm[k].isnan().all()) != ran, (e, k)
            np.testing.assert_allclose(_np(pm[k]), np.asarray(jm[k]),
                                       err_msg=f"epoch {e} {k}", **FP32)
    assert_state_close(pstate, jstate)
    # the tags and the controller exactly
    np.testing.assert_array_equal(_np(pstate["sync"]["mailbox"]["tag"]),
                                  np.asarray(jstate["sync"]["mailbox"]["tag"]))
    for key, t in pstate["sync"]["ctrl"].items():
        np.testing.assert_array_equal(_np(t), np.asarray(
            jstate["sync"]["ctrl"][key]), err_msg=key)
    # the tags name the generator's epochs, in slot epoch % 3
    gen = [e for e in range(6) if workflow.due(pcfg, e)[1]]
    want = [-1] * 3
    for e in gen:
        want[e % 3] = e
    assert pstate["sync"]["mailbox"]["tag"][0].tolist() == want


# ----------------------------------------------------------------------------
# the state's layout and checkpoints


def test_state_layout_and_checkpoints_match_jax(tmp_path):
    jcfg, pcfg = _wcfgs(3, overlap=True, precision="bf16")
    like = jax.eval_shape(lambda key: JW.init_state(key, 4, jcfg),
                          jax.random.PRNGKey(0))
    want = {k: v for k, v in jax_flatten(like).items()
            if not k.startswith("rng")}
    pstate = workflow.init_state(torch.Generator().manual_seed(0), 4, pcfg,
                                 device="cpu")
    got = dict(tree_paths(pstate))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == np.dtype(v.dtype).name, k
    assert got["sync/mailbox/payload"].shape == (4, 3, 50_816)
    assert got["sync/mailbox/tag"].tolist() == [[-1] * 3] * 4
    assert got["sync/ctrl/shipped_for"].tolist() == [-1] * 4
    # the port's store round-trips the int32 tags and controller
    d = str(tmp_path / "ck")
    state, _ = workflow.train_stacked(0, pcfg, 2, 2, 4, _data(),
                                      checkpoint_every=4, checkpoint_dir=d,
                                      device="cpu")
    back, step = restore_latest(d, state)
    assert step == 4
    _bitwise(back, state, "port store round trip")
    # the JAX store reads it into its own template ...
    restored, step = jax_restore_latest(d, jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), like))
    assert step == 4
    flat = {k: np.asarray(v) for k, v in jax_flatten(restored).items()}
    for k, t in tree_paths(state):
        assert flat[k].dtype == np.dtype(want[k].dtype), k
    # ... and that JAX state comes back into the port bitwise
    _bitwise(gan_state_from_numpy(flat, "cpu"), state, "JAX state -> port")
    assert state["sync"]["mailbox"]["tag"][0].tolist() == [3, 1, 2]


def test_resume_off_the_slot_grid_is_bitwise(tmp_path):
    _, wcfg = _wcfgs(3, overlap=True)
    data = _data()
    full, _ = workflow.train_stacked(0, wcfg, 2, 2, 7, data, device="cpu")
    d = str(tmp_path / "ck")
    workflow.train_stacked(0, wcfg, 2, 2, 4, data, checkpoint_every=4,
                           checkpoint_dir=d, device="cpu")
    res, _ = workflow.train_stacked(0, wcfg, 2, 2, 7, data,
                                    checkpoint_every=4, checkpoint_dir=d,
                                    resume=True, device="cpu")
    _bitwise(res, full, "resumed at epoch 4")


# ----------------------------------------------------------------------------
# the proc runtime


def test_proc_lockstep_adaptive_overlap_is_bitwise_its_reference(tmp_path):
    """The port's row of tests/test_runtime.py:407: 2 lock-step workers
    at 2 x 1, adaptive at k_max 3 with overlap at h 2, 5 epochs: the
    bundled payload and tag, the pmean board and the stretched ship
    gate, bitwise `lockstep_reference`; the state in JAX's layout; skew
    0 and k_eff 1 on every rank; resumed from the per-process checkpoint
    at epoch 3 (the [1, 3, D] payload, its tags and the controller)
    bitwise again."""
    jcfg, wcfg = _wcfgs(3, overlap=True)
    d = str(tmp_path / "run")
    out = run_proc(wcfg, 2, 1, 5, _data(), seed=0, run_dir=d, device="cpu",
                   ckpt_every=3, timeout=300)
    ref = lockstep_reference(0, wcfg, 2, 1, 5, _data(), device="cpu")
    _bitwise(out["state"], ref, "2 workers, adaptive + overlap")
    like = jax.eval_shape(lambda key: JW.init_state(key, 2, jcfg),
                          jax.random.PRNGKey(0))
    want = {k: (v.shape, np.dtype(v.dtype).name)
            for k, v in jax_flatten(like).items() if not k.startswith("rng")}
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in tree_paths(out["state"])} == want
    assert [s["max_skew_ema"] for s in out["summaries"]] == [0.0, 0.0]
    assert [s["max_k_eff"] for s in out["summaries"]] == [1, 1]
    assert out["history"]["k_eff"].shape == (5, 2)
    assert out["state"]["sync"]["mailbox"]["tag"].tolist() == \
        [[3, 4, 2]] * 2
    assert out["state"]["sync"]["ctrl"]["shipped_for"].tolist() == [4, 4]
    # one inner deposit window, none (n_inner 1); the ship window holds
    # the payload's bytes, the board one fp32 skew
    from repro_torch.runtime.mailbox import _MBX_HDR
    with open(os.path.join(d, "mbx_0to1_ship.bin"), "rb") as f:
        wseq, _, tag, nbytes = _MBX_HDR.unpack(f.read(_MBX_HDR.size))
    assert (wseq, tag, nbytes) == (2, 3, 203_264)
    assert not any("_inner" in n for n in os.listdir(d))
    res = run_proc(wcfg, 2, 1, 5, _data(), seed=0, run_dir=d, device="cpu",
                   ckpt_every=3, resume=True, timeout=300)
    assert [s["start_epoch"] for s in res["summaries"]] == [3, 3]
    _bitwise(res["state"], ref, "resumed at epoch 3")


def test_proc_bundled_deposit_and_warmup(tmp_path):
    """A `ProcComm` pair at 1 x 2 in threads: the bundled {"w", "tag"}
    tree crosses as one serialized payload, 4 + 48 bytes in 52-byte
    windows of 16, the tag first (`jax.tree.leaves` order); a free
    read before any deposit is zeros and a -1 tag; the board carries
    one fp32 skew."""
    import threading
    from repro_torch.runtime.mailbox import _MBX_HDR
    from repro_torch.runtime.proccomm import ProcComm
    d = str(tmp_path)
    tree = [{"w": torch.arange(12, dtype=torch.float32) + 100 * r,
             "tag": torch.tensor([7 + r], dtype=torch.int32)}
            for r in range(2)]
    got = [None, None]

    def run(r):
        c = ProcComm(1, 2, r, d, window_bytes=16, timeout=60)
        c.begin_epoch(7)
        got[r] = (c.recv_ring_inner(tree[r]),
                  c.pmean_all(torch.tensor([float(r)])))
        c.close()
    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for r in range(2):
        recv, skew = got[r]
        assert torch.equal(recv["w"], tree[1 - r]["w"])
        assert recv["tag"].dtype == torch.int32 and \
            recv["tag"].tolist() == [8 - r]
        assert skew.dtype == torch.float32 and skew.tolist() == [0.5]
    sizes = [os.path.getsize(os.path.join(d, f"mbx_0to1_innerw{i}.bin"))
             - _MBX_HDR.size for i in range(4)]
    assert sizes == [16, 16, 16, 4]
    with open(os.path.join(d, "mbx_0to1_innerw0.bin"), "rb") as f:
        f.seek(_MBX_HDR.size)
        assert np.frombuffer(f.read(4), np.int32).tolist() == [7]
    # free-running, nothing deposited yet: the warmup value
    free = ProcComm(1, 2, 0, str(tmp_path / "free"), lockstep=False,
                    timeout=5)
    os.makedirs(free.run_dir)
    warm = free.recv_ring_inner(tree[0])
    free.close()
    assert warm["tag"].tolist() == [-1] and not bool(warm["w"].any())


def test_proc_free_run_measures_skew_and_widens_k_eff(tmp_path):
    """The port's row of tests/test_runtime.py:443: 2 free-running
    workers at 1 x 2, rank 1 60 ms late an epoch, adaptive at k_max 4
    over 30 epochs: finite, skew measured, k_eff off 1 and within
    [1, 4]; the traces carry the controller's counters each epoch."""
    _, wcfg = _wcfgs(4, h=1000)
    wcfg = dataclasses.replace(wcfg, obs=dataclasses.replace(
        wcfg.obs, trace_dir="trace"))
    d = str(tmp_path / "run")
    out = run_proc(wcfg, 1, 2, 30, _data(), seed=0, run_dir=d, device="cpu",
                   lockstep=False, jitter=JitterConfig(rank_lag_ms=60.0),
                   timeout=300)
    assert all(not s["lockstep"] for s in out["summaries"])
    for k, t in tree_paths(out["state"]):
        assert bool(torch.isfinite(t.float()).all()), k
    h = out["history"]
    assert h["d_loss"].shape == (30, 2) and bool(
        torch.isfinite(h["d_loss"]).all())
    assert max(s["max_skew_ema"] for s in out["summaries"]) > 0.0
    assert 1 < max(s["max_k_eff"] for s in out["summaries"]) <= 4
    assert h["k_eff"].min() >= 1 and h["k_eff"].max() <= 4
    for r in range(2):
        with open(os.path.join(d, "trace", f"trace_rank{r}.jsonl")) as f:
            evs = [json.loads(line) for line in f]
        counters = {n: [e["args"][n] for e in evs
                        if e.get("ph") == "C" and e["name"] == n]
                    for n in ("skew_ema", "k_eff")}
        assert counters["k_eff"] == [int(v) for v in h["k_eff"][:, r]]
        assert len(counters["skew_ema"]) == 30
        np.testing.assert_array_equal(
            np.asarray(counters["skew_ema"], np.float32),
            h["skew_ema"][:, r].numpy())


# ----------------------------------------------------------------------------
# the CLI


def test_train_gan_cli_adaptive_on_both_backends(capsys):
    from repro_torch.launch import train_gan
    train_gan.main(["--device", "cpu", "--ranks", "4", "--inner", "2",
                    "--epochs", "4", "--h", "2", "--events", "1000",
                    "--param-samples", "8", "--sync-schedule",
                    "adaptive-overlap", "--max-staleness", "3"])
    out = capsys.readouterr().out
    assert "schedule=adaptive staleness=3" in out
    state = train_gan.main(["--device", "cpu", "--backend", "proc",
                            "--num-procs", "2", "--epochs", "3",
                            "--param-samples", "8", "--events", "1000",
                            "--sync-schedule", "adaptive"])
    out = capsys.readouterr().out
    assert "schedule=adaptive staleness=4" in out
    for r in (0, 1):
        assert f"rank {r} on cpu: 3 epochs from 0" in out
    assert out.count("max_skew_ema=0.00 max_k_eff=1") == 2
    assert state["sync"]["mailbox"]["payload"].shape[:2] == (2, 4)
    with pytest.raises(SystemExit):
        train_gan.main(["--device", "cpu", "--mode", "arar_arar",
                        "--sync-schedule", "adaptive"])
