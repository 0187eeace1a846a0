"""The overlapped pod-boundary exchange (`SyncConfig(overlap=True)`,
ROADMAP.md queue A item 3f) of the port against the JAX package, on the
CPU.

A due epoch (`epoch % h == 0`, inner index 0) adds the flat outer
mailbox, what the predecessor pod shipped the epoch before; the epoch
before a due one ships its inner-synced payload into that mailbox.

The port's rows of tests/test_overlap.py, each also held bitwise against
JAX's `sync_gradients` on the same arrays where it runs the exchange:

  read        the outer read is exactly one epoch old (h 1)
  gate        ships only on the epoch before due (h 3); the mailbox is
              frozen between ships
  depth       overlap composes with the depth-k inner mailbox
  degenerate  overlap is bitwise fused sync with no pod boundary
              (proxy2d, linear_blur) and when the outer ring is never due
  trains      overlap trains and differs from sync across pods
  config      validation and the missing outer mailbox, word for word
  layout      `zero_payload` per rank and stacked

and rows against JAX:

  schedule    6 epochs of `StaticSchedule.exchange` on `VmapComm` 2 x 2
              at h 2, k 1 and 2, fp32 and bf16 (tests/test_precision.py
              `bf16_overlap`), whole and at 65,536 B (the `rma_overlap`
              row of tests/test_chunked_ring.py): outputs and SyncState
              bitwise JAX's, chunked bitwise whole
  name        `make_schedule(...).name == "overlap"`
              (tests/test_schedule.py)
  obs         `shipped`, `ship_count` and `exchange_count` of 4 epochs
              against JAX's `train_vmap` (tests/test_obs.py)
  trajectory  6 epochs against JAX's `make_epoch_fn_vmap` from a JAX
              state, every epoch and at disc_every 2, gen_every 3
  proc        2 lock-step workers at 2 x 1 bitwise `lockstep_reference`

JAX's two rows that lower HLO (`test_overlap_ship_is_conditional_in_
lowered_epoch`, `test_overlap_epoch_keeps_state_donation_aliasing`) have
no torch form.  In their place: a `ProcComm` worker writes the ship
channel on the ship epochs only (its trace's `exchange.ship` spans and
the window's entry count) and never the outer ring's, and an overlap
epoch on `VmapComm` reads nothing back to the host.

The card's side is in tests/test_torch_cuda.py and `chip_smoke.py`
phases 46-47.
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

from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ring import VmapComm as JaxVmapComm
from repro.obs.config import ObsConfig as JaxObsConfig

from repro_torch.checkpoint.store import gan_state_from_numpy
from repro_torch.core import sync, workflow
from repro_torch.core.ring import VmapComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.obs import ObsConfig
from repro_torch.problems import get_problem
from repro_torch.runtime.launch import lockstep_reference, run_proc

from test_torch_chunked import CHUNK, _assert_bitwise
from test_torch_gan import (FP32, SMOKE, _jax_init_run, _np, _t,
                            assert_state_close, jax_draws)

O, I = 2, 2
R = O * I
MASK = {"w": True, "b": False}
EPOCHS = 6


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wcfgs(k=1, precision="fp32", chunk=0, small=True, obs=None, **kw):
    """The same proxy1d settings, rma_arar_arar with overlap at h 2, as a
    JAX and a port config (`small`: 8 x 4 events a rank, else the smoke
    sizes)."""
    s = dict(mode="rma_arar_arar", h=2, staleness=k, overlap=True,
             payload_precision=precision, ring_chunking=chunk)
    sizes = dict(n_param_samples=8, events_per_sample=4) if small else SMOKE
    kw = dict(sizes, problem="proxy1d", **kw)
    obs = obs or {}
    return (JW.WorkflowConfig(sync=JS.SyncConfig(**s),
                              obs=JaxObsConfig(**obs), **kw),
            workflow.WorkflowConfig(sync=sync.SyncConfig(**s),
                                    obs=ObsConfig(**obs), **kw))


def _data(problem="proxy1d", n=400):
    return get_problem(problem).make_reference_data(
        torch.Generator().manual_seed(7), n, device="cpu")


def _grads(seed, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((R,) + shape).astype(np.float32),
            "b": rng.standard_normal((R, shape[-1])).astype(np.float32)}


def _inner_sync(w):
    """numpy: w_i + w_{i-1 mod I} within each inner group."""
    x = w.reshape((O, I) + w.shape[1:])
    return (x + np.roll(x, 1, axis=1)).reshape(w.shape)


def _roll_outer(w):
    return np.roll(w.reshape((O, I) + w.shape[1:]), 1, axis=0).reshape(
        w.shape)


def _zero_outer(g):
    spec = sync.FusionSpec.build(tree_map(lambda x: x[0], g), MASK)
    return spec.zero_payload(R)


class Pair:
    """The port's and JAX's `sync_gradients` run side by side on the same
    arrays; every call checks the outputs and mailboxes bit for bit."""

    def __init__(self, **cfg):
        self.p, self.j = sync.SyncConfig(**cfg), JS.SyncConfig(**cfg)
        self.k = cfg.get("staleness", 1)

    def init(self, g):
        t = tree_map(_t, g)
        jg = jax.tree.map(jnp.asarray, g)
        self.pmb = sync.init_mailbox(t, self.k, stacked=True)
        self.jmb = JS.init_mailbox(jg, staleness=self.k, stacked=True)
        self.pomb = _zero_outer(t)
        self.jomb = jnp.zeros(self.pomb.shape, jnp.float32)

    def step(self, g, e, comm=(O, I)):
        out, self.pmb, self.pomb = sync.sync_gradients(
            VmapComm(*comm), self.p, tree_map(_t, g), self.pmb,
            torch.tensor(e), MASK, outer_mailbox=self.pomb)
        jout, self.jmb, self.jomb = JS.sync_gradients(
            JaxVmapComm(*comm), self.j, jax.tree.map(jnp.asarray, g),
            self.jmb, jnp.asarray(e), MASK, outer_mailbox=self.jomb)
        _assert_bitwise({"o": out, "m": self.pmb, "om": self.pomb},
                        jax.tree.leaves({"o": jout, "m": self.jmb,
                                         "om": self.jomb}), f"epoch {e}")
        return out


# ----------------------------------------------------------------------------
# the rows of tests/test_overlap.py


def test_outer_read_is_exactly_one_epoch_old():
    """h 1: epoch e's members add the outer ring's ship of epoch e - 1's
    inner-synced payload (zeros at epoch 0), not epoch e's."""
    pair = Pair(mode="arar_arar", h=1, overlap=True)
    gs = [_grads(10 + e) for e in range(5)]
    pair.init(gs[0])
    member = (np.arange(R) % I == 0)[:, None, None]
    for e in range(5):
        out = pair.step(gs[e], e)
        base = _inner_sync(gs[e]["w"])
        read = _roll_outer(_inner_sync(gs[e - 1]["w"])) if e else 0.0
        np.testing.assert_allclose(_np(out["w"]),
                                   np.where(member, base + read, base),
                                   rtol=1e-6, err_msg=f"epoch {e}")
        np.testing.assert_array_equal(_np(out["b"]), gs[e]["b"])


def test_ship_gated_to_epoch_before_due():
    """h 3: ships at epochs 2 and 5 only; the due combine at 3 reads
    epoch 2's payload, and the mailbox is frozen between ships."""
    pair = Pair(mode="arar_arar", h=3, overlap=True)
    gs = [_grads(40 + e) for e in range(7)]
    pair.init(gs[0])
    member = (np.arange(R) % I == 0)[:, None, None]
    boxes = []
    for e in range(7):
        out = pair.step(gs[e], e)
        boxes.append(_np(pair.pomb))
        base = _inner_sync(gs[e]["w"])
        if e % 3 == 0:
            read = _roll_outer(_inner_sync(gs[e - 1]["w"])) if e else 0.0
            base = np.where(member, base + read, base)
        np.testing.assert_allclose(_np(out["w"]), base, rtol=1e-6,
                                   err_msg=f"epoch {e}")
    assert not boxes[0].any()
    np.testing.assert_array_equal(boxes[1], boxes[0])
    assert np.abs(boxes[2]).max() > 0                    # the first ship
    np.testing.assert_array_equal(boxes[3], boxes[2])
    np.testing.assert_array_equal(boxes[4], boxes[2])
    assert np.abs(boxes[5] - boxes[4]).max() > 0         # the second
    np.testing.assert_array_equal(boxes[6], boxes[5])


def test_composes_with_depth_k_inner_mailbox():
    """rma_arar_arar at k 2 with overlap, h 1: inner reads k epochs old,
    the outer read one epoch old."""
    k = 2
    pair = Pair(mode="rma_arar_arar", h=1, staleness=k, overlap=True)
    gs = [_grads(70 + e) for e in range(6)]
    pair.init(gs[0])
    member = (np.arange(R) % I == 0)[:, None, None]

    def rma_inner(e):
        w = gs[e]["w"]
        if e < k:
            return w
        x = gs[e - k]["w"].reshape((O, I) + w.shape[1:])
        return w + np.roll(x, 1, axis=1).reshape(w.shape)
    for e in range(6):
        out = pair.step(gs[e], e)
        base = rma_inner(e)
        read = _roll_outer(rma_inner(e - 1)) if e else 0.0
        np.testing.assert_allclose(_np(out["w"]),
                                   np.where(member, base + read, base),
                                   rtol=1e-6, err_msg=f"epoch {e}")


def _gens(name, n_outer, n_inner, h, sync_kw, epochs=3):
    """The generators after `epochs` of `train_stacked`, overlap off and
    on."""
    gens = {}
    for overlap in (False, True):
        wcfg = workflow.WorkflowConfig(
            problem=name, n_param_samples=8, events_per_sample=4,
            sync=sync.SyncConfig(h=h, overlap=overlap, **sync_kw))
        state, _ = workflow.train_stacked(0, wcfg, n_outer, n_inner, epochs,
                                          _data(name), device="cpu")
        for k, t in tree_paths(state):
            assert bool(torch.isfinite(t.float()).all()), k
        gens[overlap] = state["gen"]
    return gens


@pytest.mark.parametrize("name", ["proxy2d", "linear_blur"])
def test_matches_fused_sync_without_pod_boundary(name):
    """n_outer 1: no slow link, so overlap is bitwise fused sync."""
    gens = _gens(name, 1, 4, 2, dict(mode="rma_arar_arar"))
    _assert_bitwise(gens[True], tree_leaves(gens[False]),
                    f"{name}: overlap vs sync")


def test_matches_fused_sync_when_outer_never_due():
    """Epochs 1-5 at h 10,000: neither a ship nor a consume fires, and
    the overlap exchange is bitwise the sync one; the mailbox stays
    zero."""
    omb = None
    for e in range(1, 6):
        g = tree_map(_t, _grads(90 + e))
        omb = _zero_outer(g) if omb is None else omb
        want, _ = sync.sync_gradients(
            VmapComm(O, I), sync.SyncConfig(mode="arar_arar", h=10_000), g,
            sync.init_mailbox(g), torch.tensor(e), MASK)
        got, _, omb = sync.sync_gradients(
            VmapComm(O, I), sync.SyncConfig(mode="arar_arar", h=10_000,
                                            overlap=True), g,
            sync.init_mailbox(g), torch.tensor(e), MASK, outer_mailbox=omb)
        _assert_bitwise(got, want, f"epoch {e}")
    assert not bool(omb.any())


def test_trains_and_differs_from_sync_across_pods():
    """A hot pod boundary (h 1, 2 x 2): overlap trains finite and is not
    the sync trajectory."""
    gens = _gens("proxy1d", 2, 2, 1, dict(mode="arar_arar"))
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(gens[False]), tree_leaves(gens[True])))


CONFIGS = [dict(mode="arar_arar", overlap=True),
           dict(mode="rma_arar_arar", staleness=3, overlap=True),
           dict(mode="rma_arar_arar", overlap=True,
                payload_precision="bf16", ring_chunking=4096)]
BAD = [dict(mode="conv_arar", overlap=True),
       dict(mode="allreduce", overlap=True),
       dict(mode="dbtree", overlap=True),
       dict(mode="arar_arar", fuse_tensors=False, overlap=True)]


@pytest.mark.parametrize("kw", CONFIGS + BAD, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_config_validation_matches_jax(kw):
    assert sync.SyncConfig().overlap is False
    if kw in CONFIGS:
        assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
            dataclasses.asdict(JS.SyncConfig(**kw))
        return
    with pytest.raises(ValueError) as want:
        JS.SyncConfig(**kw)
    with pytest.raises(ValueError) as got:
        sync.SyncConfig(**kw)
    assert str(got.value) == str(want.value)


def test_overlap_requires_outer_mailbox():
    g = _grads(1)
    with pytest.raises(ValueError) as want:
        JS.sync_gradients(JaxVmapComm(O, I), JS.SyncConfig(overlap=True),
                          jax.tree.map(jnp.asarray, g),
                          JS.init_mailbox(jax.tree.map(jnp.asarray, g)),
                          jnp.asarray(0), MASK)
    t = tree_map(_t, g)
    with pytest.raises(ValueError) as got:
        sync.sync_gradients(VmapComm(O, I), sync.SyncConfig(overlap=True),
                            t, sync.init_mailbox(t), torch.tensor(0), MASK)
    assert str(got.value) == str(want.value)
    assert "outer mailbox" in str(got.value)


def test_zero_payload_layouts():
    example = [{"w": torch.zeros(3, 4), "b": torch.zeros(4)}]
    spec = sync.FusionSpec.build(example, [MASK])
    assert spec.zero_payload().shape == (12,)
    assert spec.zero_payload(8).shape == (8, 12)
    assert spec.zero_payload().dtype == spec.payload_dtype
    bf16 = sync.FusionSpec.build(example, [MASK],
                                 payload_dtype=torch.bfloat16)
    assert bf16.zero_payload(8).dtype == torch.bfloat16


# ----------------------------------------------------------------------------
# the schedule on VmapComm against JAX's

SCHEDULE = [(k, p, c) for k in (1, 2) for p in ("fp32", "bf16")
            for c in (0, CHUNK)]


def _sched_grads(example, e):
    rng = np.random.default_rng(300 + e)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), example)


def _port_exchange(wcfg, grads):
    sched = workflow.make_schedule(wcfg)
    st, outs = sched.init_state(R, "cpu"), []
    for e, g in enumerate(grads):
        out, st = sched.exchange(VmapComm(O, I), tree_map(_t, g), st,
                                 torch.tensor(e, dtype=torch.int32))
        outs.append((out, st))
    return sched, outs


@pytest.mark.parametrize("k,precision,chunk", SCHEDULE,
                         ids=[f"k{k}-{p}-{c}" for k, p, c in SCHEDULE])
def test_exchange_is_bitwise_jax_and_chunked_is_whole(k, precision, chunk):
    """h 2 over 6 epochs: ships at 1, 3, 5 and due combines at 0, 2, 4."""
    jcfg, pcfg = _wcfgs(k, precision, chunk)
    jsched = JW.make_schedule(jcfg)
    grads = [_sched_grads(jsched._grads_example(R), e)
             for e in range(EPOCHS)]
    exchange = jax.jit(lambda g, st, e: jsched.exchange(
        JaxVmapComm(O, I), g, st, e))
    jst = jsched.init_state(R)
    sched, got = _port_exchange(pcfg, grads)
    assert sched.spec.n_segments == jsched.spec.n_segments
    assert (sched.spec.n_segments > 1) == bool(chunk)
    for e in range(EPOCHS):
        out, jst = exchange(jax.tree.map(jnp.asarray, grads[e]), jst,
                            jnp.asarray(e))
        _assert_bitwise(got[e], jax.tree.leaves((out, jst)),
                        f"k {k} {precision} epoch {e}")
    if chunk:
        _, whole = _port_exchange(_wcfgs(k, precision)[1], grads)
        for e in range(EPOCHS):
            _assert_bitwise(got[e], list(tree_leaves(whole[e])),
                            f"k {k} {precision} epoch {e}: chunked vs whole")
    # the outer mailbox: flat, in the wire dtype, written by the ships
    omb = [st["outer_mailbox"] for _, st in got]
    assert omb[0].shape == (R, sched.spec.total)
    assert omb[0].dtype == sync.payload_dtype_of(precision)
    assert not bool(omb[0].float().any()) and bool(omb[1].float().any())
    assert torch.equal(omb[2], omb[1]) and not torch.equal(omb[3], omb[2])


def test_schedule_name_matches_jax():
    for kw in (dict(mode="arar_arar", overlap=True), dict(mode="arar_arar"),
               dict(mode="rma_arar_arar", staleness=2, overlap=True)):
        p = workflow.make_schedule(workflow.WorkflowConfig(
            sync=sync.SyncConfig(**kw)))
        j = JW.make_schedule(JW.WorkflowConfig(sync=JS.SyncConfig(**kw)))
        assert p.name == j.name == ("overlap" if kw.get("overlap")
                                    else "sync")


def test_overlap_epoch_reads_nothing_back(monkeypatch):
    _, wcfg = _wcfgs(2, "bf16", CHUNK, obs=dict(metrics=True))
    g = torch.Generator().manual_seed(0)
    state, data = workflow.init_run(g, R, wcfg, _data(), "cpu")
    epoch = workflow.make_epoch_fn(O, I, wcfg)
    draws = [workflow.make_draws(g, wcfg, R, data.shape[1])
             for _ in range(4)]
    for name in ("item", "tolist", "__int__", "__index__", "__float__",
                 "__bool__"):
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for e in range(4):
        state, metrics = epoch(state, data, draws[e], e)
    monkeypatch.undo()
    assert metrics["obs"]["ship_count"].tolist() == [2] * R
    assert bool(state["sync"]["outer_mailbox"].float().any())


# ----------------------------------------------------------------------------
# the obs channel's ship flag and the trajectory against JAX


def test_ship_count_on_ship_epochs_matches_jax():
    jcfg, pcfg = _wcfgs(2, obs=dict(metrics=True))
    jdata = jcfg.problem_obj.make_reference_data(jax.random.PRNGKey(7), 400)
    _, jhist = JW.train_vmap(jax.random.PRNGKey(0), jcfg, O, I, 4, jdata,
                             checkpoint_every=1)
    _, phist = workflow.train_stacked(0, pcfg, O, I, 4, _data(),
                                      checkpoint_every=1, device="cpu")
    for k in ("shipped", "ship_count", "exchange_count", "k_eff"):
        got, want = phist["obs"][k], np.asarray(jhist["obs"][k])
        assert str(got.dtype).split(".")[1] == want.dtype.name, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    assert phist["obs"]["shipped"][:, 0].tolist() == [0, 1, 0, 1]
    assert phist["obs"]["ship_count"][:, 0].tolist() == [0, 1, 1, 2]
    assert phist["obs"]["exchange_count"][:, 0].tolist() == [1, 2, 3, 4]
    # no pod boundary: nothing ships
    _, flat = workflow.train_stacked(0, pcfg, 1, R, 2, _data(),
                                     checkpoint_every=1, device="cpu")
    assert not bool(flat["obs"]["ship_count"].any())


TRAJECTORY = [dict(), dict(disc_every=2, gen_every=3)]


@pytest.mark.parametrize("cadence", TRAJECTORY,
                         ids=["every-epoch", "cadence-2-3"])
def test_trajectory_matches_jax(cadence):
    """6 epochs with overlap at h 2, k 2 from a JAX `init_run` state with
    JAX's draws: losses with their NaNs, predicted parameters, then every
    state leaf, the outer mailbox included.  Under the cadence an off
    generator epoch ships nothing."""
    jcfg, pcfg = _wcfgs(2, small=False, **cadence)
    jstate, jdata = _jax_init_run()
    jstate = dict(jax.tree.map(jnp.copy, jstate),
                  sync=JW.make_schedule(jcfg).init_state(R))
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    pstate, pdata = gan_state_from_numpy(flat, "cpu"), _t(jdata)
    jepoch = JW.make_epoch_fn_vmap(O, I, jcfg)
    pepoch = workflow.make_epoch_fn(O, I, pcfg)
    draw = jax.jit(lambda rng: jax_draws(rng, jcfg, jdata.shape[1],
                                         to_port=False))
    ships = []
    for e in range(EPOCHS):
        draws = {k: _t(v) for k, v in draw(jstate["rng"]).items()}
        draws["idx"] = draws["idx"].to(torch.int64)
        before = pstate["sync"]["outer_mailbox"].clone()
        jstate, jm = jepoch(jstate, jdata)
        pstate, pm = pepoch(pstate, pdata, draws, e)
        ships.append(not torch.equal(before,
                                     pstate["sync"]["outer_mailbox"]))
        for key, ran in zip(("d_loss", "g_loss"), workflow.due(pcfg, e)):
            assert bool(pm[key].isnan().all()) != ran, (e, key)
            np.testing.assert_allclose(_np(pm[key]), np.asarray(jm[key]),
                                       err_msg=f"epoch {e} {key}", **FP32)
        np.testing.assert_allclose(_np(pm["pred_params"]),
                                   np.asarray(jm["pred_params"]),
                                   err_msg=f"epoch {e}", **FP32)
    assert_state_close(pstate, jstate)
    # a ship on each of the generator's epochs e with (e + 1) % 2 == 0
    assert ships == [workflow.due(pcfg, e)[1] and (e + 1) % 2 == 0
                     for e in range(EPOCHS)]


# ----------------------------------------------------------------------------
# the proc runtime


def _ship_spans(trace_path):
    with open(trace_path) as f:
        evs = [json.loads(line) for line in f]
    return {name: [e["args"]["epoch"] for e in evs
                   if e.get("ph") == "X" and e["name"] == name]
            for name in ("exchange.ship", "exchange.outer",
                         "exchange.inner")}


def test_proc_lockstep_overlap_is_bitwise_its_reference(tmp_path):
    """2 lock-step workers at 2 x 1 (one rank a pod, every rank a member)
    with overlap at h 2 over 5 epochs: bitwise `lockstep_reference`; the
    ship channel written on epochs 1 and 3 only, the outer ring's never;
    the window holds 2 entries, the last tagged epoch 3."""
    from repro_torch.runtime.mailbox import _MBX_HDR
    _, wcfg = _wcfgs(1, obs=dict(metrics=True, trace_dir="trace"))
    d = str(tmp_path / "run")
    out = run_proc(wcfg, 2, 1, 5, _data(), seed=0, run_dir=d, device="cpu",
                   timeout=300)
    ref = lockstep_reference(0, wcfg, 2, 1, 5, _data(), device="cpu")
    _assert_bitwise(out["state"], ref, "2 workers at 2 x 1 with overlap")
    assert bool(out["state"]["sync"]["outer_mailbox"].any())
    assert [s["obs"]["ship_count"] for s in out["summaries"]] == [2, 2]
    for r in (0, 1):
        spans = _ship_spans(os.path.join(d, "trace", f"trace_rank{r}.jsonl"))
        assert spans == {"exchange.ship": [1, 3], "exchange.outer": [],
                         "exchange.inner": []}
        with open(os.path.join(d, f"mbx_{r}to{1 - r}_ship.bin"), "rb") as f:
            wseq, _, tag, nbytes = _MBX_HDR.unpack(f.read(_MBX_HDR.size))
        assert (wseq, tag, nbytes) == (2, 3, 203_264)
    assert not any(n.endswith("_outer.bin") for n in os.listdir(d))
