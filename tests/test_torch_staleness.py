"""The depth-k RMA mailbox (`SyncConfig(mode="rma_arar_arar",
staleness=k)`, ROADMAP.md queue A item 3d) of the port against the JAX
package, on the CPU.

At epoch e a rank reads slot e % k of its [R, k, ...] mailbox, the deposit
its ring predecessor made at epoch e - k (zeros for e < k), and deposits
this epoch's payload into the same slot:

  pin         the port's row of tests/test_sync.py::
              test_rma_mailbox_depth_k_reads_exactly_k_epochs_old at R 4,
              k 3 over 6 epochs, and `sync_gradients` bitwise JAX's on the
              same arrays, outputs and every mailbox leaf
  schedule    6 epochs of `StaticSchedule.exchange` on `VmapComm` 2 x 4 at
              h 2, k 2 and 3, fp32 and bf16, unchunked and at 65,536 B
              (k 2 fp32 chunked is the `rma_k2` row of
              tests/test_chunked_ring.py): outputs and SyncState bitwise
              JAX's, dtypes included, and chunked bitwise unchunked
  read-back   a depth-3 exchange with `Tensor.item` and the other host
              conversions patched to raise
  layout      `init_state` at k 3 leaf for leaf JAX's (bf16 mailbox
              weights), `gan_state_from_numpy` of a JAX depth-k state,
              the JAX store reading a port depth-3 checkpoint
  trajectory  6 epochs at k 2 against JAX's `make_epoch_fn_vmap` from a
              JAX `init_run` state with JAX's draws, every epoch and at
              disc_every 2, gen_every 3 (the counter picks the slot)
  resume      `train_stacked` at k 3: chunk 1 bitwise chunk 7, and a run
              checkpointed at epoch 4 (off the slot grid) resumed bitwise
  proc        2 lock-step workers at k 3 bitwise `lockstep_reference`,
              and resumed from a per-process checkpoint at epoch 4; at
              k 2 with the bf16 payload and with the chunked one
  CLI         `train_gan --staleness 3`, both backends; JAX's error for
              another mode

The card's side is in tests/test_torch_cuda.py and `chip_smoke.py`
phases 42-43.
"""
import dataclasses
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

from repro_torch.checkpoint.store import gan_state_from_numpy
from repro_torch.core import sync, workflow
from repro_torch.core.ring import VmapComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.problems import get_problem
from repro_torch.runtime.launch import lockstep_reference, run_proc

from test_torch_chunked import CHUNK, _assert_bitwise, _port_leaf
from test_torch_gan import (FP32, SMOKE, _jax_init_run, _np, _t,
                            assert_state_close, jax_draws)

EPOCHS = 6


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wcfgs(k, precision="fp32", chunk=0, h=2, small=True, **kw):
    """The same proxy1d settings at depth `k` as a JAX and a port config
    (`small`: the proc tests' 8 x 4 events, else the smoke sizes)."""
    s = dict(mode="rma_arar_arar", h=h, staleness=k,
             payload_precision=precision, ring_chunking=chunk)
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


def test_config_takes_jax_fields_and_errors():
    for k in (2, 3, 8):
        for prec in ("fp32", "bf16"):
            kw = dict(mode="rma_arar_arar", staleness=k,
                      payload_precision=prec)
            assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
                dataclasses.asdict(JS.SyncConfig(**kw))
    for kw in (dict(mode="rma_arar_arar", staleness=0),
               dict(mode="arar_arar", staleness=2),
               dict(mode="conv_arar", staleness=3)):
        with pytest.raises(ValueError) as want:
            JS.SyncConfig(**kw)
        with pytest.raises(ValueError) as got:
            sync.SyncConfig(**kw)
        assert str(got.value) == str(want.value)
    # depth composes with the overlapped pod boundary (3f) and with
    # adaptive staleness (3g, the depth as k_max) as in JAX
    for kw in (dict(mode="rma_arar_arar", staleness=2, overlap=True),
               dict(mode="rma_arar_arar", staleness=2, adaptive=True)):
        assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
            dataclasses.asdict(JS.SyncConfig(**kw))


# ----------------------------------------------------------------------------
# the pin: the read at e is the deposit of e - k


def test_depth_k_reads_exactly_k_epochs_old_and_equals_jax():
    R, k = 4, 3
    rng = np.random.default_rng(11)
    gs = [{"w": rng.standard_normal((R, 3, 5)).astype(np.float32),
           "b": rng.standard_normal((R, 5)).astype(np.float32)}
          for _ in range(EPOCHS)]
    mask = {"w": True, "b": False}
    pcfg = sync.SyncConfig(mode="rma_arar_arar", h=1000, staleness=k)
    jcfg = JS.SyncConfig(mode="rma_arar_arar", h=1000, staleness=k)
    pmb = sync.init_mailbox(tree_map(_t, gs[0]), staleness=k, stacked=True)
    jmb = JS.init_mailbox(jax.tree.map(jnp.asarray, gs[0]), staleness=k,
                          stacked=True)
    assert pmb["w"].shape == (R, k, 3, 5) and pmb["b"].shape == (R, k, 5)
    assert sync.init_mailbox(tree_map(_t, gs[0]), k)["w"].shape == \
        (k, R, 3, 5)            # per rank (unstacked) the depth leads
    for e in range(EPOCHS):
        out, pmb = sync.sync_gradients(VmapComm(1, R), pcfg,
                                       tree_map(_t, gs[e]), pmb,
                                       torch.tensor(e), mask)
        jout, jmb = JS.sync_gradients(JaxVmapComm(1, R), jcfg,
                                      jax.tree.map(jnp.asarray, gs[e]), jmb,
                                      jnp.asarray(e), mask)
        expect = gs[e]["w"] if e < k else \
            gs[e]["w"] + np.roll(gs[e - k]["w"], 1, axis=0)
        np.testing.assert_allclose(_np(out["w"]), expect, rtol=1e-6)
        np.testing.assert_array_equal(_np(out["b"]), gs[e]["b"])
        _assert_bitwise({"o": out, "m": pmb},
                        jax.tree.leaves({"o": jout, "m": jmb}),
                        f"epoch {e}")
        # slot e % k now holds this epoch's deposit; the others are older
        np.testing.assert_array_equal(_np(pmb["w"][:, e % k]),
                                      np.roll(gs[e]["w"], 1, axis=0))
    assert not bool(pmb["b"].any())     # never written: biases stay local


# ----------------------------------------------------------------------------
# the schedule on VmapComm 2 x 4: bitwise JAX's, chunked = unchunked

SCHEDULE = [(k, p, c) for k in (2, 3) for p in ("fp32", "bf16")
            for c in (0, CHUNK)]


def _grads(example, e):
    rng = np.random.default_rng(100 + e)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), example)


def _port_run(k, precision, chunk, grads):
    sched = workflow.make_schedule(_wcfgs(k, precision, chunk)[1])
    st, outs = sched.init_state(8, "cpu"), []
    for e, g in enumerate(grads):
        out, st = sched.exchange(VmapComm(2, 4), tree_map(_t, g), st,
                                 torch.tensor(e, dtype=torch.int32))
        outs.append((out, st))
    return sched, outs


@pytest.mark.parametrize("k,precision,chunk", SCHEDULE,
                         ids=[f"k{k}-{p}-{c}" for k, p, c in SCHEDULE])
def test_exchange_is_bitwise_jax_and_unchunked(k, precision, chunk):
    R = 8
    jsched = JW.make_schedule(_wcfgs(k, precision, chunk)[0])
    grads = [_grads(jsched._grads_example(R), e) for e in range(EPOCHS)]
    exchange = jax.jit(lambda g, st, e: jsched.exchange(
        JaxVmapComm(2, 4), g, st, e))
    jst, want = jsched.init_state(R), []
    for e in range(EPOCHS):
        out, jst = exchange(jax.tree.map(jnp.asarray, grads[e]), jst,
                            jnp.asarray(e))
        want.append(jax.tree.leaves((out, jst)))
    sched, got = _port_run(k, precision, chunk, grads)
    assert sched.spec.n_segments == (1 if not chunk else
                                     jsched.spec.n_segments) \
        and (not chunk or sched.spec.n_segments > 1)
    for e in range(EPOCHS):
        _assert_bitwise(got[e], want[e], f"k {k} {precision} epoch {e}")
    if chunk:
        _, whole = _port_run(k, precision, 0, grads)
        for e in range(EPOCHS):
            _assert_bitwise(got[e], list(tree_leaves(whole[e])),
                            f"k {k} {precision} epoch {e}: chunked vs whole")
    # the depth axis, and the wire dtype on the masked leaves only
    mb = got[-1][1]["mailbox"]
    wire = sync.payload_dtype_of(precision)
    for layer in mb:
        assert layer["w"].shape[:2] == (R, k) and layer["w"].dtype == wire
        assert layer["b"].shape[:2] == (R, k) and \
            layer["b"].dtype == torch.float32 and not bool(layer["b"].any())


def test_exchange_reads_nothing_back(monkeypatch):
    _, pcfg = _wcfgs(3, "bf16", CHUNK)
    sched = workflow.make_schedule(pcfg)
    st = sched.init_state(8, "cpu")
    g = tree_map(lambda t: torch.randn(t.shape), sched.spec.zeros(8))
    epoch = torch.full((8,), 5, dtype=torch.int32)
    for name in ("item", "tolist", "__int__", "__index__", "__float__",
                 "__bool__"):
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out, new = sched.exchange(VmapComm(2, 4), g, st, epoch[0])
    monkeypatch.undo()
    # slot 5 % 3 = 2 took the deposit, the other slots kept their zeros
    w = new["mailbox"][0]["w"]
    assert bool(w[:, 2].any()) and not bool(w[:, :2].any())
    # the inputs were not written: the deposit is out of place
    assert not any(bool(t.any()) for t in tree_leaves(st))


# ----------------------------------------------------------------------------
# the state's layout and checkpoints, both ways


def test_state_layout_and_checkpoints_match_jax(tmp_path):
    jcfg, pcfg = _wcfgs(3, "bf16")
    # JAX's init_state (each rank's [k, ...] buffer, stacked), traced for
    # its shapes and dtypes
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
    assert got["sync/mailbox/0/w"].shape == \
        (4, 3) + tuple(got["gen/0/w"].shape[1:])
    assert got["sync/mailbox/0/w"].dtype == torch.bfloat16
    assert got["sync/mailbox/0/b"].dtype == torch.float32
    # the JAX store reads a port depth-3 checkpoint, saved off the slot
    # grid (epoch 4), into its own template ...
    d = str(tmp_path / "ck")
    state, _ = workflow.train_stacked(0, pcfg, 2, 2, 4, _data(),
                                      checkpoint_every=4, checkpoint_dir=d,
                                      device="cpu")
    restored, step = jax_restore_latest(d, jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), like))
    assert step == 4
    flat = {k: np.asarray(v) for k, v in jax_flatten(restored).items()}
    for k, t in tree_paths(state):
        assert flat[k].shape == tuple(t.shape), k
        assert flat[k].dtype == np.dtype(want[k].dtype), k
    # ... and that JAX depth-k state (bf16 bits widened as the store
    # widens them) comes back into the port bitwise, dtypes included
    _bitwise(gan_state_from_numpy(flat, "cpu"), state, "JAX state -> port")
    assert bool(state["sync"]["mailbox"][0]["w"].float().any())


# ----------------------------------------------------------------------------
# the trajectory against JAX's epoch function

TRAJECTORY = [dict(), dict(disc_every=2, gen_every=3)]


@pytest.mark.parametrize("cadence", TRAJECTORY,
                         ids=["every-epoch", "cadence-2-3"])
def test_trajectory_matches_jax(cadence):
    """6 epochs at k 2, h 2 from a JAX `init_run` state (its sync state
    at depth 2, from the JAX schedule) with JAX's draws: losses with
    their NaNs, predicted parameters, then every state leaf."""
    jcfg, pcfg = _wcfgs(2, small=False, **cadence)
    jstate, jdata = _jax_init_run()
    jstate = dict(jax.tree.map(jnp.copy, jstate),
                  sync=JW.make_schedule(jcfg).init_state(4))
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    pstate, pdata = gan_state_from_numpy(flat, "cpu"), _t(jdata)
    assert pstate["sync"]["mailbox"][0]["w"].shape[:2] == (4, 2)
    jepoch = JW.make_epoch_fn_vmap(2, 2, jcfg)
    pepoch = workflow.make_epoch_fn(2, 2, pcfg)
    # `jax_draws` under `jax.jit`: the same key splits, one dispatch
    draw = jax.jit(lambda rng: jax_draws(rng, jcfg, jdata.shape[1],
                                         to_port=False))
    for e in range(EPOCHS):
        draws = {k: _t(v) for k, v in draw(jstate["rng"]).items()}
        draws["idx"] = draws["idx"].to(torch.int64)
        jstate, jm = jepoch(jstate, jdata)
        pstate, pm = pepoch(pstate, pdata, draws, e)
        for k, ran in zip(("d_loss", "g_loss"), workflow.due(pcfg, e)):
            assert bool(pm[k].isnan().all()) != ran, (e, k)
            np.testing.assert_allclose(_np(pm[k]), np.asarray(jm[k]),
                                       err_msg=f"epoch {e} {k}", **FP32)
        np.testing.assert_allclose(_np(pm["pred_params"]),
                                   np.asarray(jm["pred_params"]),
                                   err_msg=f"epoch {e}", **FP32)
    assert_state_close(pstate, jstate)
    assert pstate["epoch"].tolist() == [EPOCHS] * 4
    # a deposit landed in each slot the generator's epochs wrote
    written = {e % 2 for e in range(EPOCHS) if workflow.due(pcfg, e)[1]}
    w = pstate["sync"]["mailbox"][0]["w"]
    assert {s for s in range(2) if bool(w[:, s].any())} == written


def test_the_epoch_counter_picks_the_slot():
    """At gen_every 2, k 2 the generator's epochs 0 and 2 both write slot
    0 (epoch % k), and epoch 2 reads epoch 0's deposit: slot 1 stays
    zero, as in JAX (`state["epoch"][0]` picks it, not a count of
    exchanges)."""
    _, wcfg = _wcfgs(2, gen_every=2)
    s1, _ = workflow.train_stacked(0, wcfg, 2, 2, 1, _data(), device="cpu")
    s3, _ = workflow.train_stacked(0, wcfg, 2, 2, 3, _data(), device="cpu")
    for s in (s1, s3):
        w = s["sync"]["mailbox"][0]["w"]
        assert bool(w[:, 0].any()) and not bool(w[:, 1].any())
    assert not torch.equal(s3["sync"]["mailbox"][0]["w"],
                           s1["sync"]["mailbox"][0]["w"])


# ----------------------------------------------------------------------------
# resume off the slot grid


def test_train_stacked_chunks_and_resume_off_the_grid(tmp_path):
    _, wcfg = _wcfgs(3)
    data = _data()
    s7, h7 = workflow.train_stacked(0, wcfg, 2, 2, 7, data, chunk=7,
                                    checkpoint_every=1, device="cpu")
    s1, h1 = workflow.train_stacked(0, wcfg, 2, 2, 7, data, chunk=1,
                                    checkpoint_every=1, device="cpu")
    _bitwise(s7, s1, "chunk 7 against chunk 1")
    assert torch.equal(h7["g_loss"], h1["g_loss"])
    d = str(tmp_path / "ck")
    workflow.train_stacked(0, wcfg, 2, 2, 4, data, checkpoint_every=4,
                           checkpoint_dir=d, device="cpu")
    res, _ = workflow.train_stacked(0, wcfg, 2, 2, 7, data,
                                    checkpoint_every=4, checkpoint_dir=d,
                                    resume=True, device="cpu")
    _bitwise(res, s7, "resumed at epoch 4")
    assert s7["sync"]["mailbox"][0]["w"].shape[:2] == (4, 3)


# ----------------------------------------------------------------------------
# the proc runtime


def test_proc_lockstep_depth_k_is_bitwise_its_reference(tmp_path):
    _, wcfg = _wcfgs(3)
    data = _data()
    d = str(tmp_path / "run")
    out = run_proc(wcfg, 1, 2, EPOCHS, data, seed=0, run_dir=d,
                   ckpt_every=4, device="cpu", timeout=300)
    ref = lockstep_reference(0, wcfg, 1, 2, EPOCHS, data, device="cpu")
    _bitwise(out["state"], ref, "2 workers at k 3")
    mb = out["state"]["sync"]["mailbox"][0]["w"]
    assert mb.shape[:2] == (2, 3) and all(bool(mb[:, s].any())
                                          for s in range(3))
    # a per-process checkpoint at epoch 4 (off the slot grid) resumes
    # bitwise: the [1, 3, ...] template restores each worker's buffer
    res = run_proc(wcfg, 1, 2, EPOCHS, data, seed=0, run_dir=d,
                   ckpt_every=4, resume=True, device="cpu", timeout=300)
    assert [s["start_epoch"] for s in res["summaries"]] == [4, 4]
    _bitwise(res["state"], ref, "resumed at epoch 4")


PROC_PAYLOADS = [("bf16", 0), ("fp32", CHUNK)]


@pytest.mark.parametrize("precision,chunk", PROC_PAYLOADS,
                         ids=["bf16", "chunked"])
def test_proc_lockstep_depth_k_payloads_are_bitwise_their_reference(
        precision, chunk, tmp_path):
    """2 lock-step workers at k 2 with the bf16 payload, then the chunked
    one: bitwise `lockstep_reference`, the [1, 2, ...] buffers stored in
    the wire dtype, the inner ring's deposit in its windows."""
    from repro_torch.runtime.mailbox import _MBX_HDR
    _, wcfg = _wcfgs(2, precision, chunk)
    d = str(tmp_path / "run")
    out = run_proc(wcfg, 1, 2, 5, _data(), seed=0, run_dir=d, device="cpu",
                   timeout=300)
    ref = lockstep_reference(0, wcfg, 1, 2, 5, _data(), device="cpu")
    _bitwise(out["state"], ref, f"2 workers at k 2, {precision}, {chunk} B")
    mb = out["state"]["sync"]["mailbox"][0]["w"]
    assert mb.shape[:2] == (2, 2)
    assert mb.dtype == sync.payload_dtype_of(precision)
    assert all(bool(mb[:, s].float().any()) for s in range(2))
    sizes = sorted(os.path.getsize(os.path.join(d, f)) - _MBX_HDR.size
                   for f in os.listdir(d) if f.startswith("mbx_0to1_inner"))
    assert sizes == ([101_632] if precision == "bf16" else
                     [6_656, 65_536, 65_536, 65_536])


# ----------------------------------------------------------------------------
# the CLI


def test_train_gan_cli_staleness(capsys):
    from repro_torch.launch import train_gan
    train_gan.main(["--device", "cpu", "--mode", "rma_arar_arar",
                    "--staleness", "3", "--ranks", "4", "--epochs", "4",
                    "--param-samples", "8", "--events", "1000"])
    out = capsys.readouterr().out
    assert "staleness=3" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert lines and "nan" not in " ".join(lines)
    state = train_gan.main(["--device", "cpu", "--backend", "proc",
                            "--num-procs", "2", "--mode", "rma_arar_arar",
                            "--staleness", "3", "--epochs", "4",
                            "--param-samples", "8", "--events", "1000"])
    out = capsys.readouterr().out
    assert "staleness=3" in out
    last = next(ln for ln in out.splitlines() if ln.startswith("last epoch"))
    assert "nan" not in last, last
    assert state["sync"]["mailbox"][0]["w"].shape[:2] == (2, 3)
    with pytest.raises(ValueError) as want:
        JS.SyncConfig(mode="arar_arar", staleness=2)
    with pytest.raises(ValueError) as got:
        train_gan.main(["--device", "cpu", "--mode", "arar_arar",
                        "--staleness", "2"])
    assert str(got.value) == str(want.value)
