"""The port's bf16 ring payload (`SyncConfig(payload_precision="bf16")`,
ROADMAP.md queue A item 3a) against the JAX package, on the CPU.

bf16 is a wire format, not a training dtype: `FusionSpec.flatten` packs
the fused payload to bf16 (round to nearest even), every combine runs in
bf16, and `FusionSpec.unflatten` casts back to each destination leaf's
dtype, fp32 into the gradients and bf16 into the mailbox.  Held here:

  state       the schedule's initial state has JAX's leaves, shapes and
              dtypes (masked mailbox leaves and the outer mailbox bf16,
              biases fp32); master parameters and Adam state stay fp32
              through training, the mailbox bf16
  trajectory  3 epochs from a JAX `init_run` state with JAX's draws, in
              rma_arar_arar and conv_arar at h 1: pinned (the port's
              exchange of JAX's gradients, so both round the same
              payload) every fp32 leaf at rtol 1e-4 / atol 1e-5 and the
              mailbox bitwise; unpinned (the port's own gradients, which
              differ from JAX's by fp32 ulps) the losses at fp32
              tolerance and each mailbox element within one bf16 ulp of
              JAX's, or within the fp32 atol where it is smaller than
              that (an fp32 gradient of 1e-7 held to atol 1e-5 may sit
              many bf16 ulps away), the counts printed.  Unpinned, an
              ulp flip at a pack can flip the sign of a near-cancelling
              sum and so an Adam step: no fp32 bar holds the master
              state there (the unpinned gaps are printed)
  drift       the port's bf16 against its own fp32 on all five problems
              under tests/test_precision.py's bars (5e-4 in generator
              parameters, 5e-3 in residuals after 4 epochs)
  finite      conv_arar, arar_arar, rma_arar_arar and dbtree
  wire        a bf16 payload through the port's `Mailbox` and `Board`
              bit-exact, in files byte-identical to the JAX package's;
              the free-run warmup value bf16 zeros
  proc        a 1 x 2 lock-step run bitwise `lockstep_reference`, bf16
              mailbox leaves stacked back without a cast, windows of 2
              bytes a scalar; a per-process resume bitwise
  checkpoints a JAX `train_vmap` checkpoint restores into the port bit for
              bit, the JAX store reads the port's back, a stacked resume
              is bitwise
  CLI         `--payload-precision bf16` on both backends; the JAX
              package's errors for the combinations it refuses; the
              throughput preset

The exchange itself (every fused ring mode at (O, I) in {(1, 4), (2, 2),
(2, 4)}, bitwise) is `tests/test_torch_gan.py::test_sync_gradients_match_jax`;
the card's side is `tests/test_torch_cuda.py` and `chip_smoke.py`
phases 36-37.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_latest as jax_restore_latest
from repro.checkpoint.store import _flatten as jax_flatten
from repro.configs import sagips_gan as jax_presets
from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ring import VmapComm as JaxVmapComm
from repro.problems import get_problem as jax_get_problem
from repro.runtime import mailbox as jax_mailbox

from repro_torch.checkpoint.store import (gan_state_from_numpy, read_step,
                                          restore_latest)
from repro_torch.configs import sagips_gan
from repro_torch.core import gan, sync, workflow
from repro_torch.core.ring import VmapComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.problems import available, get_problem
from repro_torch.runtime import mailbox
from repro_torch.runtime.launch import lockstep_reference, run_proc
from repro_torch.runtime.proccomm import tree_to_bytes, warmup_like

FP32 = dict(rtol=1e-4, atol=1e-5)
SMOKE = dict(n_param_samples=16, events_per_sample=8, gen_lr=2e-4,
             disc_lr=5e-4)
PAYLOAD = 50_816                 # the proxy1d generator's weights a rank


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(mode="rma_arar_arar", h=2, precision="bf16", **kw):
    """The same settings as a JAX and a port WorkflowConfig."""
    return (JW.WorkflowConfig(sync=JS.SyncConfig(
                mode=mode, h=h, payload_precision=precision), **kw),
            workflow.WorkflowConfig(sync=sync.SyncConfig(
                mode=mode, h=h, payload_precision=precision), **kw))


def small(mode="rma_arar_arar", h=2, precision="bf16", problem="proxy1d"):
    """tests/test_precision.py's `small_wcfg` in the port."""
    return workflow.WorkflowConfig(
        sync=sync.SyncConfig(mode=mode, h=h, payload_precision=precision),
        problem=problem, n_param_samples=8, events_per_sample=4)


def _data(problem="proxy1d", n=400, seed=9):
    return get_problem(problem).make_reference_data(
        torch.Generator().manual_seed(seed), n, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _port_leaf(a):
    """A JAX leaf as numpy, carried to torch with its dtype (bf16 by its
    bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return _t(a)


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last
    place (bit patterns mapped onto a monotone integer line; ±0 are 0)."""
    def line(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def _dtypes(tree):
    return {k: str(v.dtype).replace("torch.", "") for k, v in tree_paths(tree)}


def _jax_dtypes(tree):
    return {k: str(v.dtype) for k, v in jax_flatten(tree).items()
            if not k.startswith("rng")}


def _assert_master_fp32_mailbox_bf16(state):
    for top in ("gen", "gen_opt", "disc", "disc_opt"):
        for k, leaf in tree_paths(state[top]):
            assert leaf.dtype in (torch.float32, torch.int32), (top, k)
    mb = state["sync"]["mailbox"]
    for m, (k, leaf) in zip(tree_leaves(gan.weight_mask(mb)),
                            tree_paths(mb)):
        assert leaf.dtype == (torch.bfloat16 if m else torch.float32), k
    assert state["sync"]["outer_mailbox"].dtype == torch.bfloat16


# ----------------------------------------------------------------------------
# state


@pytest.mark.parametrize("mode", sync.RING_MODES)
def test_initial_state_matches_jax(mode):
    """The schedule's state, and the whole `init_state` of 4 ranks, with
    the JAX package's leaves, shapes and dtypes: the mailbox's weights and
    the flat outer mailbox bf16, its biases fp32; `rank_rows` keeps them."""
    jcfg, pcfg = _cfgs(mode)
    jst = JW.make_schedule(jcfg).init_state(4)
    pst = workflow.make_schedule(pcfg).init_state(4, "cpu")
    assert {k: (tuple(v.shape), d) for (k, v), d in zip(
        tree_paths(pst), _dtypes(pst).values())} == {
        k: (v.shape, str(v.dtype)) for k, v in jax_flatten(jst).items()}
    jfull = jax.eval_shape(lambda k: JW.init_state(k, 4, jcfg),
                           jax.random.PRNGKey(0))
    pfull = workflow.init_state(torch.Generator().manual_seed(0), 4, pcfg,
                                device="cpu")
    assert _dtypes(pfull) == _jax_dtypes(jfull)
    _assert_master_fp32_mailbox_bf16(pfull)
    assert _dtypes(workflow.rank_rows(pfull, 2)) == _dtypes(pfull)
    assert workflow.make_schedule(pcfg).spec.payload_dtype == torch.bfloat16


# ----------------------------------------------------------------------------
# trajectory against JAX


def jax_draws(rng, jcfg, n_sub):
    """One epoch's draws for every rank in the reference's key-split order
    (tests/test_torch_gan.py's helper)."""
    K, E = jcfg.n_param_samples, jcfg.events_per_sample

    def one(key):
        new, k_boot, k_gen = jax.random.split(key, 3)
        idx = jax.random.randint(k_boot, (jcfg.disc_batch,), 0, n_sub)
        k1, k2 = jax.random.split(k_gen)
        return (jax.random.normal(k1, (K, 135)),
                jax.random.uniform(k2, (K, E, 2)), idx)
    noise, u, idx = jax.vmap(one)(rng)
    return {"noise": _t(noise), "u": _t(u), "idx": _t(idx).to(torch.int64)}


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
def test_three_epochs_match_jax(mode):
    jcfg, pcfg = _cfgs(mode, h=1, **SMOKE)
    data = jax.jit(lambda k: jax_get_problem("proxy1d").make_reference_data(
        k, 5_000))(jax.random.PRNGKey(99))
    jstate, jdata = jax.jit(JW.init_run, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), 4, jcfg, data)
    pinned = gan_state_from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}, "cpu")
    assert _dtypes(pinned) == _jax_dtypes(jstate)
    own, pdata = tree_map(torch.clone, pinned), _t(jdata)
    rank_grads = jax.jit(jax.vmap(lambda s, d: JW.rank_grads(s, d, jcfg)))
    rank_apply = jax.jit(jax.vmap(
        lambda s, g, n: JW.rank_apply(s, g, n, jcfg)))
    js, ps = JW.make_schedule(jcfg), workflow.make_schedule(pcfg)
    comm = VmapComm(2, 2)
    for e in range(3):
        draws = jax_draws(jstate["rng"], jcfg, jdata.shape[1])
        jpart, jg, jm = rank_grads(jstate, jdata)
        jsync, jns = js.exchange(JaxVmapComm(2, 2), jg, jpart["sync"], e)
        jstate = rank_apply(jpart, jsync, jns)
        # pinned: the port's exchange of JAX's fp32 gradients
        part, g, m = workflow.rank_grads(pinned, pdata, draws, pcfg)
        for a, b in zip(tree_leaves(g), jax.tree.leaves(jg)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **FP32)
        synced, ns = ps.exchange(comm, tree_map(_t, jax.tree.map(
            np.asarray, jg)), part["sync"], part["epoch"][0])
        pinned = workflow.rank_apply(part, synced, ns, pcfg)
        # unpinned: its own gradients, epoch after epoch
        part, g, m = workflow.rank_grads(own, pdata, draws, pcfg)
        synced, ns = ps.exchange(comm, g, part["sync"], part["epoch"][0])
        own = workflow.rank_apply(part, synced, ns, pcfg)
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), **FP32)
    want = {k: v for k, v in jax_flatten(jstate).items()
            if not k.startswith("rng")}
    one, more, total, gap = 0, 0, 0, {"gen": 0.0, "gen_opt": 0.0}
    for (k, got), (_, mine) in zip(tree_paths(pinned), tree_paths(own)):
        ref = _port_leaf(want[k])
        assert got.dtype == mine.dtype == ref.dtype, k
        if ref.dtype == torch.bfloat16:
            assert torch.equal(got, ref), k
            # unpinned: one bf16 ulp, or the fp32 atol where the values
            # are smaller than it (their fp32 gradients agree to atol)
            ulps = bf16_ulps(mine, ref)
            near = (mine.float() - ref.float()).abs() <= FP32["atol"]
            assert bool(((ulps <= 1) | near).all()), (k, int(ulps.max()))
            one += int((ulps == 1).sum())
            more += int((ulps > 1).sum())
            total += ref.numel()
        else:
            np.testing.assert_allclose(_np(got), _np(ref), err_msg=k, **FP32)
            top = k.split("/")[0]
            if top in gap:
                gap[top] = max(gap[top], float((mine - ref).abs().max()))
    print(f"{mode}, 3 unpinned epochs: of {total} bf16 mailbox elements "
          f"{one} one ulp from JAX's, {more} more (each under "
          f"{FP32['atol']}); max |diff| gen {gap['gen']:.3e}, gen_opt "
          f"{gap['gen_opt']:.3e}")
    _assert_master_fp32_mailbox_bf16(own)


# ----------------------------------------------------------------------------
# the port's own bf16 runs


@pytest.mark.parametrize("name", available())
def test_bf16_matches_fp32_within_tolerance(name):
    """tests/test_precision.py:160's bars on the port: 4 epochs at R 2 x 2
    from one seed, bf16 against fp32."""
    data = _data(name)
    outs = {prec: workflow.train_stacked(
        0, small(precision=prec, problem=name), 2, 2, 4, data,
        checkpoint_every=1, device="cpu") for prec in ("fp32", "bf16")}
    pd = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(outs["fp32"][0]["gen"]), tree_leaves(outs["bf16"][0]["gen"])))
    rd = float((outs["fp32"][1]["residuals"]
                - outs["bf16"][1]["residuals"]).abs().max())
    assert 0 < pd < 5e-4, f"{name}: bf16 drifted {pd} in generator params"
    assert rd < 5e-3, f"{name}: bf16 drifted {rd} in residuals"
    _assert_master_fp32_mailbox_bf16(outs["bf16"][0])


@pytest.mark.parametrize("mode", ["conv_arar", "arar_arar", "rma_arar_arar",
                                  "dbtree"])
def test_bf16_runs_finite(mode):
    state, hist = workflow.train_stacked(0, small(mode), 2, 2, 3, _data(),
                                         checkpoint_every=1, device="cpu")
    for k, leaf in tree_paths(state):
        assert bool(torch.isfinite(leaf).all()), k
    assert bool(torch.isfinite(hist["residuals"]).all())
    _assert_master_fp32_mailbox_bf16(state)


# ----------------------------------------------------------------------------
# the wire


def test_bf16_mailbox_roundtrip_bit_exact(tmp_path):
    """tests/test_analysis.py::test_bf16_mailbox_roundtrip_bit_exact on the
    port's `Mailbox` and `Board`, and the same bf16 writes leave the same
    files through either package."""
    vals = torch.tensor([1.0, -2.5, 3.0e-3, 65280.0, -0.1875, 7.0, 0.0,
                         1.5e-2]).to(torch.bfloat16)
    payload = tree_to_bytes(vals)
    assert payload == np.asarray(jnp.asarray(vals.float().numpy(),
                                             jnp.bfloat16)).tobytes()
    assert len(payload) == mailbox.payload_nbytes(vals.numel(),
                                                  torch.bfloat16) == 16
    warm = warmup_like(vals)           # a free-run read before a deposit
    assert warm.dtype == torch.bfloat16 and not bool(warm.any())
    files = {}
    for name, pkg in (("port", mailbox), ("jax", jax_mailbox)):
        d = tmp_path / name
        d.mkdir()
        wr = pkg.Mailbox.for_writer(str(d / "bf16.bin"), len(payload),
                                    timeout=5.0)
        rd = pkg.Mailbox.for_reader(str(d / "bf16.bin"), len(payload),
                                    timeout=5.0)
        wr.write(payload, tag=3, lockstep=True)
        out, tag = rd.read(lockstep=True)
        assert tag == 3 and out == payload
        back = torch.frombuffer(bytearray(out), dtype=torch.bfloat16)
        assert torch.equal(back.view(torch.int16), vals.view(torch.int16))
        bwr = pkg.Board.for_writer(str(d / "board.bin"), len(payload),
                                   n_ranks=1, timeout=5.0)
        brd = pkg.Board.for_reader(str(d / "board.bin"), len(payload),
                                   n_ranks=1, timeout=5.0)
        bwr.write(payload, readers=[0], lockstep=True)
        assert brd.read(0, lockstep=True) == payload
        if name == "port":             # the JAX windows have no close()
            for w in (wr, rd, bwr, brd):
                w.close()
        files[name] = {f: (d / f).read_bytes() for f in ("bf16.bin",
                                                          "board.bin")}
    assert files["port"] == files["jax"]


@pytest.fixture(scope="module")
def proc_bf16(tmp_path_factory):
    """One 3-epoch lock-step bf16 run (1 x 2, rma_arar_arar, h 2) that keeps
    its run directory and checkpoints every epoch."""
    d = str(tmp_path_factory.mktemp("proc_bf16") / "run")
    wcfg = small()
    return wcfg, run_proc(wcfg, 1, 2, 3, _data(), seed=0, run_dir=d,
                          ckpt_every=1, device="cpu", timeout=300)


def test_proc_lockstep_bf16_is_bitwise_its_reference(proc_bf16):
    wcfg, out = proc_bf16
    ref = lockstep_reference(0, wcfg, 1, 2, 3, _data(), device="cpu")
    for (k, a), b in zip(tree_paths(out["state"]), tree_leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    _assert_master_fp32_mailbox_bf16(out["state"])
    # a deposit crossed: the mailbox is no longer the warmup zeros
    assert float(out["state"]["sync"]["mailbox"][0]["w"].abs().max()) > 0
    # the inner ring's windows hold the payload at 2 bytes a scalar
    for r, succ in ((0, 1), (1, 0)):
        size = os.path.getsize(os.path.join(out["run_dir"],
                                            f"mbx_{r}to{succ}_inner.bin"))
        assert size == mailbox._MBX_HDR.size + mailbox.payload_nbytes(
            PAYLOAD, torch.bfloat16) == 32 + 101_632


def test_proc_bf16_resume_is_bitwise(proc_bf16):
    """Drop rank 1's step 3: the launcher negotiates step 2, and the
    resumed run is the uninterrupted one bit for bit."""
    wcfg, full = proc_bf16
    d = full["run_dir"]
    shutil.rmtree(os.path.join(d, "ckpt", "rank_1", "step_00000003"))
    res = run_proc(wcfg, 1, 2, 3, _data(), seed=0, run_dir=d, ckpt_every=1,
                   resume=True, device="cpu", timeout=300)
    assert [s["start_epoch"] for s in res["summaries"]] == [2, 2]
    for (k, a), b in zip(tree_paths(res["state"]), tree_leaves(full["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b), k


# ----------------------------------------------------------------------------
# checkpoints


def test_checkpoints_cross_both_ways_and_resume(tmp_path):
    """A JAX `train_vmap` checkpoint at bf16 restores into the port's state
    bit for bit (and `read_step`'s widened copy narrows back exactly); the
    JAX store reads a port checkpoint into its own bf16 template; a
    stacked port run resumes bitwise."""
    jcfg, pcfg = _cfgs("rma_arar_arar", h=2, n_param_samples=8,
                       events_per_sample=4)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdata = jax_get_problem("proxy1d").make_reference_data(
        jax.random.PRNGKey(9), 400)
    jstate, _ = JW.train_vmap(jax.random.PRNGKey(0), jcfg, 2, 2, 1, jdata,
                              checkpoint_every=1, checkpoint_dir=jdir)
    like = workflow.init_state(torch.Generator(), 4, pcfg, device="cpu")
    got, step = restore_latest(jdir, like)
    wide = read_step(jdir, 1)
    assert step == 1
    assert float(got["sync"]["mailbox"][0]["w"].float().abs().max()) > 0
    for k, v in jax_flatten(jstate).items():
        if k.startswith("rng"):
            continue
        mine = dict(tree_paths(got))[k]
        want = _port_leaf(v)
        assert mine.dtype == want.dtype and torch.equal(mine, want), k
        assert torch.equal(_t(wide[k]).to(want.dtype), want), k
    # the port's checkpoint, read by the JAX store
    data = _data()
    full, _ = workflow.train_stacked(3, pcfg, 2, 2, 2, data,
                                     checkpoint_every=1, device="cpu")
    workflow.train_stacked(3, pcfg, 2, 2, 1, data, checkpoint_every=1,
                           checkpoint_dir=pdir, device="cpu")
    jlike = JW.init_state(jax.random.PRNGKey(0), 4, jcfg)
    back, step = jax_restore_latest(pdir, jlike)
    assert step == 1
    flat, mid = jax_flatten(back), restore_latest(pdir, like)[0]
    for k, leaf in tree_paths(mid):
        assert str(flat[k].dtype) == str(jax_flatten(jlike)[k].dtype), k
        assert torch.equal(_port_leaf(flat[k]), leaf), k
    resumed, _ = workflow.train_stacked(3, pcfg, 2, 2, 2, data,
                                        checkpoint_every=1,
                                        checkpoint_dir=pdir, resume=True,
                                        device="cpu")
    for (k, a), b in zip(tree_paths(resumed), tree_leaves(full)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


# ----------------------------------------------------------------------------
# the CLI and the presets


def test_train_gan_cli_bf16(capsys):
    from repro_torch.launch import train_gan
    state = train_gan.main(["--device", "cpu", "--preset", "reduced",
                            "--ranks", "4", "--epochs", "2", "--events",
                            "1000", "--payload-precision", "bf16"])
    out = capsys.readouterr().out
    assert "payload=bf16" in out and "serving-path solve" in out
    _assert_master_fp32_mailbox_bf16(state)
    state = train_gan.main(["--device", "cpu", "--backend", "proc",
                            "--num-procs", "2", "--epochs", "2",
                            "--param-samples", "8", "--events", "1000",
                            "--payload-precision", "bf16"])
    out = capsys.readouterr().out
    assert "2 worker processes (1 x 2), lock-step" in out
    assert ("summed over the workers: 0 kernel launches, 4 plain calls, 4 "
            "backward passes") in out
    _assert_master_fp32_mailbox_bf16(state)
    # what the JAX package refuses, with its message
    for argv, kw in ((["--no-fuse"], dict(fuse_tensors=False)),
                     (["--mode", "allreduce"], dict(mode="allreduce"))):
        with pytest.raises(ValueError) as want:
            JS.SyncConfig(payload_precision="bf16", **kw)
        with pytest.raises(ValueError) as got:
            train_gan.main(["--device", "cpu", "--payload-precision",
                            "bf16"] + argv)
        assert str(got.value) == str(want.value)


def test_throughput_preset_matches_jax():
    """`throughput` is the JAX preset: bf16 and `disc_every`, at its
    default cadence (queue A item 3c, ported) and at `disc_every=1`, the
    bf16 payload alone."""
    for name in ("PAPER", "REDUCED"):
        for kw in ({}, dict(disc_every=1)):
            j = jax_presets.throughput(getattr(jax_presets, name), **kw)
            p = sagips_gan.throughput(getattr(sagips_gan, name), **kw)
            assert dataclasses.asdict(p.sync) == dataclasses.asdict(j.sync)
            assert (p.disc_every, p.gen_every, p.n_param_samples,
                    p.gen_lr) == (j.disc_every, j.gen_every,
                                  j.n_param_samples, j.gen_lr)
    assert sagips_gan.throughput().disc_every == 2
    # 3b (the chunked ring), 3d (the depth-k mailbox), 3f (the
    # overlapped pod boundary) and 3g (adaptive staleness) take the JAX
    # config at the bf16 payload
    for extra in (dict(ring_chunking=4096), dict(staleness=2),
                  dict(overlap=True), dict(staleness=3, adaptive=True)):
        kw = dict(mode="rma_arar_arar", payload_precision="bf16", **extra)
        assert dataclasses.asdict(sync.SyncConfig(**kw)) == \
            dataclasses.asdict(JS.SyncConfig(**kw))
