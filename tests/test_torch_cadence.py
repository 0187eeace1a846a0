"""The update cadences `disc_every`/`gen_every` (ROADMAP.md queue A item
3c) of the port against the JAX package, on the CPU.

The discriminator updates on epochs e with e % disc_every == 0; the
generator, with its exchange and Adam step, on e % gen_every == 0
(`repro_torch.core.workflow.due`).  A skipped half reports NaN losses,
and an epoch with neither half reports NaN parameters:

  trajectory  6 epochs at (2, 3), which take every combination of the
              two halves, of the port's epoch function against JAX's
              `make_epoch_fn_vmap` from a JAX `init_run` state with JAX's
              draws (`jax_draws`: JAX splits its key the same way whatever
              the flags): the losses at fp32 rtol 1e-4 / atol 1e-5 with
              NaN in the same places, and every state leaf, in
              rma_arar_arar and conv_arar at h 1
  semantics   the port's rows of tests/test_precision.py::
              test_cadence_trajectory_semantics
  launches    the matmuls on the discriminator's 192-wide layers counted
              per combination of halves of `rank_grads` (the counterpart
              of test_disc_every2_off_epochs_have_no_disc_update_matmuls),
              B1's backward only where the generator runs, and nothing
              at all where neither does
  resume      `train_stacked` at (2, 3): chunk 6 bitwise chunk 1, and a
              run checkpointed at epoch 4 and resumed bitwise the whole
  proc        2 lock-step workers at (2, 3) bitwise `lockstep_reference`,
              proxy1d and imaging_blur (B3 counted by `due_counts`), and
              a per-process resume on the cadence grid
  CLI         `train_gan --disc-every 2 --gen-every 3`, both backends

The card's side is in tests/test_torch_cuda.py and `chip_smoke.py`
phases 40-41.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import workflow as JW

from repro_torch.checkpoint.store import gan_state_from_numpy
from repro_torch.configs import sagips_gan
from repro_torch.core import sync, workflow
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.kernels.imaging import blur_counts
from repro_torch.kernels.inverse_cdf import counts as icdf_counts
from repro_torch.problems import get_problem
from repro_torch.runtime.launch import lockstep_reference, run_proc

from test_torch_gan import (FP32, _jax_init_run, _np, _t, _wcfgs,
                            assert_state_close, jax_draws)

CADENCE = dict(disc_every=2, gen_every=3)
EPOCHS = 6                  # epochs 0-5 take every combination at (2, 3)
FLAGS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _small(problem="proxy1d", **kw):
    """The proc tests' small settings (1 x 2 workers), at `kw`."""
    wcfg = workflow.WorkflowConfig(
        sync=sync.SyncConfig(mode="rma_arar_arar", h=2),
        n_param_samples=8, events_per_sample=4, **kw)
    return sagips_gan.for_problem(problem, wcfg)


def _data(problem="proxy1d", n=400):
    return get_problem(problem).make_reference_data(
        torch.Generator().manual_seed(7), n, device="cpu")


def _assert_bitwise(got, want, what):
    for (k, a), b in zip(tree_paths(got), tree_leaves(want)):
        assert torch.equal(a, b), f"{what}: state[{k!r}]"


def test_due_and_due_counts_follow_the_jax_rule():
    wcfg = workflow.WorkflowConfig(**CADENCE)
    assert [workflow.due(wcfg, e) for e in range(EPOCHS)] == [
        (e % 2 == 0, e % 3 == 0) for e in range(EPOCHS)]
    assert workflow.due_counts(wcfg, EPOCHS) == (4, 2)    # 0,2,3,4; 0,3
    assert workflow.due_counts(wcfg, 200) == (133, 67)
    assert workflow.due_counts(wcfg, 6, start=4) == (1, 0)
    assert workflow.due_counts(workflow.WorkflowConfig(), 7) == (7, 7)


# ----------------------------------------------------------------------------
# against JAX


@pytest.mark.parametrize("mode", ["rma_arar_arar", "conv_arar"])
def test_cadence_trajectory_matches_jax(mode):
    """6 epochs at (2, 3) from a JAX `init_run` state with JAX's draws:
    the losses with their NaNs each epoch, then every state leaf (the
    discriminator's Adam count and the epoch counter too)."""
    jcfg, pcfg = _wcfgs(mode, h=1, **CADENCE)
    jstate, jdata = _jax_init_run()
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    pstate, pdata = gan_state_from_numpy(flat, "cpu"), _t(jdata)
    jepoch = JW.make_epoch_fn_vmap(2, 2, jcfg)
    pepoch = workflow.make_epoch_fn(2, 2, pcfg)
    jstate = jax.tree.map(jnp.copy, jstate)
    for e in range(EPOCHS):
        _, draws = jax_draws(jstate["rng"], jcfg, jdata.shape[1])
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
    assert pstate["disc_opt"]["step"].tolist() == [3] * 4   # 0, 2, 4
    assert pstate["gen_opt"]["step"].tolist() == [2] * 4    # 0, 3


# ----------------------------------------------------------------------------
# semantics (the port's rows of test_cadence_trajectory_semantics)


def _stacked(wcfg, n, **kw):
    return workflow.train_stacked(0, wcfg, 2, 2, n, _data(),
                                  checkpoint_every=1, device="cpu", **kw)


def test_disc_every_2_freezes_the_discriminator_on_its_off_epoch():
    _, every = _wcfgs(h=2)
    d2 = dataclasses.replace(every, disc_every=2)
    s1, _ = _stacked(d2, 1)
    s2, h2 = _stacked(d2, 2)
    s_ev, h_ev = _stacked(every, 2)
    # epoch 1 skips the discriminator: it stays at its epoch-0 update,
    # which the every-epoch run has moved on from
    _assert_bitwise({"disc": s2["disc"], "disc_opt": s2["disc_opt"]},
                    {"disc": s1["disc"], "disc_opt": s1["disc_opt"]},
                    "disc_every 2, epoch 1")
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(s2["disc"]), tree_leaves(s_ev["disc"])))
    assert bool(h2["d_loss"][1].isnan().all())
    assert bool(h2["g_loss"][1].isfinite().all())
    assert bool(h2["residuals"][1].isfinite().all())
    # the draws are the every-epoch run's: epoch 0 is the same epoch
    assert torch.equal(h2["g_loss"][0], h_ev["g_loss"][0])
    assert torch.equal(h2["d_loss"][0], h_ev["d_loss"][0])


def test_gen_every_2_freezes_the_generator_on_its_off_epoch():
    _, every = _wcfgs(h=2)
    g2 = dataclasses.replace(every, gen_every=2)
    s1, _ = _stacked(g2, 1)
    s2, h2 = _stacked(g2, 2)
    _assert_bitwise({k: s2[k] for k in ("gen", "gen_opt", "sync")},
                    {k: s1[k] for k in ("gen", "gen_opt", "sync")},
                    "gen_every 2, epoch 1")
    assert s2["epoch"].tolist() == [2] * 4
    assert bool(h2["g_loss"][1].isnan().all())
    assert bool(h2["d_loss"][1].isfinite().all())
    assert not torch.equal(s2["disc_opt"]["step"], s1["disc_opt"]["step"])


# ----------------------------------------------------------------------------
# skipped work is not launched


class _Matmuls(TorchDispatchMode):
    """Counts the matmuls dispatched, and those on a 192-wide operand (the
    discriminator's hidden layers: the generator's are 128 wide)."""
    OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot")

    def __init__(self):
        super().__init__()
        self.all = self.disc = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.all += 1
            self.disc += any(isinstance(a, torch.Tensor) and 192 in a.shape
                             for a in args)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("problem", ["proxy1d", "imaging_blur"])
def test_skipped_halves_launch_nothing(problem):
    wcfg = _small(problem)
    data = _data(problem, n=200)
    state, per_rank = workflow.init_run(torch.Generator().manual_seed(0), 2,
                                        wcfg, data, "cpu")
    draws = workflow.make_draws(torch.Generator().manual_seed(1), wcfg, 2,
                                per_rank.shape[1])
    image = problem == "imaging_blur"
    n, calls = {}, {}
    for flags in FLAGS:
        for c in (icdf_counts, blur_counts):
            c.reset()
        with _Matmuls() as mm:
            _, grads, metrics = workflow.rank_grads(state, per_rank, draws,
                                                    wcfg, *flags)
        n[flags] = (mm.all, mm.disc)
        calls[flags] = (icdf_counts.plain_calls, icdf_counts.backward_plain,
                        blur_counts.plain_calls, blur_counts.backward_plain)
        if not flags[1]:
            assert all(not bool(t.any()) for t in tree_leaves(grads))
        assert bool(metrics["pred_params"].isnan().all()) == (not any(flags))
    both, gen_only, disc_only = (n[f][1] for f in FLAGS[:3])
    assert both > 0, "the pin lost its subject: no 192-wide matmul"
    # the generator's pass through the discriminator (forward and input
    # gradients) is all that a discriminator off-epoch runs of it
    assert 0 < gen_only < both and 0 < disc_only < both
    assert n[(False, False)] == (0, 0)
    # B1 (and B3) forward whenever a half runs, backward with the generator
    # only; B1's backward does not reach the imaging readout's noise
    for flags, (icdf, icdf_bwd, blur, blur_bwd) in calls.items():
        assert icdf == int(any(flags)), flags
        assert icdf_bwd == int(flags[1] and not image), flags
        assert (blur, blur_bwd) == ((int(any(flags)), int(flags[1]))
                                    if image else (0, 0)), flags


# ----------------------------------------------------------------------------
# chunked and resumed runs stay on the cadence grid


def test_train_stacked_chunks_and_resume_stay_on_the_grid(tmp_path):
    _, wcfg = _wcfgs(h=2, **CADENCE)
    data = _data()
    s6, h6 = workflow.train_stacked(0, wcfg, 2, 2, EPOCHS, data, chunk=6,
                                    checkpoint_every=1, device="cpu")
    s1, h1 = workflow.train_stacked(0, wcfg, 2, 2, EPOCHS, data, chunk=1,
                                    checkpoint_every=1, device="cpu")
    _assert_bitwise(s6, s1, "chunk 6 against chunk 1")
    for k in ("d_loss", "g_loss"):
        assert torch.equal(h6[k].isnan(), h1[k].isnan())
    d = str(tmp_path / "ck")
    workflow.train_stacked(0, wcfg, 2, 2, 4, data, checkpoint_every=2,
                           checkpoint_dir=d, device="cpu")
    res, hr = workflow.train_stacked(0, wcfg, 2, 2, EPOCHS, data,
                                     checkpoint_every=2, checkpoint_dir=d,
                                     resume=True, device="cpu")
    _assert_bitwise(res, s6, "resumed at epoch 4")
    # epoch 4 runs the discriminator alone, epoch 5 neither half
    assert bool(hr["d_loss"][0].isfinite().all())
    assert bool(hr["g_loss"].isnan().all())


# ----------------------------------------------------------------------------
# the proc runtime


@pytest.mark.parametrize("problem", ["proxy1d", "imaging_blur"])
def test_proc_lockstep_cadence_is_bitwise_its_reference(tmp_path, problem):
    wcfg = _small(problem, **CADENCE)
    data = _data(problem, n=256)
    out = run_proc(wcfg, 1, 2, EPOCHS, data, seed=0, run_dir=str(tmp_path),
                   device="cpu", timeout=300)
    _assert_bitwise(out["state"], lockstep_reference(
        0, wcfg, 1, 2, EPOCHS, data, device="cpu"), f"{problem} at (2, 3)")
    n_half, n_gen = workflow.due_counts(wcfg, EPOCHS)
    image = problem == "imaging_blur"
    assert out["counts"]["inverse_cdf"] == (0, 2 * n_half, 0,
                                            0 if image else 2 * n_gen)
    assert out["counts"]["blur2d"] == ((0, 2 * n_half, 0, 2 * n_gen)
                                       if image else (0, 0, 0, 0))
    # the NaN losses of the skipped halves cross the summaries as NaN
    h = out["history"]
    for k, i in (("d_loss", 0), ("g_loss", 1)):
        ran = torch.tensor([workflow.due(wcfg, e)[i] for e in range(EPOCHS)])
        assert torch.equal(h[k].isnan().all(1), ~ran), k
        assert bool(h[k][ran].isfinite().all()), k
    assert out["state"]["epoch"].tolist() == [EPOCHS] * 2


def test_proc_resume_lands_on_the_cadence_grid(tmp_path):
    wcfg = _small(**CADENCE)
    data = _data()
    d = str(tmp_path / "run")
    run_proc(wcfg, 1, 2, 4, data, seed=0, run_dir=d, ckpt_every=2,
             device="cpu", timeout=300)
    res = run_proc(wcfg, 1, 2, EPOCHS, data, seed=0, run_dir=d,
                   ckpt_every=2, resume=True, device="cpu", timeout=300)
    assert [s["start_epoch"] for s in res["summaries"]] == [4, 4]
    _assert_bitwise(res["state"], lockstep_reference(
        0, wcfg, 1, 2, EPOCHS, data, device="cpu"), "resumed at epoch 4")
    # epochs 4 and 5: one epoch with a half, none with the generator
    assert res["counts"]["inverse_cdf"] == (0, 2, 0, 0)


# ----------------------------------------------------------------------------
# the CLI


def test_train_gan_cli_cadence(capsys):
    from repro_torch.launch import train_gan
    # 30 epochs report every 3: each report interval holds a generator
    # epoch and a discriminator one
    train_gan.main(["--device", "cpu", "--ranks", "4", "--epochs", "30",
                    "--param-samples", "8", "--events", "1000",
                    "--disc-every", "2", "--gen-every", "3"])
    out = capsys.readouterr().out
    assert "disc_every=2 gen_every=3" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 10 and "nan" not in " ".join(lines)
    n_half, n_gen = workflow.due_counts(workflow.WorkflowConfig(**CADENCE),
                                        30)
    assert (f"0 kernel launches, {n_half} plain calls, {n_gen} backward "
            f"passes") in out
    state = train_gan.main(["--device", "cpu", "--backend", "proc",
                            "--num-procs", "2", "--epochs", "5",
                            "--param-samples", "8", "--events", "1000",
                            "--disc-every", "2", "--gen-every", "3"])
    out = capsys.readouterr().out
    last = next(ln for ln in out.splitlines() if ln.startswith("last epoch"))
    assert "nan" not in last, last
    # epochs 0-4: a half on 0, 2, 3, 4, the generator on 0 and 3
    assert ("summed over the workers: 0 kernel launches, 8 plain calls, 4 "
            "backward passes") in out
    assert state["epoch"].tolist() == [5, 5]
