"""The telemetry of the port (`ObsConfig`, the schedules' metrics channel,
`obs.metrics`, the proc workers' tracer; ROADMAP.md queue A item 3e)
against the JAX package, on the CPU:

  config      `ObsConfig` and `WorkflowConfig.obs` equal JAX's under
              `dataclasses.asdict`, the same `ValueError`, the runconfig
              round trip
  schedule    `payload_bytes` and `name` equal JAX's at fp32 and bf16,
              whole and chunked; `init_obs_state` against
              `jax.eval_shape` of JAX's; `chunk_row` on the numbers of
              tests/test_obs.py::test_chunk_row_reduces_last_epoch
  trajectory  4 epochs of `train_stacked` against JAX's `train_vmap` with
              metrics and a metrics file, 2 x 2, in `rma_arar_arar` at
              k 2, adaptive at k_max 3 with overlap, in `conv_arar` and
              at disc_every 2, gen_every 3: the
              history's obs integer fields, the file's header and the
              rows' obs fields exactly equal
  inert       metrics on against off: every leaf outside "obs" bitwise;
              with metrics off no obs method runs and the state has no
              "obs" key; an epoch with metrics on reads nothing back,
              under the static and the adaptive schedule
  proc        a 2-worker free run with `trace_dir` and jitter, whose
              traces `scripts/obsview.py` merges with the span and
              counter names of tests/test_obs.py; 2 lock-step workers
              with metrics bitwise `lockstep_reference`
  CLI         `--obs-metrics`, `--metrics-out`, `--profile-dir` and
              `--trace-dir` on both backends

The card's side is in tests/test_torch_cuda.py and `chip_smoke.py`
phases 44-45.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.core import sync as JS
from repro.core import workflow as JW
from repro.obs.config import ObsConfig as JaxObsConfig
from repro.obs.metrics import chunk_row as jax_chunk_row

from repro_torch.configs.sagips_gan import PAPER, for_problem
from repro_torch.core import sync, workflow
from repro_torch.core.tree import tree_paths
from repro_torch.obs import OBS_SCHEMA_VERSION, ObsConfig, trace
from repro_torch.obs.metrics import chunk_row
from repro_torch.problems import get_problem
from repro_torch.runtime import JitterConfig
from repro_torch.runtime.launch import (lockstep_reference, run_proc,
                                        wcfg_from_dict, wcfg_to_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 4
OBS_INTS = ("k_eff", "shipped", "ship_count", "exchange_count")
OBS_FIELDS = OBS_INTS + ("skew_ema", "deposit_age")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    yield
    t = trace.uninstall()
    if t is not None:
        t.close()


def _wcfgs(sync_kw, obs=None, **kw):
    """The same proxy1d settings, 8 x 4 events a rank, as a JAX and a
    port WorkflowConfig; `obs` a dict of ObsConfig fields."""
    obs = obs or {}
    kw = dict(n_param_samples=8, events_per_sample=4, problem="proxy1d",
              **kw)
    return (JW.WorkflowConfig(sync=JS.SyncConfig(**sync_kw),
                              obs=JaxObsConfig(**obs), **kw),
            workflow.WorkflowConfig(sync=sync.SyncConfig(**sync_kw),
                                    obs=ObsConfig(**obs), **kw))


def _data(n=400):
    return get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(7), n, device="cpu")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ----------------------------------------------------------------------------
# config


OBS_CASES = [dict(), dict(metrics=True),
             dict(metrics=True, metrics_out="m.jsonl", trace_dir="t",
                  profile_dir="p")]


@pytest.mark.parametrize("obs", OBS_CASES, ids=["default", "metrics", "all"])
def test_obs_config_and_workflow_field_match_jax(obs):
    j, p = _wcfgs(dict(mode="rma_arar_arar", staleness=2), obs)
    assert dataclasses.asdict(p.obs) == dataclasses.asdict(j.obs)
    assert dataclasses.asdict(p)["obs"] == dataclasses.asdict(j)["obs"]
    assert wcfg_from_dict(json.loads(json.dumps(wcfg_to_dict(p)))) == p
    assert OBS_SCHEMA_VERSION == 1
    with pytest.raises(ValueError) as want:
        JaxObsConfig(metrics=False, metrics_out="m.jsonl")
    with pytest.raises(ValueError) as got:
        ObsConfig(metrics=False, metrics_out="m.jsonl")
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------------
# the schedule's channel


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [0, 65_536], ids=["whole", "chunked"])
def test_payload_bytes_and_name_match_jax(precision, chunk):
    kw = dict(mode="rma_arar_arar", payload_precision=precision,
              ring_chunking=chunk)
    jsched = JW.make_schedule(JW.WorkflowConfig(sync=JS.SyncConfig(**kw)))
    psched = workflow.make_schedule(dataclasses.replace(
        PAPER, sync=sync.SyncConfig(**kw)))
    assert psched.name == jsched.name == "sync"
    assert psched.payload_bytes == jsched.payload_bytes == \
        {"fp32": 203_264, "bf16": 101_632}[precision]
    blur = workflow.make_schedule(for_problem("imaging_blur", PAPER))
    assert blur.payload_bytes == 1_161_792


@pytest.mark.parametrize("n_ranks", [None, 4])
def test_init_obs_state_matches_jax(n_ranks):
    jsched = JW.make_schedule(JW.WorkflowConfig())
    want = jax.eval_shape(lambda: jsched.init_obs_state(n_ranks))
    got = workflow.make_schedule(workflow.WorkflowConfig()).init_obs_state(
        n_ranks, "cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == np.dtype(v.dtype).name, k
        assert not bool(got[k].any()), k


def test_chunk_row_reduces_last_epoch():
    metrics = {
        "d_loss": np.array([[1.0, 3.0], [2.0, 4.0]]),     # [chunk, R]
        "residuals": np.array([[9.0, 9.0], [5.0, 7.0]]),
        "obs": {"k_eff": np.array([[1, 1], [2, 3]]),
                "shipped": np.array([[0, 0], [1, 0]]),
                "ship_count": np.array([[0, 0], [1, 0]]),
                "exchange_count": np.array([[1, 1], [2, 2]]),
                "skew_ema": np.array([[0.0, 0.0], [0.5, 0.25]]),
                "deposit_age": np.array([[0.0, 0.0], [2.0, 1.0]])},
    }
    row = chunk_row(2, metrics)
    assert row["epoch"] == 2
    assert row["d_loss"] == pytest.approx(3.0)        # mean of last epoch
    assert row["residual"] == pytest.approx(6.0)
    assert row["k_eff"] == 3 and row["ship_count"] == 1   # rank max
    assert row["skew_ema"] == pytest.approx(0.5)
    assert row["deposit_age"] == pytest.approx(2.0)
    # the same row, in the same order, as JAX's and from tensors
    want = json.dumps(jax_chunk_row(2, metrics))
    assert json.dumps(row) == want
    tensors = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                   {a: torch.from_numpy(b) for a, b in v.items()})
               for k, v in metrics.items()}
    assert json.dumps(chunk_row(2, tensors)) == want


# ----------------------------------------------------------------------------
# train_stacked against train_vmap

TRAJECTORY = {
    "rma-k2": (dict(mode="rma_arar_arar", h=2, staleness=2), {}),
    "adaptive-k3": (dict(mode="rma_arar_arar", h=2, staleness=3,
                         adaptive=True, overlap=True), {}),
    "conv": (dict(mode="conv_arar", h=2), {}),
    "cadence-2-3": (dict(mode="rma_arar_arar", h=2),
                    dict(disc_every=2, gen_every=3)),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORY))
def test_obs_history_and_metrics_file_match_jax(case, tmp_path):
    sync_kw, kw = TRAJECTORY[case]
    out = {n: str(tmp_path / f"{n}.jsonl") for n in ("jax", "port")}
    jcfg, _ = _wcfgs(sync_kw, dict(metrics=True, metrics_out=out["jax"]),
                     **kw)
    _, pcfg = _wcfgs(sync_kw, dict(metrics=True, metrics_out=out["port"]),
                     **kw)
    jdata = jcfg.problem_obj.make_reference_data(jax.random.PRNGKey(7), 400)
    _, jhist = JW.train_vmap(jax.random.PRNGKey(0), jcfg, 2, 2, EPOCHS,
                             jdata, checkpoint_every=1)
    _, phist = workflow.train_stacked(0, pcfg, 2, 2, EPOCHS, _data(),
                                      checkpoint_every=1, device="cpu")
    assert sorted(phist["obs"]) == sorted(jhist["obs"])
    for k in OBS_INTS:
        got, want = phist["obs"][k], np.asarray(jhist["obs"][k])
        assert str(got.dtype).split(".")[1] == want.dtype.name, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for k in ("skew_ema", "deposit_age"):
        assert not bool(phist["obs"][k].any()) and \
            not np.asarray(jhist["obs"][k]).any(), k
    # an exchange on each of the generator's epochs, counted on its own
    gen = [workflow.due(pcfg, e)[1] for e in range(EPOCHS)]
    assert phist["obs"]["exchange_count"][:, 0].tolist() == \
        np.cumsum(gen).tolist()
    jrows, prows = _rows(out["jax"]), _rows(out["port"])
    assert prows[0] == jrows[0] and prows[0]["kind"] == "header"
    assert prows[0]["schema"] == OBS_SCHEMA_VERSION
    assert len(prows) == len(jrows) == EPOCHS + 1
    for p, j in zip(prows[1:], jrows[1:]):
        assert list(p) == list(j)
        assert {k: p[k] for k in ("epoch", "kind") + OBS_FIELDS} == \
            {k: j[k] for k in ("epoch", "kind") + OBS_FIELDS}


# ----------------------------------------------------------------------------
# inert: metrics never touch the update, and off means off


INERT = {"rma-k2": (dict(mode="rma_arar_arar", h=2, staleness=2), {}),
         "cadence-2-3": (dict(mode="conv_arar", h=2),
                         dict(disc_every=2, gen_every=3))}


@pytest.mark.parametrize("case", sorted(INERT))
def test_metrics_on_is_bitwise_off_outside_obs(case, monkeypatch):
    sync_kw, kw = INERT[case]
    _, on = _wcfgs(sync_kw, dict(metrics=True), **kw)
    _, off = _wcfgs(sync_kw, {}, **kw)
    s_on, h_on = workflow.train_stacked(0, on, 2, 2, EPOCHS, _data(),
                                        checkpoint_every=1, device="cpu")
    for name in ("obs_row", "exchange_with_obs", "accumulate_obs",
                 "init_obs_state"):
        def refuse(*_, name=name, **__):
            raise AssertionError(f"{name} ran with metrics off")
        monkeypatch.setattr(sync.SyncSchedule, name, refuse)
    s_off, h_off = workflow.train_stacked(0, off, 2, 2, EPOCHS, _data(),
                                          checkpoint_every=1, device="cpu")
    monkeypatch.undo()
    assert "obs" not in s_off and "obs" not in h_off
    assert set(s_on) == set(s_off) | {"obs"}
    assert set(h_on) == set(h_off) | {"obs"}
    got = dict(tree_paths({k: v for k, v in s_on.items() if k != "obs"}))
    for k, t in tree_paths(s_off):
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    for k, t in h_off.items():
        assert torch.equal(h_on[k].nan_to_num(), t.nan_to_num()), k
        assert torch.equal(h_on[k].isnan(), t.isnan()), k
    assert s_on["obs"]["exchange_count"].tolist() == \
        [workflow.due_counts(on, EPOCHS)[1]] * 4


def test_epoch_with_metrics_reads_nothing_back(monkeypatch):
    _, wcfg = _wcfgs(dict(mode="rma_arar_arar", h=2, staleness=2),
                     dict(metrics=True))
    g = torch.Generator().manual_seed(0)
    state, data = workflow.init_run(g, 4, wcfg, _data(), "cpu")
    epoch = workflow.make_epoch_fn(2, 2, wcfg)
    draws = [workflow.make_draws(g, wcfg, 4, data.shape[1])
             for _ in range(3)]
    for name in ("item", "tolist", "__int__", "__index__", "__float__",
                 "__bool__"):
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for e in range(3):
        state, metrics = epoch(state, data, draws[e], e)
    monkeypatch.undo()
    assert metrics["obs"]["exchange_count"].tolist() == [3] * 4
    assert metrics["obs"]["k_eff"].tolist() == [2] * 4


def test_adaptive_epoch_with_metrics_reads_nothing_back(monkeypatch):
    """The adaptive schedule's epoch (slot, tag, controller, pmean and
    stretched ship gate) stays on the device too."""
    _, wcfg = _wcfgs(dict(mode="rma_arar_arar", h=2, staleness=3,
                          adaptive=True, overlap=True), dict(metrics=True))
    g = torch.Generator().manual_seed(0)
    state, data = workflow.init_run(g, 4, wcfg, _data(), "cpu")
    epoch = workflow.make_epoch_fn(2, 2, wcfg)
    draws = [workflow.make_draws(g, wcfg, 4, data.shape[1])
             for _ in range(3)]
    for name in ("item", "tolist", "__int__", "__index__", "__float__",
                 "__bool__"):
        def refuse(*_, name=name):
            raise AssertionError(f"Tensor.{name}: a read-back")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for e in range(3):
        state, metrics = epoch(state, data, draws[e], e)
    monkeypatch.undo()
    assert metrics["obs"]["exchange_count"].tolist() == [3] * 4
    assert metrics["obs"]["k_eff"].tolist() == [1] * 4
    assert metrics["obs"]["ship_count"].tolist() == [1] * 4
    assert state["sync"]["mailbox"]["tag"][0].tolist() == [0, 1, 2]

# ----------------------------------------------------------------------------
# the proc runtime's traces


def test_proc_free_run_traces_merge_with_obsview(tmp_path):
    """2 free-running workers with jitter and `trace_dir`: rank trace
    files that `scripts/obsview.py` merges, with the spans and counters
    of tests/test_obs.py's proc run under the static schedule (the
    adaptive schedule's `skew_ema` and `k_eff` counters are pinned in
    tests/test_torch_adaptive.py), and each summary's obs entry."""
    _, wcfg = _wcfgs(dict(mode="rma_arar_arar", h=1000),
                     dict(metrics=True, trace_dir="trace"))
    run_dir = str(tmp_path / "run")
    out = run_proc(wcfg, 1, 2, 6, _data(), seed=0, lockstep=False,
                   jitter=JitterConfig(rank_lag_ms=20.0), run_dir=run_dir,
                   device="cpu", timeout=300)
    for s in out["summaries"]:
        assert s["obs"] == {"payload_bytes": 203_264, "ship_count": 0,
                            "exchange_count": 6, "max_deposit_age": 0.0}
        # a free run keeps the caller's thread count: the test's one
        assert s["num_threads"] == torch.get_num_threads() == 1
    assert out["history"]["shipped"].shape == (6, 2)
    tdir = os.path.join(run_dir, "trace")
    for r in (0, 1):
        assert os.path.exists(os.path.join(tdir, f"trace_rank{r}.jsonl"))
    view = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "obsview.py"),
         run_dir], capture_output=True, text=True, timeout=120)
    assert view.returncode == 0, view.stderr
    assert "merged 2 rank trace(s)" in view.stdout
    assert "max deposit_age" in view.stdout
    assert "MISMATCH" not in view.stdout
    doc = json.load(open(os.path.join(tdir, "merged_trace.json")))
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert {e["pid"] for e in evs} == {0, 1}
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"epoch", "barrier", "compute.grads", "exchange",
            "compute.apply", "jitter.sleep"} <= names
    assert any(n.startswith("exchange.") for n in names)
    assert any(e["cat"] == "wait" for e in evs if e["ph"] == "X")
    assert {e["name"] for e in evs if e["ph"] == "C"} == {"deposit_age"}
    # the port's own merge gives the same document, and its breakdown
    # accounts for each rank's epochs
    merged = trace.merge_traces([os.path.join(tdir, f"trace_rank{r}.jsonl")
                                 for r in (0, 1)])
    assert len(merged["traceEvents"]) == len(doc["traceEvents"])
    parts = trace.EPOCH_PARTS + ("other",)
    shares = trace.epoch_breakdown(merged["traceEvents"])
    assert sorted(shares) == [0, 1]
    for r, sh in shares.items():       # the first epoch left out
        assert sh["epochs"] == 5 and sh["epoch_s"] >= sh["epoch_p50_s"] > 0
        assert sum(sh[k] for k in parts) == pytest.approx(1.0)
        assert all(sh[k] >= 0 for k in trace.EPOCH_PARTS)
        assert 0 <= sh["exchange.wait"] <= sh["exchange"]
        assert sh["compute.grads"] > 0 and sh["exchange"] > 0
    assert shares[0]["jitter.sleep"] == 0 < shares[1]["jitter.sleep"]


def test_proc_lockstep_with_metrics_is_bitwise_its_reference():
    _, wcfg = _wcfgs(dict(mode="rma_arar_arar", h=2, staleness=2),
                     dict(metrics=True), disc_every=2, gen_every=3)
    out = run_proc(wcfg, 1, 2, 5, _data(), seed=0, device="cpu",
                   timeout=300)
    ref = lockstep_reference(0, wcfg, 1, 2, 5, _data(), device="cpu")
    got = dict(tree_paths(out["state"]))
    for k, t in tree_paths(ref):
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert out["state"]["obs"]["exchange_count"].tolist() == [2, 2]
    assert [s["obs"]["exchange_count"] for s in out["summaries"]] == [2, 2]


# ----------------------------------------------------------------------------
# the CLI


def test_train_gan_cli_obs_flags_stacked(tmp_path, capsys):
    from repro_torch.launch import train_gan
    m, prof = str(tmp_path / "m.jsonl"), str(tmp_path / "prof")
    train_gan.main(["--device", "cpu", "--ranks", "4", "--epochs", "4",
                    "--param-samples", "8", "--events", "1000", "--mode",
                    "rma_arar_arar", "--staleness", "2", "--chunk", "2",
                    "--metrics-out", m, "--profile-dir", prof])
    out = capsys.readouterr().out
    assert f"metrics: a header and one row a chunk in {m}" in out
    rows = _rows(m)
    assert rows[0] == {"schema": 1, "kind": "header", "problem": "proxy1d",
                       "schedule": "sync", "payload_bytes": 203_264,
                       "n_ranks": 4, "n_epochs": 4}
    assert [(r["epoch"], r["k_eff"], r["exchange_count"]) for r in rows[1:]] \
        == [(2, 2, 2), (4, 2, 4)]
    # the profile holds the epoch loop: B1's autograd function once an
    # epoch (its plain version here, its kernel on the card)
    doc = json.load(open(os.path.join(prof, "trace.json")))
    assert sum(e.get("name") == "_InverseCdf"
               for e in doc["traceEvents"]) == 4
    # --obs-metrics alone carries the tree, with no file
    state = train_gan.main(["--device", "cpu", "--ranks", "4", "--epochs",
                            "2", "--param-samples", "8", "--events", "1000",
                            "--obs-metrics"])
    assert state["obs"]["exchange_count"].tolist() == [2] * 4


def test_train_gan_cli_obs_flags_proc(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train_gan
    monkeypatch.chdir(tmp_path)
    train_gan.main(["--device", "cpu", "--backend", "proc", "--num-procs",
                    "2", "--epochs", "3", "--param-samples", "8",
                    "--events", "1000", "--jitter-rank-lag-ms", "5",
                    "--obs-metrics", "--trace-dir", "trace"])
    out = capsys.readouterr().out
    for r in (0, 1):
        assert f"rank {r} on cpu: 3 epochs from 0" in out
        assert os.path.exists(tmp_path / "trace" / f"trace_rank{r}.jsonl")
    assert "obs: 3 exchanges of 203,264 B, 0 ships" in out
    assert f"span traces: {tmp_path / 'trace'}" in out
