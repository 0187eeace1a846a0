"""The port's proc runtime (`repro_torch.runtime`) against the JAX package's
(`repro.runtime`), on the CPU.

Units, each held against the JAX package on the same inputs:

  mailbox     a JAX `Mailbox` or `Board` writer read by the port's reader
              and the other way round, lock-step and free-running; the
              same writes leave byte-identical files; a re-attached writer
              resumes its sequence; a free-running window under a
              hammering writer thread never serves a torn entry
  wire        `tree_to_bytes` of the same arrays gives the same bytes;
              `bytes_to_tree` inverts it; warmup values
  jitter      `JitterConfig.sleep_s` equal over a grid of (seed, rank,
              epoch)
  topology    `ProcComm._peers` equal for several (O, I, rank); size-1
              groups are the identity; dbtree raises
  tracer      the port's `Tracer` writes events with the JAX tracer's
              keys, which the JAX reader loads and merges
  workflow    `init_run(rank=r)` is the r-th rows of the stacked result;
              the wcfg JSON round trip
  exchange    `StaticSchedule.exchange` through 4 port `ProcComm`s (2 x 2,
              one thread a rank, lock-step, 3 epochs with the outer ring
              due on alternate ones) on gradients JAX made: bitwise JAX's
              exchange through its `VmapComm`, in conv_arar, arar_arar,
              rma_arar_arar and allreduce (at R 4 XLA and torch sum the
              mean in one order; at R 8 they differ by an ulp)

and the port's spawned runs, 2 worker processes at smoke size with
`device="cpu"`: lock-step bitwise `lockstep_reference` at 1 x 2 and
2 x 1, workers and reference at one fixed thread count (queue C item
6); within 1e-6 of `train_stacked` (batched against per-rank GEMMs
in the local discriminator, as tests/test_runtime.py pins for JAX); a
per-process resume bitwise, with one rank's newest checkpoint corrupt; a
free run with jitter that ends finite; the refusals.  The card's side is
in tests/test_torch_cuda.py and `chip_smoke.py` phases 34-35.
"""
import json
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ring import VmapComm as JaxVmapComm
from repro.obs import trace as jax_trace
from repro.runtime import mailbox as jax_mailbox
from repro.runtime.jitter import JitterConfig as JaxJitter
from repro.runtime.proccomm import ProcComm as JaxProcComm
from repro.runtime.proccomm import tree_to_bytes as jax_tree_to_bytes

from repro_torch.core import sync, workflow
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.obs import trace
from repro_torch.problems import get_problem
from repro_torch.runtime import launch, mailbox
from repro_torch.runtime.jitter import JitterConfig
from repro_torch.runtime.launch import (lockstep_reference, run_proc,
                                        wcfg_from_dict, wcfg_to_dict)
from repro_torch.runtime.proccomm import (ProcComm, bytes_to_tree,
                                          tree_to_bytes, warmup_like)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PKGS = {"jax": jax_mailbox, "port": mailbox}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def small_wcfg(mode="rma_arar_arar", h=2):
    return workflow.WorkflowConfig(
        sync=sync.SyncConfig(mode=mode, h=h), problem="proxy1d",
        n_param_samples=8, events_per_sample=4)


def _data():
    return get_problem("proxy1d").make_reference_data(
        torch.Generator().manual_seed(7), 400, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _run_threads(fns, timeout=60):
    """Run each fn in a thread; re-raise the first error."""
    errors = []

    def guard(fn):
        try:
            fn()
        except Exception as e:          # reported below, in the test
            errors.append(e)
    ts = [threading.Thread(target=guard, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "a thread did not finish"
    if errors:
        raise errors[0]


# ----------------------------------------------------------------------------
# the mailbox fabric against the JAX package's


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=[f"{w}_to_{r}" for w, r in DIRECTIONS])
def test_mailbox_interoperates_with_jax(tmp_path, writer, reader):
    W, Rd = PKGS[writer], PKGS[reader]
    # free-running: the latest deposit, None before the first
    p = str(tmp_path / "free.bin")
    rd = Rd.Mailbox.for_reader(p, 8, timeout=5.0)
    assert rd.read(lockstep=False) is None
    wr = W.Mailbox.for_writer(p, 8, timeout=5.0)
    assert rd.read(lockstep=False) is None
    for v, tag in ((1.5, 3), (2.5, 7)):
        wr.write(struct.pack("<d", v), tag=tag, lockstep=False)
    assert rd.read(lockstep=False) == (struct.pack("<d", 2.5), 7)
    # lock-step: every entry delivered once, in order, though the writer
    # thread runs ahead of the reader
    p = str(tmp_path / "lock.bin")
    n, got = 6, []

    def produce():
        w = W.Mailbox.for_writer(p, 8, timeout=10.0)
        for k in range(n):
            w.write(struct.pack("<q", k), tag=k, lockstep=True)

    def consume():
        r = Rd.Mailbox.for_reader(p, 8, timeout=10.0)
        for _ in range(n):
            buf, tag = r.read(lockstep=True)
            got.append((struct.unpack("<q", buf)[0], tag))
    _run_threads([produce, consume])
    assert got == [(k, k) for k in range(n)]


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=[f"{w}_to_{r}" for w, r in DIRECTIONS])
def test_board_interoperates_with_jax(tmp_path, writer, reader):
    W, Rd = PKGS[writer], PKGS[reader]
    p = str(tmp_path / "board.bin")
    wr = W.Board.for_writer(p, 8, n_ranks=2, timeout=5.0)
    rd = Rd.Board.for_reader(p, 8, n_ranks=2, timeout=5.0)
    assert rd.read(1, lockstep=False) is None
    wr.write(struct.pack("<d", 1.0), readers=[1], lockstep=False)
    wr.write(struct.pack("<d", 2.0), readers=[1], lockstep=False)
    assert rd.read(1, lockstep=False) == struct.pack("<d", 2.0)
    # the lock-step reader walks the exact sequence and acks it, so the
    # writer may publish entry 4 over entry 2's slot
    assert rd.read(1, lockstep=True) == struct.pack("<d", 1.0)
    assert rd.read(1, lockstep=True) == struct.pack("<d", 2.0)
    wr.write(struct.pack("<d", 3.0), readers=[1], lockstep=True)
    wr.write(struct.pack("<d", 4.0), readers=[1], lockstep=True)
    assert rd.read(1, lockstep=True) == struct.pack("<d", 3.0)
    assert rd.read(1, lockstep=True) == struct.pack("<d", 4.0)


def test_mailbox_files_are_byte_identical_to_jax(tmp_path):
    """The same writes through either package leave the same bytes: the
    headers' layout, offsets and the barrier's cells."""
    assert mailbox.field_offsets(mailbox._MBX_HDR) == \
        jax_mailbox.field_offsets(jax_mailbox._MBX_HDR) == (0, 8, 16, 24)
    assert mailbox._SLOT_HDR.format == jax_mailbox._SLOT_HDR.format
    files = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        free = pkg.Mailbox.for_writer(str(d / "free.bin"), 16, timeout=5.0)
        lock = pkg.Mailbox.for_writer(str(d / "lock.bin"), 16, timeout=5.0)
        for k in range(3):
            free.write(struct.pack("<qq", k, -k), tag=10 + k, lockstep=False)
        lock.write(struct.pack("<qq", 5, 6), tag=4, lockstep=True)
        board = pkg.Board.for_writer(str(d / "board.bin"), 8, n_ranks=3,
                                     timeout=5.0)
        for k in range(3):
            board.write(struct.pack("<q", k), readers=[1, 2], lockstep=False)
        pkg.Barrier(str(d), 0, 1, timeout=5.0).arrive_and_wait()
        files[name] = {f: (d / f).read_bytes()
                       for f in ("free.bin", "lock.bin", "board.bin",
                                 "barrier.bin")}
    assert files["port"] == files["jax"]


def test_mailbox_reattach_and_dead_peer(tmp_path):
    """A restarted writer resumes the on-file sequence (free-run 2n, a
    crashed board slot's odd lock rounded up), and a lock-step read of a
    peer that never writes times out instead of hanging."""
    p = str(tmp_path / "edge.bin")
    wr = mailbox.Mailbox.for_writer(p, 8, timeout=5.0)
    for n in (1, 2):
        wr.write(struct.pack("<q", n), tag=n, lockstep=False)
    wr2 = mailbox.Mailbox.for_writer(p, 8, timeout=5.0)
    wr2.write(struct.pack("<q", 3), tag=3, lockstep=False)
    assert wr2._get(mailbox._MBX_OFF_WSEQ) == 6
    rd = jax_mailbox.Mailbox.for_reader(p, 8, timeout=5.0)
    assert rd.read(lockstep=False) == (struct.pack("<q", 3), 3)
    b = str(tmp_path / "board.bin")
    bw = mailbox.Board.for_writer(b, 8, n_ranks=1, timeout=5.0)
    bw.write(struct.pack("<q", 1), readers=[0], lockstep=False)
    struct.pack_into("<Q", bw._mm, mailbox._SLOT_OFF_LOCK, 1)   # died
    bw2 = mailbox.Board.for_writer(b, 8, n_ranks=1, timeout=0.5)
    assert struct.unpack_from("<Q", bw2._mm, mailbox._SLOT_OFF_LOCK)[0] == 2
    assert mailbox.Board.for_reader(b, 8, 1, 0.5).read(
        0, lockstep=False) == struct.pack("<q", 1)
    for w in (wr, wr2, bw, bw2):
        w.close()
    with pytest.raises(mailbox.MailboxTimeout):
        mailbox.Mailbox.for_reader(str(tmp_path / "x.bin"), 8,
                                   timeout=0.2).read(lockstep=True)


def test_freerun_window_serves_no_torn_entry(tmp_path):
    """One writer thread hammering a free-running window, more reader
    threads than cores, a short switch interval: every read decodes a
    complete entry (its 8 words agree with its tag) and each reader sees
    the entries in order."""
    p = str(tmp_path / "edge.bin")
    words, n_readers, n_writes = 8, os.cpu_count() + 2, 3000
    wr = mailbox.Mailbox.for_writer(p, 8 * words, timeout=10.0)
    done = threading.Event()

    def writer():
        try:
            for k in range(1, n_writes + 1):
                wr.write(struct.pack(f"<{words}q", *[k] * words), tag=k,
                         lockstep=False)
        finally:
            done.set()

    def reader():
        rd = mailbox.Mailbox.for_reader(p, 8 * words, timeout=10.0)
        last = 0
        while not done.is_set():
            got = rd.read(lockstep=False)
            if got is None:
                continue
            vals = struct.unpack(f"<{words}q", got[0])
            assert len(set(vals)) == 1 and vals[0] == got[1], vals
            assert got[1] >= last
            last = got[1]
        rd.close()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _run_threads([writer] + [reader] * n_readers)
    finally:
        sys.setswitchinterval(old)
    wr.close()


def test_payload_nbytes_takes_the_torch_itemsize():
    assert mailbox.payload_nbytes(10, torch.float32) == 40
    assert mailbox.payload_nbytes(10, torch.bfloat16) == 20


# ----------------------------------------------------------------------------
# wire format, jitter, topology, tracer


def test_tree_to_bytes_equals_jax():
    rng = np.random.default_rng(0)
    tree = {"w": [rng.standard_normal((1, 3, 4)).astype(np.float32)],
            "tag": np.array([5], np.int32),
            "b": rng.standard_normal((2,)).astype(np.float32)}
    port = tree_map(_t, tree)
    buf = tree_to_bytes(port)
    assert buf == jax_tree_to_bytes(jax.tree.map(jnp.asarray, tree))
    back = bytes_to_tree(buf, port)
    for a, b in zip(tree_leaves(back), tree_leaves(port)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    bf = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    assert tree_to_bytes(bf) == jax_tree_to_bytes(
        jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))
    assert torch.equal(bytes_to_tree(tree_to_bytes(bf), bf), bf)
    warm = warmup_like(port)
    assert float(warm["w"][0].abs().max()) == 0.0
    assert int(warm["tag"][0]) == -1


def test_jitter_sleep_equals_jax():
    for seed in (0, 3, 2**31 + 5):
        for lag, noise in ((0.0, 0.0), (10.0, 0.0), (0.0, 5.0), (7.5, 2.5)):
            p, j = JitterConfig(seed, lag, noise), JaxJitter(seed, lag, noise)
            assert p.enabled == j.enabled
            for rank in range(4):
                for epoch in (0, 1, 17, 999):
                    assert p.sleep_s(rank, epoch) == j.sleep_s(rank, epoch)
    cfg = JitterConfig(seed=3, rank_lag_ms=10.0, noise_ms=5.0)
    assert JitterConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == JaxJitter(3, 10.0, 5.0).to_dict()


@pytest.mark.parametrize("O,I", [(1, 4), (2, 4), (4, 2), (3, 1)])
def test_peers_equal_jax(O, I):
    for rank in range(O * I):
        p = ProcComm(O, I, rank, "/nonexistent")
        j = JaxProcComm(O, I, rank, "/nonexistent")
        for ch in ("inner", "outer", "all"):
            assert p._peers(ch) == j._peers(ch), (rank, ch)
        assert p.inner_index().tolist() == [int(j.inner_index())]


def test_proccomm_degenerate_topologies_and_dbtree(tmp_path):
    comm = ProcComm(1, 1, rank=0, run_dir=str(tmp_path))
    tree = {"w": torch.arange(3.0)[None]}
    for fn in (comm.recv_ring_inner, comm.recv_ring_outer,
               comm.recv_ring_all, comm.pmean_all):
        assert fn(tree) is tree       # no mailbox I/O at all
    assert os.listdir(tmp_path) == []
    with pytest.raises(NotImplementedError, match="proc backend"):
        comm.recv_hypercube(tree, 0)


def test_tracer_events_have_the_jax_keys(tmp_path):
    paths = {}
    for name, mod in (("jax", jax_trace), ("port", trace)):
        paths[name] = str(tmp_path / f"trace_rank{name}.jsonl")
        t = mod.Tracer(paths[name], rank=3)
        mod.install(t)
        with mod.span("epoch", cat="epoch", epoch=1):
            mod.instant("mark", x=1)
        mod.counter("k_eff", 2)
        assert mod.uninstall() is t and mod.current_tracer() is None
        t.close()
    with open(paths["port"], "a") as f:
        f.write('{"torn')                       # a killed writer's tail
    evs = {n: jax_trace.load_events(p) for n, p in paths.items()}
    assert evs["port"][1] == 1 and evs["jax"][1] == 0
    shape = {n: [(e["name"], e["ph"], e["pid"], sorted(e),
                  sorted(e.get("args", {}))) for e in ev]
             for n, (ev, _) in evs.items()}
    assert shape["port"] == shape["jax"]
    merged = jax_trace.merge_traces([paths["port"]])
    assert trace.merge_traces([paths["jax"]])["traceEvents"][0] == \
        merged["traceEvents"][0]
    assert trace.span("off") is trace.span("off")   # nothing installed


# ----------------------------------------------------------------------------
# workflow pieces


def test_init_run_rank_is_the_stacked_rows():
    wcfg, data = small_wcfg(), _data()
    g = torch.Generator().manual_seed(11)
    stacked, dpr = workflow.init_run(g, 4, wcfg, data, "cpu")
    after = g.get_state()
    for r in range(4):
        g = torch.Generator().manual_seed(11)
        st, d = workflow.init_run(g, 4, wcfg, data, "cpu", rank=r)
        assert torch.equal(g.get_state(), after)
        for (k, a), b in zip(tree_paths(st), tree_leaves(stacked)):
            assert a.shape[0] == 1 and torch.equal(a[0], b[r]), (r, k)
        assert torch.equal(d[0], dpr[r])


def test_wcfg_json_roundtrip():
    wcfg = small_wcfg("conv_arar", h=7)
    assert wcfg_from_dict(json.loads(json.dumps(wcfg_to_dict(wcfg)))) == wcfg


def _grads(R, seed):
    rng = np.random.default_rng(seed)
    widths = (135, 128, 128, 128, 6)
    return [{"w": rng.standard_normal((R, a, b)).astype(np.float32),
             "b": rng.standard_normal((R, b)).astype(np.float32)}
            for a, b in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("mode", ["conv_arar", "arar_arar", "rma_arar_arar",
                                  "allreduce"])
def test_proccomm_exchange_is_jax_vmapcomm_bitwise(tmp_path, mode):
    O, I, epochs = 2, 2, 3
    R = O * I
    jcfg = JW.WorkflowConfig(sync=JS.SyncConfig(mode=mode, h=2))
    js, jst = JW.make_schedule(jcfg), None
    grads = [_grads(R, 40 + e) for e in range(epochs)]
    want = []
    jst = js.init_state(R)
    for e in range(epochs):
        synced, jst = js.exchange(JaxVmapComm(O, I), jax.tree.map(
            jnp.asarray, grads[e]), jst, e)
        want.append(jax.tree.leaves({"a": synced, "b": jst}))
    ps = workflow.make_schedule(small_wcfg(mode))
    st0 = ps.init_state(R, "cpu")
    got = [[None] * R for _ in range(epochs)]

    def rank(r):
        comm = ProcComm(O, I, r, str(tmp_path), timeout=60.0)
        st = workflow.rank_rows(st0, r)
        for e in range(epochs):
            comm.begin_epoch(e)
            synced, st = ps.exchange(comm, workflow.rank_rows(
                tree_map(_t, grads[e]), r), st, torch.tensor(e))
            got[e][r] = {"a": synced, "b": st}
        comm.close()
    _run_threads([lambda r=r: rank(r) for r in range(R)])
    for e in range(epochs):
        stacked = tree_map(lambda *xs: torch.cat(xs), *got[e])
        for (k, a), b in zip(tree_paths(stacked), want[e]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"epoch {e} {k}")


# ----------------------------------------------------------------------------
# spawned runs: 2 worker processes on the CPU


@pytest.fixture(scope="module")
def proc_run_1x2(tmp_path_factory):
    """One 3-epoch lock-step run (1 x 2, rma_arar_arar, h 2) that keeps
    its run directory and checkpoints every epoch."""
    d = str(tmp_path_factory.mktemp("proc") / "run")
    wcfg = small_wcfg()
    return wcfg, run_proc(wcfg, 1, 2, 3, _data(), seed=0, run_dir=d,
                          ckpt_every=1, device="cpu", timeout=300)


def _assert_bitwise(got, want, what):
    for (k, a), b in zip(tree_paths(got), tree_leaves(want)):
        assert torch.equal(a, b), f"{what}: state[{k!r}]"


def test_proc_lockstep_1x2_is_bitwise_its_reference(proc_run_1x2):
    wcfg, out = proc_run_1x2
    assert sorted(out["state"]) == ["disc", "disc_opt", "epoch", "gen",
                                    "gen_opt", "sync"]
    _assert_bitwise(out["state"], lockstep_reference(
        0, wcfg, 1, 2, 3, _data(), device="cpu"), "1 x 2")
    assert [s["device"] for s in out["summaries"]] == ["cpu", "cpu"]
    assert all(s["lockstep"] for s in out["summaries"])
    assert out["counts"]["inverse_cdf"] == (0, 6, 0, 6)
    assert out["history"]["d_loss"].shape == (3, 2)
    assert out["history"]["residuals"].shape == (3, 2, 6)
    assert out["startup_s"] < out["wall_s"]


def test_lockstep_cpu_threads_are_fixed_and_restored(proc_run_1x2,
                                                    monkeypatch):
    """Queue C item 6: a lock-step CPU run's workers (their runconfig,
    `torch.get_num_threads()` and `MKL_NUM_THREADS`) and
    `lockstep_reference` compute at `LOCKSTEP_CPU_THREADS` intra-op
    threads, and the caller's count is back after the reference.
    Free-running and CUDA runs keep the caller's count."""
    wcfg, out = proc_run_1x2
    n = launch.LOCKSTEP_CPU_THREADS
    assert n == 1
    with open(os.path.join(out["run_dir"], "runconfig.json")) as f:
        assert json.load(f)["num_threads"] == n
    assert [(s["num_threads"], s["mkl_num_threads"])
            for s in out["summaries"]] == [(n, str(n))] * 2
    seen, real = [], workflow.rank_grads

    def spy(*args):
        seen.append(torch.get_num_threads())
        return real(*args)
    monkeypatch.setattr(workflow, "rank_grads", spy)
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        lockstep_reference(0, wcfg, 1, 2, 1, _data(), device="cpu")
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
    assert seen == [n, n]               # one rank_grads a rank
    assert launch.lockstep_threads(False, torch.device("cpu")) is None
    assert launch.lockstep_threads(True, torch.device("cuda")) is None


def test_proc_lockstep_2x1_is_bitwise_its_reference():
    wcfg = small_wcfg()
    out = run_proc(wcfg, 2, 1, 3, _data(), seed=0, device="cpu",
                   timeout=300)
    _assert_bitwise(out["state"], lockstep_reference(
        0, wcfg, 2, 1, 3, _data(), device="cpu"), "2 x 1")
    assert out["run_dir"] is None


def test_proc_lockstep_is_within_1e6_of_train_stacked(proc_run_1x2):
    wcfg, out = proc_run_1x2
    stacked, hist = workflow.train_stacked(0, wcfg, 1, 2, 3, _data(),
                                           device="cpu")
    worst = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(stacked), tree_leaves(out["state"])))
    assert worst < 1e-6, worst
    torch.testing.assert_close(out["history"]["d_loss"][-1],
                               hist["d_loss"][-1], rtol=1e-5, atol=0)


def test_proc_resume_is_bitwise(proc_run_1x2):
    """Resume the kept run directory at 3 epochs after corrupting rank
    1's step 3: the launcher negotiates step 2, and the result is the
    uninterrupted run's bit for bit."""
    wcfg, full = proc_run_1x2
    d = full["run_dir"]
    npz = os.path.join(d, "ckpt", "rank_1", "step_00000003", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(100)
    with pytest.warns(UserWarning, match="step_3 unreadable"):
        res = run_proc(wcfg, 1, 2, 3, _data(), seed=0, run_dir=d,
                       ckpt_every=1, resume=True, device="cpu", timeout=300)
    assert [s["start_epoch"] for s in res["summaries"]] == [2, 2]
    assert res["history"]["d_loss"].shape == (1, 2)
    _assert_bitwise(res["state"], full["state"], "resumed")
    torch.testing.assert_close(res["history"]["d_loss"],
                               full["history"]["d_loss"][-1:], rtol=0, atol=0)


def test_proc_free_run_with_jitter_ends_finite():
    wcfg = small_wcfg()
    state, hist = workflow.train_proc(
        0, wcfg, 1, 2, 6, _data(), device="cpu", timeout=300,
        jitter=JitterConfig(rank_lag_ms=20.0))
    for k, leaf in tree_paths(state):
        assert bool(torch.isfinite(leaf.float()).all()), k
    assert hist["d_loss"].shape == (6, 2)
    assert bool(torch.isfinite(hist["d_loss"]).all())
    # a deposit landed: some rank's RMA mailbox is no longer the warmup
    assert any(float(leaf.abs().max()) > 0
               for leaf in tree_leaves(state["sync"]["mailbox"]))


def test_proc_refusals(tmp_path):
    wcfg = small_wcfg()
    with pytest.raises(ValueError, match="resume=True needs ckpt_every"):
        run_proc(wcfg, 1, 2, 3, _data(), resume=True, run_dir=str(tmp_path),
                 device="cpu")
    # a run whose workers cannot finish in time raises with their logs
    with pytest.raises(RuntimeError, match="proc runtime failed: timed out"):
        run_proc(wcfg, 1, 2, 3, _data(), device="cpu", timeout=0.5,
                 run_dir=str(tmp_path / "short"))
    assert os.path.exists(tmp_path / "short" / "worker_1.log")


def test_proc_without_device_asks_for_cuda_here(tmp_path):
    """Without `device` the run (and a worker whose runconfig asks for
    CUDA) raises on a host without CUDA; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="is_available"):
        run_proc(small_wcfg(), 1, 2, 1, _data(), run_dir=str(tmp_path))
    with open(tmp_path / "runconfig.json", "w") as f:
        json.dump({"device": "cuda"}, f)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.launch", "--worker",
         "--rank", "0", "--run-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "is_available" in out.stderr
