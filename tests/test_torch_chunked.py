"""The chunked ring (`SyncConfig(ring_chunking=N)`, ROADMAP.md queue A item
3b) of the port against the JAX package's, on the CPU, and the four other
problems on the proc runtime.

  geometry    `FusionSpec.n_segments`, `segment_bounds`, `split_payload`
              and `join_payload` equal JAX's, stacked and flat, at fp32
              and bf16: unchunked, an oversized chunk, a small example,
              and 65,536 B on the `PAPER` generator (50,816 scalars: 4
              segments at fp32, 2 at bf16)
  schedule    3 epochs of `StaticSchedule.exchange` on `VmapComm` 2 x 4
              on gradients JAX made, in conv_arar, arar_arar, dbtree and
              rma_arar_arar h 2, at fp32 and bf16: the outputs and every
              sync-state leaf bitwise the port's unchunked run and JAX's
              chunked run (the port's row of
              tests/test_chunked_ring.py::test_chunked_bitwise_on_vmap_schedule)
  windows     the files of chunked `ProcComm` transfers between two ranks
              byte-identical to the ones JAX's `ProcComm` leaves; the
              payload serialized in one copy in JAX's wire format; a
              free-running read of an empty window is the warmup
  proc        a lock-step 1 x 2 proxy1d run at 65,536 B bitwise its
              unchunked twin and `lockstep_reference`, 4 windows a channel
  problems    proxy2d, linear_blur (65,536 B), imaging and imaging_blur
              (524,288 B: 3 windows) as 2 lock-step worker processes,
              bitwise `lockstep_reference`, finite, B2 or B3 counted
  CLI         `train_gan --ring-chunking`, stacked and `--backend proc`

The card's side is `chip_smoke.py` phases 38-39.
"""
import glob
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import sync as JS
from repro.core import workflow as JW
from repro.core.ring import VmapComm as JaxVmapComm
from repro.runtime.proccomm import ProcComm as JaxProcComm

from repro_torch.configs.sagips_gan import PAPER, for_problem
from repro_torch.core import sync, workflow
from repro_torch.core.ring import VmapComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
from repro_torch.problems import get_problem
from repro_torch.runtime import mailbox
from repro_torch.runtime.launch import lockstep_reference, run_proc
from repro_torch.runtime.proccomm import ProcComm

CHUNK = 65_536               # proxy1d's 50,816 fp32 scalars -> 4 segments
IMAGE_CHUNK = 524_288        # the image problems' 290,448 -> 3 segments
PAYLOAD = 50_816             # the proxy1d generator's weights a rank
IMAGE_PAYLOAD = 290_448      # the conv generator's
MODES = ("conv_arar", "arar_arar", "dbtree", "rma_arar_arar")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _port_leaf(a):
    """A JAX leaf as a torch tensor of its dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A tensor's bit pattern as numpy (bf16 as int16)."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_bitwise(got, want, what):
    """Two port trees, or a port tree and JAX's leaves, bit for bit."""
    want = tree_leaves(want) if not isinstance(want, list) else want
    got = list(tree_paths(got))
    assert len(got) == len(want), what
    for (k, a), b in zip(got, want):
        b = _port_leaf(b) if not isinstance(b, torch.Tensor) else b
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {k}"
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what}: {k}")


def _wcfgs(chunk, mode="rma_arar_arar", precision="fp32", h=2):
    """The same small proxy1d settings as a JAX and a port config."""
    kw = dict(mode=mode, h=h, payload_precision=precision,
              ring_chunking=chunk)
    small = dict(problem="proxy1d", n_param_samples=8, events_per_sample=4)
    return (JW.WorkflowConfig(sync=JS.SyncConfig(**kw), **small),
            workflow.WorkflowConfig(sync=sync.SyncConfig(**kw), **small))


def _data(problem="proxy1d", n=400, seed=7):
    return get_problem(problem).make_reference_data(
        torch.Generator().manual_seed(seed), n, device="cpu")


# ----------------------------------------------------------------------------
# segment geometry


def _small_specs(chunk, precision):
    dt = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    j = JS.FusionSpec.build({"w": jnp.zeros((100,)), "b": jnp.zeros((3,))},
                            {"w": True, "b": False}, payload_dtype=dt[0],
                            chunk_bytes=chunk)
    p = sync.FusionSpec.build({"w": torch.zeros(100), "b": torch.zeros(3)},
                              {"w": True, "b": False}, payload_dtype=dt[1],
                              chunk_bytes=chunk)
    return j, p


def _paper_specs(chunk, precision):
    jw, pw = _wcfgs(chunk, precision=precision)
    return JW.make_schedule(jw).spec, workflow.make_schedule(pw).spec


GEOMETRY = [("small", c, p) for c in (0, 128, 400, 4096)
            for p in ("fp32", "bf16")] + \
    [("paper", c, p) for c in (0, CHUNK, 1 << 20) for p in ("fp32", "bf16")]


@pytest.mark.parametrize("which,chunk,precision", GEOMETRY,
                         ids=[f"{w}-{c}-{p}" for w, c, p in GEOMETRY])
def test_segment_geometry_and_round_trip_equal_jax(which, chunk, precision):
    jspec, pspec = (_small_specs if which == "small" else _paper_specs)(
        chunk, precision)
    assert pspec.total == jspec.total
    assert pspec.n_segments == jspec.n_segments
    assert pspec.segment_bounds() == jspec.segment_bounds()
    if which == "paper":
        want = {(0, "fp32"): 1, (0, "bf16"): 1, (CHUNK, "fp32"): 4,
                (CHUNK, "bf16"): 2, (1 << 20, "fp32"): 1,
                (1 << 20, "bf16"): 1}[chunk, precision]
        assert pspec.total == PAYLOAD and pspec.n_segments == want
    rng = np.random.default_rng(chunk + pspec.total)
    for shape in ((pspec.total,), (5, pspec.total)):      # flat, stacked
        v = rng.standard_normal(shape).astype(np.float32)
        jv = jnp.asarray(v).astype(jspec.payload_dtype)
        pv = torch.from_numpy(v).to(pspec.payload_dtype)
        jsegs, psegs = jspec.split_payload(jv), pspec.split_payload(pv)
        assert isinstance(psegs, tuple) and len(psegs) == len(jsegs)
        for a, b in zip(psegs, jsegs):
            np.testing.assert_array_equal(_bits(a), _bits(_port_leaf(b)))
        np.testing.assert_array_equal(_bits(pspec.join_payload(psegs)),
                                      _bits(pv))


# ----------------------------------------------------------------------------
# the schedule on VmapComm: chunked = unchunked = JAX's chunked, bitwise

SCHEDULE = [(m, p) for m in MODES for p in ("fp32", "bf16")]


@pytest.mark.parametrize("mode,precision", SCHEDULE,
                         ids=[f"{m}-{p}" for m, p in SCHEDULE])
def test_chunked_exchange_is_bitwise_unchunked_and_jax(mode, precision):
    R, O, I = 8, 2, 4
    jw, _ = _wcfgs(CHUNK, mode, precision)
    jsched = JW.make_schedule(jw)
    assert jsched.spec.n_segments == (4 if precision == "fp32" else 2)
    grads = [jax.tree.map(lambda x, e=e: jax.random.normal(
        jax.random.PRNGKey(17 * e), x.shape, x.dtype),
        jsched._grads_example(R)) for e in range(3)]
    jst, want = jsched.init_state(R), []
    for e in range(3):
        out, jst = jsched.exchange(JaxVmapComm(O, I), grads[e], jst,
                                   jnp.asarray(e))
        want.append(jax.tree.leaves((out, jst)))
    runs = {}
    for chunk in (0, CHUNK):
        _, pw = _wcfgs(chunk, mode, precision)
        sched = workflow.make_schedule(pw)
        assert sched.spec.n_segments == (1 if not chunk else
                                         jsched.spec.n_segments)
        st, outs = sched.init_state(R, "cpu"), []
        for e in range(3):
            out, st = sched.exchange(VmapComm(O, I),
                                     tree_map(_port_leaf, grads[e]), st,
                                     torch.tensor(e))
            outs.append((out, st))
        runs[chunk] = outs
    for e in range(3):
        _assert_bitwise(runs[CHUNK][e], runs[0][e],
                        f"{mode} {precision} epoch {e}: chunked vs unchunked")
        _assert_bitwise(runs[CHUNK][e], want[e],
                        f"{mode} {precision} epoch {e}: chunked vs JAX")
    # storage stays flat: the outer mailbox is the [R, D] payload
    assert runs[CHUNK][-1][1]["outer_mailbox"].shape == (R, PAYLOAD)


# ----------------------------------------------------------------------------
# the chunked windows on ProcComm: the JAX package's files


def _exchange_files(d, make_comm, payload, epochs=2):
    """Two ranks (1 x 2) exchange `payload(rank, epoch)` on the inner
    ring, one thread a rank, lock-step; returns {file name: bytes}."""
    errors = []

    def rank(r):
        try:
            comm = make_comm(r)
            for e in range(epochs):
                comm.begin_epoch(e)
                comm.recv_ring_inner(payload(r, e))
            if hasattr(comm, "close"):
                comm.close()
        except Exception as e:          # re-raised below, in the test
            errors.append(e)
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "mbx_*.bin")))}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_window_files_are_byte_identical_to_jax(tmp_path, precision):
    """A tuple of three segments (1,000 scalars) through 1,536-byte
    windows: 3 windows at fp32, 2 at bf16, the same files either way."""
    jdt, pdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((2, 2, 1, 1000)).astype(np.float32)
    cuts = ((0, 400), (400, 800), (800, 1000))

    def segs(v, to):
        return tuple(to(v[:, a:b]) for a, b in cuts)
    files = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        if name == "jax":
            make = lambda r: JaxProcComm(1, 2, r, str(d), timeout=30.0,  # noqa
                                         window_bytes=1536)
            payload = lambda r, e: segs(vals[r, e], lambda x: jnp.asarray(  # noqa
                x).astype(jdt))
        else:
            make = lambda r: ProcComm(1, 2, r, str(d), timeout=30.0,  # noqa
                                      window_bytes=1536)
            payload = lambda r, e: segs(vals[r, e], lambda x: torch.from_numpy(  # noqa
                x.copy()).to(pdt))
        files[name] = _exchange_files(str(d), make, payload)
    n = 3 if precision == "fp32" else 2
    assert sorted(files["port"]) == sorted(
        f"mbx_{a}to{b}_innerw{i}.bin" for a, b in ((0, 1), (1, 0))
        for i in range(n))
    assert files["port"] == files["jax"]


def test_wire_of_mixed_leaves_equals_jax():
    """A payload serialized in one copy keeps JAX's bytes, and reads back
    leaves that start off their dtype's alignment (a bf16 leaf of 3
    before fp32 and int32 ones)."""
    from repro.runtime.proccomm import tree_to_bytes as jax_tree_to_bytes
    from repro_torch.runtime.proccomm import bytes_to_tree, tree_to_bytes
    rng = np.random.default_rng(5)
    a = rng.standard_normal(3).astype(np.float32)
    b = rng.standard_normal((2, 2)).astype(np.float32)
    tree = (torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b),
            torch.tensor([7], dtype=torch.int32))
    buf = tree_to_bytes(tree)
    assert buf == jax_tree_to_bytes((jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b), jnp.asarray([7],
                                                                 jnp.int32)))
    back = bytes_to_tree(buf, tree)
    assert isinstance(back, tuple)
    for x, y in zip(back, tree):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_free_run_read_of_an_empty_window_is_the_warmup(tmp_path):
    """A free-running rank whose predecessor has not deposited yet gets
    zeros shaped like its own segments."""
    comm = ProcComm(1, 2, 0, str(tmp_path), lockstep=False, timeout=5.0,
                    window_bytes=64)
    segs = (torch.ones(1, 20), torch.ones(1, 30))
    got = comm.recv_ring_inner(segs)
    comm.close()
    assert isinstance(got, tuple) and [t.shape for t in got] == \
        [t.shape for t in segs]
    assert not any(bool(t.any()) for t in got)
    assert len(glob.glob(str(tmp_path / "mbx_0to1_innerw*.bin"))) == 4


# ----------------------------------------------------------------------------
# spawned runs: 2 worker processes on the CPU


@pytest.fixture(scope="module")
def proc_pair(tmp_path_factory):
    """3 lock-step epochs (1 x 2, rma_arar_arar, h 2) unchunked and at
    65,536 B, each keeping its run directory."""
    out = {}
    for chunk in (0, CHUNK):
        d = str(tmp_path_factory.mktemp(f"chunk{chunk}") / "run")
        out[chunk] = run_proc(_wcfgs(chunk)[1], 1, 2, 3, _data(), seed=0,
                              run_dir=d, device="cpu", timeout=300)
    return out


def test_proc_chunked_is_bitwise_unchunked_and_reference(proc_pair):
    _assert_bitwise(proc_pair[CHUNK]["state"], proc_pair[0]["state"],
                    "chunked vs unchunked proc run")
    _assert_bitwise(proc_pair[CHUNK]["state"], lockstep_reference(
        0, _wcfgs(CHUNK)[1], 1, 2, 3, _data(), device="cpu"),
        "chunked proc run vs lockstep_reference")
    # a deposit crossed: the mailbox is no longer the warmup zeros
    assert float(proc_pair[CHUNK]["state"]["sync"]["mailbox"][0]["w"]
                 .abs().max()) > 0


def test_proc_chunked_windows_on_disk(proc_pair):
    """4 windows a channel (3 of 65,536 B and the 6,656 B remainder), the
    unchunked run's one window of 203,264 B under the bare name."""
    hdr = mailbox._MBX_HDR.size
    d = proc_pair[CHUNK]["run_dir"]
    for r, succ in ((0, 1), (1, 0)):
        sizes = [os.path.getsize(os.path.join(
            d, f"mbx_{r}to{succ}_innerw{i}.bin")) - hdr for i in range(4)]
        assert sizes == [CHUNK] * 3 + [4 * PAYLOAD - 3 * CHUNK]
        assert not os.path.exists(os.path.join(
            d, f"mbx_{r}to{succ}_inner.bin"))
    assert os.path.getsize(os.path.join(
        proc_pair[0]["run_dir"], "mbx_0to1_inner.bin")) == hdr + 4 * PAYLOAD


PROBLEMS = {"proxy2d": CHUNK, "linear_blur": CHUNK,
            "imaging": IMAGE_CHUNK, "imaging_blur": IMAGE_CHUNK}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_runs_lockstep_on_proc(tmp_path, name):
    chunk = PROBLEMS[name]
    wcfg = for_problem(name, workflow.WorkflowConfig(
        sync=sync.SyncConfig(mode="rma_arar_arar", h=2,
                             ring_chunking=chunk),
        n_param_samples=8, events_per_sample=4))
    spec = workflow.make_schedule(wcfg).spec
    image = get_problem(name).param_shape is not None
    if image:
        assert spec.total == IMAGE_PAYLOAD and spec.n_segments == 3
    data = _data(name, n=256, seed=3)
    out = run_proc(wcfg, 1, 2, 2, data, seed=0, run_dir=str(tmp_path),
                   device="cpu", timeout=300)
    _assert_bitwise(out["state"], lockstep_reference(
        0, wcfg, 1, 2, 2, data, device="cpu"), f"{name} on proc")
    for k, leaf in tree_paths(out["state"]):
        assert bool(torch.isfinite(leaf.float()).all()), k
    n = len(glob.glob(str(tmp_path / "mbx_0to1_innerw*.bin")))
    assert n == spec.n_segments > 1
    # the forward model's kernel, on its plain version here: 2 epochs in
    # each of 2 workers (B1's backward only where the gradient reaches it)
    forward = {"imaging": "mask_apply", "imaging_blur": "blur2d"}.get(name)
    counts = out["counts"]
    assert counts["inverse_cdf"] == (0, 4, 0, 0 if image else 4)
    for k in ("mask_apply", "blur2d"):
        assert counts[k] == ((0, 4, 0, 4) if k == forward else (0, 0, 0, 0))


# ----------------------------------------------------------------------------
# the CLI


def test_train_gan_cli_ring_chunking(capsys):
    from repro_torch.launch import train_gan
    train_gan.main(["--device", "cpu", "--preset", "reduced", "--ranks",
                    "4", "--epochs", "2", "--events", "1000",
                    "--ring-chunking", str(CHUNK)])
    out = capsys.readouterr().out
    assert f"ring_chunking={CHUNK} (4 segments)" in out
    assert "serving-path solve" in out
    state = train_gan.main(["--device", "cpu", "--backend", "proc",
                            "--num-procs", "2", "--epochs", "2",
                            "--param-samples", "8", "--events", "1000",
                            "--ring-chunking", str(CHUNK)])
    out = capsys.readouterr().out
    assert "2 worker processes (1 x 2), lock-step" in out
    assert f"ring_chunking={CHUNK} (4 segments)" in out
    assert state["sync"]["outer_mailbox"].shape == (2, PAYLOAD)
    # what the JAX package refuses, with its message
    with pytest.raises(ValueError) as want:
        JS.SyncConfig(ring_chunking=CHUNK, fuse_tensors=False)
    with pytest.raises(ValueError) as got:
        train_gan.main(["--device", "cpu", "--ring-chunking", str(CHUNK),
                        "--no-fuse"])
    assert str(got.value) == str(want.value)
