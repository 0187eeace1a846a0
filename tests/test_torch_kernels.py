"""The port's inverse-CDF sampler against the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX sampler
(`repro.kernels.inverse_cdf` in Pallas interpret mode, its channel fold,
and the `repro.kernels.ref` oracle) and through the port's wrappers,
which on CPU tensors take the plain PyTorch version.  Tolerances are
those of tests/test_kernels.py: rtol 1e-4 / atol 1e-5 in fp32, 2e-2 in
bf16.  The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py and `chip_smoke.py`.

Also here: the guards of the port's rules — no module of `repro_torch`
and not `chip_smoke.py` imports JAX or the JAX package, the device policy
raises without CUDA, a non-CPU tensor never takes the plain version, the
kernel build has no fallback, and `chip_smoke.py` fails without a card.
"""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro.kernels.inverse_cdf import inverse_cdf as jax_inverse_cdf
from repro.kernels.inverse_cdf import \
    inverse_cdf_channels as jax_inverse_cdf_channels

import repro_torch
from repro_torch import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.inverse_cdf import (counts, inverse_cdf,
                                             inverse_cdf_channels)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# ragged shapes that are not multiples of the Pallas 256 x 128 block
SHAPES = [(1, 1), (3, 5), (256, 128), (257, 130), (300, 129), (513, 64)]


def _inputs(K, E, C=None, seed=0):
    """u uniform in (0, 1); mu/s/k per row (per row and channel with C)."""
    rng = np.random.default_rng(seed)
    u_shape = (K, E) if C is None else (K, E, C)
    p_shape = (K,) if C is None else (K, C)
    u = rng.uniform(size=u_shape).astype(np.float32)
    mu = rng.uniform(-2.0, 2.0, p_shape).astype(np.float32)
    s = rng.uniform(0.05, 1.0, p_shape).astype(np.float32)
    k = rng.uniform(-1.0, 1.0, p_shape).astype(np.float32)
    return u, mu, s, k


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bf16_roundtrip(u):
    """u rounded to bf16, as an fp32 numpy array both sides can take."""
    return np.array(jnp.asarray(u, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("K,E", SHAPES)
def test_inverse_cdf_matches_jax_fp32(K, E):
    u, mu, s, k = _inputs(K, E, seed=K * 1000 + E)
    y = inverse_cdf(*_t(u, mu, s, k))
    assert y.shape == (K, E) and y.dtype == torch.float32
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_inverse_cdf(u, mu, s, k, interpret=True)),
        **FP32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_ref.inverse_cdf_ref(u, mu, s, k)), **FP32)


@pytest.mark.parametrize("K,E", [(3, 5), (257, 130), (300, 129)])
def test_inverse_cdf_matches_jax_bf16(K, E):
    u, mu, s, k = _inputs(K, E, seed=K + E)
    ub = _bf16_roundtrip(u)
    y = inverse_cdf(torch.from_numpy(ub).bfloat16(), *_t(mu, s, k))
    assert y.dtype == torch.bfloat16
    y_jax = jax_inverse_cdf(jnp.asarray(ub, jnp.bfloat16), mu, s, k,
                            interpret=True)
    assert y_jax.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_jax.astype(jnp.float32)), **BF16)
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(jax_ref.inverse_cdf_ref(jnp.asarray(ub, jnp.bfloat16),
                                           mu, s, k)), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("K,E", [(3, 5), (257, 130), (300, 64)])
def test_inverse_cdf_channels_matches_jax(K, E, C, dtype):
    u, mu, s, k = _inputs(K, E, C, seed=K * 10 + E + C)
    tol = FP32
    if dtype == "bfloat16":
        u, tol = _bf16_roundtrip(u), BF16
    y = inverse_cdf_channels(torch.from_numpy(u).to(getattr(torch, dtype)),
                             *_t(mu, s, k))
    assert y.shape == (K, E, C) and y.dtype == getattr(torch, dtype)
    y_jax = jax_inverse_cdf_channels(jnp.asarray(u, dtype), mu, s, k,
                                     interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_jax.astype(jnp.float32)), **tol)


def test_clamp_edges_and_nan_match_jax():
    """u at and beyond the clamp, and NaN: NaN stays NaN as with jnp.clip,
    and the clamped values agree."""
    u = np.array([[0.0, 1.0, -3.0, 4.0, 1e-7, 1 - 1e-7, 0.5, np.nan]],
                 np.float32)
    mu, s, k = (np.array([v], np.float32) for v in (0.3, 0.7, -0.2))
    y = inverse_cdf(*_t(u, mu, s, k)).numpy()
    y_jax = np.asarray(jax_inverse_cdf(u, mu, s, k, interpret=True))
    np.testing.assert_array_equal(np.isnan(y), np.isnan(y_jax))
    assert np.isnan(y[0, -1])
    np.testing.assert_allclose(y[:, :-1], y_jax[:, :-1], **FP32)


def test_cpu_tensors_take_the_plain_version():
    counts.reset()
    u, mu, s, k = _t(*_inputs(4, 6, 2))
    inverse_cdf_channels(u, mu, s, k)
    inverse_cdf(u[..., 0].contiguous(), mu[:, 0], s[:, 0], k[:, 0])
    assert counts.launches == 0 and counts.plain_calls == 2


def test_channel_output_reshapes_without_copy():
    K, E, C = 5, 7, 2
    y = inverse_cdf_channels(*_t(*_inputs(K, E, C)))
    assert y.is_contiguous()
    assert y.reshape(K * E, C).data_ptr() == y.data_ptr()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u, mu, s, k = _t(*_inputs(4, 6, 2))
    with pytest.raises(ValueError):
        inverse_cdf_channels(u, mu[:3], s, k)              # rows
    with pytest.raises(ValueError):
        inverse_cdf_channels(u[..., 0], mu, s, k)          # not [K, E, C]
    with pytest.raises(ValueError):
        inverse_cdf(u, mu, s, k)                           # not [K, E]
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            inverse_cdf_channels(u.to(dtype), mu, s, k)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor goes to the plain version: any other device
    launches the kernel or raises, and counts no plain call."""
    counts.reset()
    u, mu, s, k = (torch.empty(x.shape, device="meta")
                   for x in _t(*_inputs(4, 6, 2)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        inverse_cdf_channels(u, mu, s, k)
    assert counts.plain_calls == 0 and counts.launches == 0


def test_kernel_build_command():
    """sm_90a, no fast math (fp32 tolerance), into the ignored build dir,
    and the library name follows the source's content."""
    lib = build.library_path("inverse_cdf")
    assert lib.parent == build.BUILD_DIR
    assert str(build.BUILD_DIR).startswith(os.path.join(ROOT, "build"))
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in build.NVCC_FLAGS)
    assert set(build.SOURCES) == {p[:-3] for p in os.listdir(build.CSRC)
                                  if p.endswith(".cu")}
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_kernel_build_has_no_fallback(monkeypatch):
    """Without nvcc the build raises; it never substitutes a plain path."""
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")  # the card's machine
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_resolve_device_policy():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


# ----------------------------------------------------------------------------
# import guards


FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_modules():
    pkg = os.path.dirname(repro_torch.__file__)
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages([pkg], prefix="repro_torch."))


def _port_sources():
    pkg = os.path.dirname(repro_torch.__file__)
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_sources_import_nothing_of_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


# the obs layering, the port's form of scripts/repro_lint.py check 9:
# the epoch's core records into the schedule's obs tree, never through the
# host-side tracer or counters; the proc runtime and serving never import
# the metrics flush
OBS_CORE = ("core/sync.py", "core/workflow.py", "core/ring.py")
OBS_HOST = ("obs.trace", "obs.counters")      # not in OBS_CORE
OBS_METRICS = "obs.metrics"                   # not in runtime/, serving/


def _obs_imports(tree):
    """(lineno, dotted path) of every import, relative dots stripped:
    `from ..obs import trace` -> `obs.trace`."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                yield node.lineno, f"{node.module or ''}.{a.name}".lstrip(".")


def obs_layering_problems(sources):
    """`sources` maps a path under src/repro_torch to its text."""
    bad = []
    for rel, src in sources.items():
        for lineno, path in _obs_imports(ast.parse(src)):
            if rel in OBS_CORE and any(h in path for h in OBS_HOST):
                bad.append(f"{rel}:{lineno}: the core imports {path}")
            if rel.startswith(("runtime/", "serving/")) and \
                    OBS_METRICS in path:
                bad.append(f"{rel}:{lineno}: a host backend imports {path}")
    return bad


def test_port_obs_layering():
    pkg = os.path.dirname(repro_torch.__file__)
    sources = {}
    for path in _port_sources()[1:]:
        with open(path) as f:
            sources[os.path.relpath(path, pkg).replace(os.sep, "/")] = f.read()
    assert set(OBS_CORE) <= set(sources)
    assert obs_layering_problems(sources) == []
    # the guard sees each rule broken, and lets the right split through
    assert len(obs_layering_problems({
        "core/workflow.py": "from ..obs.trace import span\n",
        "core/sync.py": "from ..obs import counters\n",
        "runtime/launch.py": "from ..obs.metrics import chunk_row\n",
        "serving/queue.py": "from ..obs import metrics\n"})) == 4
    assert obs_layering_problems({
        "core/workflow.py": "from ..obs.config import ObsConfig\n"
                            "from ..obs.metrics import MetricsWriter\n",
        "runtime/mailbox.py": "from ..obs.trace import span as _span\n",
        "serving/service.py": "from ..obs.counters import Counters\n"}) == []


def test_importing_the_port_loads_no_jax():
    """Every module of the port and chip_smoke.py, imported in a fresh
    interpreter, leave no jax*, ml_dtypes or repro.* in sys.modules."""
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert len(_port_modules()) >= 20
    assert {"repro_torch.models.convgen", "repro_torch.kernels.imaging",
            "repro_torch.problems.imaging", "repro_torch.kernels.ssd_scan",
            "repro_torch.models.ssm", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.data.pipeline",
            "repro_torch.training.trainer", "repro_torch.launch.train",
            "repro_torch.configs.mamba2_130m"} <= set(_port_modules())


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA: non-zero exit and no result line.  Alone in a directory
    (without the repo): the same."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = _run_smoke(str(cwd))
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout
