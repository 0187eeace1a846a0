"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes` — seconds to
build, no PyTorch headers and no `ninja`.  Builds happen at first use,
never at import, into `build/repro_torch/` at the root of the checkout
(listed in `.gitignore`); a library is named by a hash of its source, of
every shared header `csrc/*.cuh` and of the flags, so an edited source or
header builds anew and an unchanged one is reused.  The tensor-core
sources reach the driver's `cuTensorMapEncodeTiled` through the runtime's
driver entry point, so no library links `libcuda` itself.

There is no fallback: without `nvcc`, or when it fails, `load` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# every kernel source under csrc/
SOURCES = ("inverse_cdf", "imaging", "flash_attention", "ssd_scan",
           "flash_attention_tc", "ssd_scan_tc")

# No --use_fast_math: the kernels hold fp32 tolerances (see the sources).
# -Xptxas -v prints registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # name -> wall seconds of its nvcc run


def nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, /usr/local/cuda/bin, or $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH); the CUDA kernels of repro_torch are built from "
            "source at first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Build every library in `names` that is missing, one `nvcc` each, all
    started together.  Returns name -> library path; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        # a private temporary name, renamed when done: a concurrent build
        # of the same source never sees a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc for csrc/{n}.cu exited {proc.returncode}:\n"
                          f"{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all((name,))[name]))
        return lib
