"""SAGIPS in PyTorch and CUDA — the port of `repro` to an NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors its module
names where that helps a reader find the counterpart, and imports nothing
from it (nor JAX).  Plain tensor code is PyTorch; every Pallas kernel of a
ported path is a hand-written CUDA kernel under `kernels/csrc/`.

Ported so far: every problem of the JAX registry (`problems`: proxy1d,
proxy2d, linear_blur, imaging, imaging_blur), served by the solve service
(`serving.SolveService`, `python -m repro_torch.launch.serve`) and
trained by the paper's GAN loop (`core.workflow.train_stacked`, `python
-m repro_torch.launch.train_gan`), R ranks stacked on one device; the
inverse-CDF event sampler, the inpainting mask and the 3-tap blur are
CUDA kernels on both paths, and the imaging problems train and serve the
conv generator (`models.convgen`).  Also LLM serving of the dense
decoders (`serving.generate`, `python -m repro_torch.launch.serve_llm`,
tinyllama-1.1b by default) with flash attention as a CUDA kernel in
prefill, and of mamba2-130m; and LLM training on one device
(`training.Trainer`, `python -m repro_torch.launch.train`, mamba2-130m
with the SSD chunked scan as a CUDA kernel).  Every kernel wrapper is a
`torch.autograd.Function` with the JAX package's backward.

Device policy: entry points take `device=`; with none they run on CUDA and
raise when CUDA is absent (`resolve_device`).  They never fall back to the
CPU on their own.  The CPU runs only when asked for, which is how the tests
run here; a kernel wrapper then takes its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when None.

    Raises `RuntimeError` when CUDA is asked for (or defaulted to) and
    `torch.cuda.is_available()` is False; pass `device="cpu"` to run the
    plain PyTorch path on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False on this host; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
