"""repro_torch.runtime — the proc runtime: R real worker processes, the
counterpart of `repro.runtime`.

`core.workflow.train_stacked` simulates R ranks in one process (`VmapComm`
rolls a stacked axis), lock-step by construction.  This package runs the
paper's actual workflow: each rank a process of its own, on one host
(on one card, for a CUDA run), exchanging generator gradients through
one-sided windows, either lock-step (bitwise the stacked engine's pairing)
or free-running with reproducible injected jitter.

Modules:

    mailbox   mmap-backed cross-process one-sided windows, byte for byte
              the JAX package's files: a seqlock'd single-writer `Mailbox`
              per directed ring edge (lock-step rendezvous or free-running
              overwrite), a depth-2 `Board` per rank for the pmean
              bulletin, and a counter-file `Barrier`
    proccomm  `ProcComm` — the stacked-first `Comm` surface (a leading
              [1]) over real cross-process mailboxes
    jitter    `JitterConfig` — deterministic per-(seed, rank, epoch) sleep
              injection, so asynchrony is reproducible
    launch    the launcher (`run_proc`), its bitwise in-process twin
              (`lockstep_reference`) and the worker entry point
              (`python -m repro_torch.runtime.launch --worker`)

`core.workflow.train_proc` and `python -m repro_torch.launch.train_gan
--backend proc` drive it.  Exports resolve lazily (PEP 562), so importing
the package loads neither torch's solver stack nor the launcher.
"""
__all__ = ["JitterConfig", "ProcComm", "run_proc"]


def __getattr__(name):
    if name == "JitterConfig":
        from .jitter import JitterConfig
        return JitterConfig
    if name == "ProcComm":
        from .proccomm import ProcComm
        return ProcComm
    if name == "run_proc":
        from .launch import run_proc
        return run_proc
    raise AttributeError(name)
