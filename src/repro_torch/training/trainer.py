"""The LLM trainer on one device.  Counterpart of `repro.training.trainer`
with `mesh=None`.

A step takes the loss and its gradients (`models.model.loss_fn`, with
optional microbatches accumulated in fp32), clips them by their global
norm, and applies the optimizer (`optim`), in the JAX package's order.
State and parameters are nested dicts of tensors in its layout:
{"params", "opt": {"mu", "nu", "step"}, "step"}, plus an fp32 "mailbox"
for `sync_mode="rma_arar_grouped"`.

Sync modes: without a mesh the JAX package runs every mode as the
all-reduce step (the hierarchical modes need a multi-pod mesh), and so
does the port; a mesh raises (the multi-device backend is ROADMAP.md
queue A item 6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..models.model import leaves, map_params
from ..optim import adam, adamw, apply_updates, clip_by_global_norm, sgd
from ..optim.schedules import linear_warmup_cosine

HIERARCHICAL_MODES = ("arar_grouped", "rma_arar_grouped", "ensemble")
SYNC_MODES = ("allreduce",) + HIERARCHICAL_MODES


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    optimizer: str = "adamw"
    microbatches: int = 1
    sync_mode: str = "allreduce"
    sync_h: int = 100               # outer-group period (paper Tab. I)
    sync_combine: str = "mean"


def _make_optimizer(tcfg: TrainConfig):
    sched = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    if tcfg.optimizer == "adamw":
        return adamw(sched, weight_decay=tcfg.weight_decay)
    if tcfg.optimizer == "adam":
        return adam(sched)
    return sgd(sched, momentum=0.9)


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the port trains on one device (mesh=None); the multi-device "
            "backend and the hierarchical sync modes across it are "
            "ROADMAP.md queue A item 6")


# ----------------------------------------------------------------------------
# state


def init_train_state(gen, cfg: ModelConfig, tcfg: TrainConfig, device=None):
    """Random parameters drawn from the torch.Generator `gen`, and a zero
    optimizer state, on `device` (CUDA by default)."""
    return train_state_from_params(model_lib.init(gen, cfg, device), tcfg)


def train_state_from_params(params, tcfg: TrainConfig):
    """A step-0 train state around `params` (a zero optimizer state, and
    the fp32 mailbox of `rma_arar_grouped`): how a state made elsewhere,
    such as the JAX package's parameters, starts training here."""
    state = {"params": params, "opt": _make_optimizer(tcfg).init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=next(leaves(params)).device)}
    if tcfg.sync_mode == "rma_arar_grouped":
        state["mailbox"] = map_params(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


# ----------------------------------------------------------------------------
# gradients and the update


def _value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads) with grads in the params' layout and dtypes."""
    ps = map_params(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model_lib.loss_fn(ps, batch, cfg)
    got = iter(torch.autograd.grad(loss, list(leaves(ps))))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_params(lambda _: next(got), ps))


def _compute_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """Value and gradients, with optional microbatch accumulation: the
    gradients of M microbatches summed in fp32 (each over M), then cast to
    the parameters' dtype; the metrics of the last microbatch."""
    M = tcfg.microbatches
    if M <= 1:
        return _value_and_grad(params, batch, cfg)
    parts = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
             for k, v in batch.items()}
    loss = torch.zeros((), dtype=torch.float32,
                       device=next(leaves(params)).device)
    acc = map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(M):
        l_i, metrics, grads = _value_and_grad(
            params, {k: v[i] for k, v in parts.items()}, cfg)
        flat = iter(list(leaves(grads)))
        acc = map_params(lambda a: a + next(flat).float() / M, acc)
        loss = loss + l_i / M
    flat = iter(list(leaves(params)))
    return loss, metrics, map_params(lambda g: g.to(next(flat).dtype), acc)


def _apply(state, grads, tcfg: TrainConfig, extra=None):
    if tcfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=state["step"].device)
    opt = _make_optimizer(tcfg)
    updates, opt_state = opt.update(grads, state["opt"], state["params"])
    params = apply_updates(state["params"], updates)
    new_state = dict(state, params=params, opt=opt_state,
                     step=state["step"] + 1)
    if extra:
        new_state.update(extra)
    return new_state, gnorm


def _step_allreduce(state, batch, cfg: ModelConfig, tcfg: TrainConfig):
    loss, metrics, grads = _compute_grads(state["params"], batch, cfg, tcfg)
    new_state, gnorm = _apply(state, grads, tcfg)
    return new_state, dict(metrics, loss=loss, gnorm=gnorm)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    donate: bool = True):
    """The train step (state, batch) -> (new state, metrics), and None for
    the shardings.  The step builds a new state and never writes into the
    one it is given, so `donate` (the JAX package's buffer donation) has
    nothing to free early; the caller drops the old state."""
    _check_mesh(mesh)

    def step(state, batch):
        return _step_allreduce(state, batch, cfg, tcfg)
    return step, None


class Trainer:
    """The training loop of the examples: a state made from `seed` on
    `device` (CUDA by default), stepped over a batch stream."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                 mesh=None, device=None):
        _check_mesh(mesh)
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_train_state(gen, cfg, tcfg, self.device)
        self.step_fn, _ = make_train_step(cfg, tcfg)

    def run(self, stream, steps: int, log_every: int = 10, log=print,
            on_step: Optional[Callable] = None):
        """`steps` steps over `stream`; logs the loss every `log_every`
        steps (reading it back), and calls `on_step(i, metrics)` after
        each step if given.  Returns the state."""
        t0 = time.time()
        for i, batch in zip(range(steps), stream):
            self.state, metrics = self.step_fn(self.state, batch)
            if on_step is not None:
                on_step(i, metrics)
            if i % log_every == 0 or i == steps - 1:
                log(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                    f"ce {float(metrics['ce']):.4f} "
                    f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        return self.state
