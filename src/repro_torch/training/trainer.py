"""The LLM trainer on one device.  Counterpart of `repro.training.trainer`
with `mesh=None`.

A step takes the loss and its gradients (`models.model.loss_fn`, with
optional microbatches accumulated in fp32), clips them by their global
norm, and applies the optimizer (`optim`), in the JAX package's order.
State and parameters are nested dicts of tensors in its layout:
{"params", "opt": {"mu", "nu", "step"}, "step"}, plus an fp32 "mailbox"
for `sync_mode="rma_arar_grouped"`.

The update runs leaf by leaf (`_apply`): each parameter with its
gradient and moments goes through the optimizer on its own, which does
the elementwise operations of the whole-tree update, so the results are
bitwise the same, with one leaf's temporaries at a time.  Donation: the
JAX step donates its state, so XLA writes the new state over the old.
The port's donating step (`make_train_step(..., donate=True)`, the
`Trainer`'s) puts each new leaf in the place of the old one in the state
it is given, which releases the old leaf; the peak then holds the state,
the gradients and one leaf's temporaries.  A step that built the whole
new state beside the old would not fit granite-moe-3b-a800m on an 80 GB
card (its bf16 parameters and gradients and fp32 moments are ~40 GB).

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
from ..optim import adam, adamw, apply_updates, clip_scale, sgd
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


def _value_and_grad(params, batch, cfg: ModelConfig, tap=None):
    """(loss, metrics, grads) with grads in the params' layout and dtypes."""
    ps = map_params(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model_lib.loss_fn(ps, batch, cfg, tap)
    got = iter(torch.autograd.grad(loss, list(leaves(ps))))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_params(lambda _: next(got), ps))


def _compute_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig,
                   tap=None):
    """Value and gradients, with optional microbatch accumulation: the
    gradients of M microbatches summed in fp32 (each over M), then cast to
    the parameters' dtype; the metrics of the last microbatch."""
    M = tcfg.microbatches
    if M <= 1:
        return _value_and_grad(params, batch, cfg, tap)
    parts = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
             for k, v in batch.items()}
    loss = torch.zeros((), dtype=torch.float32,
                       device=next(leaves(params)).device)
    acc = map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(M):
        l_i, metrics, grads = _value_and_grad(
            params, {k: v[i] for k, v in parts.items()}, cfg, tap)
        flat = iter(list(leaves(grads)))
        acc = map_params(lambda a: a + next(flat).float() / M, acc)
        loss = loss + l_i / M
    flat = iter(list(leaves(params)))
    return loss, metrics, map_params(lambda g: g.to(next(flat).dtype), acc)


def _slots(tree):
    """(container, key) of every leaf of nested dicts and lists, in the
    order of `models.model.leaves`."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from _slots(v)
        else:
            yield tree, k


def _apply(state, grads, tcfg: TrainConfig, donate: bool = False):
    """Clip the gradients by their global norm and apply the optimizer,
    leaf by leaf: each parameter with its gradient and moments through the
    optimizer on that leaf alone, the new tensors taking the old ones'
    places.  With `donate` they take them in `state` itself (and `grads`
    is consumed), so each old leaf is released as its new one is made;
    without, in new containers, and `state` and `grads` are left as they
    were.  Returns (state, gnorm)."""
    if not donate:
        state, grads = (map_params(lambda t: t, x) for x in (state, grads))
    if tcfg.grad_clip:
        scale, gnorm = clip_scale(grads, tcfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=state["step"].device)
    opt = _make_optimizer(tcfg)
    opt_state = state["opt"]
    trees = [k for k in opt_state if k != "step"]   # the moments
    step = opt_state["step"]
    for (pt, pk), (gt, gk), *moments in zip(
            _slots(state["params"]), _slots(grads),
            *(_slots(opt_state[k]) for k in trees)):
        g, gt[gk] = gt[gk], None
        if tcfg.grad_clip:
            g = (g.float() * scale).to(g.dtype)
        one = {k: {"x": mt[mk]} for k, (mt, mk) in zip(trees, moments)}
        one["step"] = step
        upd, new = opt.update({"x": g}, one, {"x": pt[pk]})
        del g, one
        for k, (mt, mk) in zip(trees, moments):
            mt[mk] = new[k]["x"]
        pt[pk] = apply_updates({"x": pt[pk]}, upd)["x"]
        opt_state["step"] = new["step"]
    state["step"] = state["step"] + 1
    return state, gnorm


def _step_allreduce(state, batch, cfg: ModelConfig, tcfg: TrainConfig,
                    donate: bool = False, tap=None):
    loss, metrics, grads = _compute_grads(state["params"], batch, cfg, tcfg,
                                          tap)
    new_state, gnorm = _apply(state, grads, tcfg, donate)
    return new_state, dict(metrics, loss=loss, gnorm=gnorm)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    donate: bool = True, tap=None):
    """The train step (state, batch) -> (new state, metrics), and None for
    the shardings.  With `donate` (the JAX package's buffer donation) the
    step writes the new state into the dict it is given and returns that
    dict: the caller must not keep the old state.  Without, it builds a
    new state and leaves the one it is given as it was.  `tap`: a
    `models.moe.Tap` every MoE layer of every step reports to."""
    _check_mesh(mesh)

    def step(state, batch):
        return _step_allreduce(state, batch, cfg, tcfg, donate, tap)
    return step, None


class Trainer:
    """The training loop of the examples: a state made from `seed` on
    `device` (CUDA by default), stepped over a batch stream by the
    donating step (the state is updated in place)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                 mesh=None, device=None, tap=None):
        _check_mesh(mesh)
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_train_state(gen, cfg, tcfg, self.device)
        self.step_fn, _ = make_train_step(cfg, tcfg, tap=tap)

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
