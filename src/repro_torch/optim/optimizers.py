"""Optimizers written out, counterparts of `repro.optim.optimizers`.

Each optimizer is a pair of functions over nested dicts and lists of
tensors:
    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, opt_state)
`updates` are deltas to add to the parameters (sign included), applied by
`apply_updates`.  Moments are fp32 whatever the parameters' dtype.  The
operations run in the JAX package's order (its lines 50-63): the step is
counted before lr_t is read, the delta is −lr·m̂/(√v̂ + eps) cast to the
gradient's dtype, then p + u in fp32 cast to p's dtype.  `torch.optim`
orders them otherwise, so it is not used.

The step counter is a 0-d int32 tensor on the parameters' device and every
scalar is a tensor there, so an update reads nothing back to the host.
A state of R stacked ranks (the GAN trainer's, as `jax.vmap` stacks it)
carries an [R] step instead: the bias corrections and a scheduled lr_t
are then [R] and broadcast over each leaf's leading rank axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..core.tree import tree_map
from ..models.model import leaves, map_params

Schedule = Union[float, Callable]


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)


def _lead(x, like):
    """x (0-d, or [R] per rank) shaped to broadcast over `like`'s leading
    axes."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_scale(tree, max_norm):
    """(min(1, max_norm / norm), norm): the factor `clip_by_global_norm`
    scales every leaf by."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by min(1, max_norm / norm), norm)."""
    scale, norm = clip_scale(tree, max_norm)
    return map_params(lambda x: (x.float() * scale).to(x.dtype), tree), norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=next(leaves(params)).device)


def adam(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        return {"mu": map_params(_zeros32, params),
                "nu": map_params(_zeros32, params), "step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        s = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=s.device) ** s
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=s.device) ** s
        upd = tree_map(
            lambda m, v, g: (-(_lead(lr_t, m) * (m / _lead(bc1, m))
                               / (torch.sqrt(v / _lead(bc2, v)) + eps))
                             ).to(g.dtype), mu, nu, grads)
        return upd, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        upd, state = base.update(grads, state, params)
        if weight_decay:
            lr_t = _lr_at(lr, state["step"])
            upd = tree_map(
                lambda u, p: u - (lr_t * weight_decay * p.float()).to(u.dtype),
                upd, params)
        return upd, state

    return Optimizer(base.init, update)


def sgd(lr: Schedule, momentum: float = 0.0):
    def init(params):
        st = {"step": _step0(params)}
        if momentum:
            st["mom"] = map_params(_zeros32, params)
        return st

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state["mom"], grads)
            upd = tree_map(lambda m, g: (-lr_t * m).to(g.dtype), mom, grads)
            return upd, {"step": step, "mom": mom}
        upd = map_params(lambda g: (-lr_t * g.float()).to(g.dtype), grads)
        return upd, {"step": step}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
