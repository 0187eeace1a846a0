"""Mixture-of-Experts MLP with shared and routed experts.  Counterpart of
`repro.models.moe`.

The router is fp32 whatever the model's dtype; each token goes to its
top-k experts with their softmax probabilities renormalised over the k.
Dispatch is sort-based, as in the JAX package: the (token, expert)
assignments are stably sorted by expert, and each expert's first C
(`moe_capacity`) fill its buffer of C rows; the rest are dropped.  The
experts' SwiGLU runs as batched matmuls over [E, C, D] buffers, so the
work is the activated experts', padded to C rows each.  These are
`torch.bmm`, as they are einsums outside any Pallas kernel in the JAX
package.

Two places differ in form from the JAX package, not in result:

- Dropped assignments.  JAX writes them to row e·C + T·K with
  `mode="drop"`, which lies inside the buffer when e·C + T·K < E·C, on a
  later expert's row; its CPU scatter applies updates in order, so the
  later expert's own entry overwrites it.  CUDA promises no order for
  duplicate indices, so here every dropped assignment goes to one spare
  row, E·C, that no matmul reads: no row that is read is written twice.
- The combine.  JAX adds each token's k weighted rows into y with a
  scatter-add in x's dtype, in ascending expert id.  An atomic add on
  CUDA would sum them in any order, so here the rows are gathered back to
  [T, k], each token's k put in ascending expert id, and summed one after
  another in x's dtype.  The result does not depend on the run.

A caller that wants to see the routing hands `run_moe` a `Tap`, through
the model's entry points as `tap=`: it counts the dropped assignments,
and can record or pin the top-k choices.  Without one, `run_moe` does
nothing beyond its result.  The dispatch, the experts and the combine run
under the profiler ranges "moe.dispatch", "moe.experts" and
"moe.combine", which attribute their kernels in a trace.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .config import ModelConfig
from .layers import init_mlp, kaiming, run_mlp


class Tap:
    """A caller's view of `run_moe`'s routing, handed down as `tap=` by
    `models.model` (`forward`, `loss_fn`, `prefill`, `decode_step`),
    `serving.generate` and `training.Trainer`.  Every call it is handed
    adds its (token, expert) assignments dropped for capacity to
    `dropped` (the remat recompute of a layer is a call of its own; the
    sum stays a 0-d tensor on the calls' device until read, so the model
    path never waits for the card).  With `record`, each call appends
    (its router's probabilities, the expert ids it takes), both on the
    CPU, to `routes`.  With `choices`, expert ids [T, k] in the calls'
    order (another run's `routes`), each call takes them instead of its
    own top-k, the gate read from its own probabilities."""

    def __init__(self, record: bool = False, choices=None):
        self.calls = 0
        self._dropped = None
        self.routes = [] if record else None
        self._pinned = None if choices is None else iter(choices)

    def route(self, probs, gate, idx):
        """A call's top-k (gate, idx) [T, k] -> the (gate, idx) it takes."""
        if self._pinned is not None:
            idx = next(self._pinned).to(probs.device)
            gate = torch.gather(probs, -1, idx)
        if self.routes is not None:
            self.routes.append((probs.detach().cpu(), idx.cpu()))
        return gate, idx

    def drop(self, n):
        """n: a call's dropped assignments, a 0-d count."""
        self.calls += 1
        self._dropped = n if self._dropped is None else self._dropped + n

    @property
    def dropped(self) -> int:
        return 0 if self._dropped is None else int(self._dropped)


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows of each expert's buffer: tokens·k·capacity_factor / E + 1,
    rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def init_moe(gen, cfg: ModelConfig, dtype, device=None):
    """The JAX layout: router [D, E] in fp32, we1/we3 [E, D, F] and we2
    [E, F, D] in `dtype`, and with shared experts a dense SwiGLU MLP of
    width num_shared_experts · moe_d_ff under "shared"."""
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": kaiming(gen, (D, E), torch.float32, device=device),
         "we1": kaiming(gen, (E, D, Fd), dtype, fan_in=D, device=device),
         "we3": kaiming(gen, (E, D, Fd), dtype, fan_in=D, device=device),
         "we2": kaiming(gen, (E, Fd, D), dtype, fan_in=Fd, device=device)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, D, cfg.num_shared_experts * Fd, dtype,
                               p["we1"].device)
    return p


def _router(p, xf, k: int, tap=None):
    """fp32 logits (float64 with a float64 router), softmax, top-k (as
    `tap` has it) and the gate renormalised over the k: (probs [T, E],
    gate [T, k], idx [T, k])."""
    dt = torch.promote_types(torch.float32, p["router"].dtype)
    probs = torch.softmax(torch.matmul(xf.to(dt), p["router"].to(dt)),
                          dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if tap is not None:
        gate, idx = tap.route(probs, gate, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def dispatch(e_flat, E: int, C: int):
    """Capacity dispatch of the assignments' experts e_flat [N]: (order,
    slot, keep), each [N] in expert-sorted order.  `order` is the stable
    sort of e_flat; an assignment is kept when it is among its expert's
    first C, and goes to buffer row e·C + its rank; every dropped one goes
    to the spare row E·C."""
    dev = e_flat.device
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos = torch.arange(e_flat.numel(), device=dev) - starts[e_sorted]
    keep = pos < C
    return order, torch.where(keep, e_sorted * C + pos, E * C), keep


def run_moe(p, x, cfg: ModelConfig, tap: Optional[Tap] = None):
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux_loss fp32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    probs, gate, idx = _router(p, xf, K, tap)

    # ---- capacity dispatch (sort-based) ------------------------------------
    C = moe_capacity(T, cfg)
    e_flat = idx.reshape(T * K)
    with record_function("moe.dispatch"):
        order, slot, keep = dispatch(e_flat, E, C)
        if tap is not None:
            tap.drop((~keep).sum())
        tok = order // K                                 # source token
        buf = xf.new_zeros((E * C + 1, D)).index_put((slot,), xf[tok])
        buf = buf[:E * C].reshape(E, C, D)

    # ---- expert computation (activated rows only) --------------------------
    with record_function("moe.experts"):
        h = F.silu(torch.bmm(buf, p["we1"])) * torch.bmm(buf, p["we3"])
        out = torch.bmm(h, p["we2"]).reshape(E * C, D)

    # ---- combine: each token's k rows in ascending expert id, in x's dtype -
    with record_function("moe.combine"):
        w = gate.reshape(T * K)[order] * keep
        rows = (out[torch.clamp(slot, max=E * C - 1)] * w[:, None]).to(
            x.dtype)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * K, device=x.device)   # (t, k) -> row
        by_expert = torch.sort(idx, dim=-1).indices
        rows = rows[inv.reshape(T, K).gather(1, by_expert)]  # [T, K, D]
        y = rows[:, 0]
        for j in range(1, K):
            y = y + rows[:, j]

    if cfg.num_shared_experts:
        y = y + run_mlp(p["shared"], x).reshape(T, D)

    # ---- load-balance auxiliary loss (Switch-style) ------------------------
    frac = torch.bincount(e_flat, minlength=E).float() / (T * K)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return y.reshape(B, S, D), aux


def run_moe_reference(p, x, cfg: ModelConfig):
    """Oracle: every token through its top-k experts, no capacity drops,
    accumulated in fp32.  For tests at small shapes."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    _, gate, idx = _router(p, xf, cfg.top_k)
    acc = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for k in range(cfg.top_k):
        e = idx[:, k]
        h = F.silu(torch.einsum("td,tdf->tf", xf, p["we1"][e])) \
            * torch.einsum("td,tdf->tf", xf, p["we3"][e])
        acc = acc + gate[:, k:k + 1] * torch.einsum(
            "tf,tfd->td", h, p["we2"][e]).float()
    y = acc.to(x.dtype)
    if cfg.num_shared_experts:
        y = y + run_mlp(p["shared"], x).reshape(T, D)
    return y.reshape(B, S, D)
