"""Communication backend of the gradient exchange — counterpart of
`repro.core.ring` (`Comm` and `VmapComm`, lines 55–175).

Every backend of the port is stacked-first: the trees it exchanges carry
a leading rank axis.  `VmapComm` simulates R = n_outer · n_inner ranks on
one device: the axis is [R], ordered (outer, inner) row-major, and a ring
transfer is a `torch.roll` along it.  `runtime.proccomm.ProcComm` is one
rank of R worker processes: the axis is [1], and a ring transfer crosses
an mmap mailbox.  Ring direction follows Algorithm 1: rank i receives
from its predecessor i − 1.

The overlap schedule's ship (`ship_outer`, `cond_ship`; the JAX
package's lines 73–93 and 148–153) moves a payload one hop along the
outer ring, like `recv_ring_outer`, but its result is read one epoch
later, from the outer mailbox.  On `VmapComm` the gate is a
`torch.where` between the rolled tree and the old mailbox, made on the
device: bitwise JAX's `lax.cond`, which selects between the same two
values, and the epoch reads nothing back.  `ProcComm` branches in
Python instead, so an off-epoch moves no bytes.

Deposit tags (`make_deposit_tag`, the JAX package's lines 39–52): the
adaptive schedule (`core.sync.AdaptiveSchedule`) stamps every RMA
mailbox deposit with the producer's epoch counter.  The tag rides the
same `recv_ring_inner` transfer as the payload, one tree holding both,
so the reader's `epoch - tag` is the deposit's true age: 0 skew on
`VmapComm`, where every rank deposits at the same epoch, and the
measured skew of free-running `ProcComm` workers.

The mesh backend (`ShardComm`, ranks on several cards) is ROADMAP.md
queue A item 6.
"""
from __future__ import annotations

import dataclasses

import torch

from .tree import tree_map


def make_deposit_tag(epoch, n_lead: int):
    """The int32 epoch tag [n_lead] deposited beside a ring payload: the
    device epoch counter `epoch` (a 0-d tensor) expanded on its device,
    nothing read back.  The port's backends are stacked-first, so
    `n_lead` is the leading axis: n_ranks on `VmapComm`, 1 for a
    `ProcComm` worker (the JAX package's per-rank scalar)."""
    e = torch.as_tensor(epoch)
    return e.to(torch.int32).reshape(1).expand(n_lead)


class Comm:
    n_outer: int
    n_inner: int

    @property
    def n_ranks(self):
        return self.n_outer * self.n_inner

    def recv_ring_all(self, tree):
        """Value from the global ring predecessor (flattened outer x inner)."""
        raise NotImplementedError

    def recv_ring_inner(self, tree):
        raise NotImplementedError

    def recv_ring_outer(self, tree):
        raise NotImplementedError

    def ship_outer(self, tree):
        """The overlap schedule's pod-boundary hop: `tree` one step along
        the outer ring, as `recv_ring_outer`, read one epoch later
        (`sync._outer_exchange_overlapped`)."""
        raise NotImplementedError

    def cond_ship(self, ship_due, tree, fallback):
        """`ship_outer(tree)` where `ship_due` holds, else `fallback`.
        `ship_due` is a bool tensor, the same on every rank; the select
        is made on the device, so nothing is read back."""
        shipped = self.ship_outer(tree)
        return tree_map(lambda s, f: torch.where(ship_due, s, f), shipped,
                        fallback)

    def pmean_all(self, tree):
        raise NotImplementedError

    def recv_hypercube(self, tree, stage: int):
        """Value from XOR partner rank ^ 2^stage (the dbtree mode's
        recursive-doubling hop)."""
        raise NotImplementedError

    def inner_index(self, device=None):
        """Inner-group index of each rank on the leading axis."""
        raise NotImplementedError

    def mask_where(self, cond_per_rank, a, b):
        """Select a where cond (per-rank bool on the leading axis) else b,
        leafwise."""
        return tree_map(lambda x, y: torch.where(
            cond_per_rank.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


@dataclasses.dataclass
class VmapComm(Comm):
    """Simulated ranks: trees have a leading [n_outer * n_inner] axis."""
    n_outer: int
    n_inner: int

    def recv_ring_all(self, tree):
        # incoming[i] = g[i-1]
        return tree_map(lambda x: torch.roll(x, 1, 0), tree)

    def _roll_grouped(self, tree, dim):
        O, I = self.n_outer, self.n_inner

        def f(x):
            y = torch.roll(x.reshape((O, I) + x.shape[1:]), 1, dim)
            return y.reshape(x.shape)
        return tree_map(f, tree)

    def recv_ring_inner(self, tree):
        return self._roll_grouped(tree, 1)

    def recv_ring_outer(self, tree):
        return self._roll_grouped(tree, 0)

    def ship_outer(self, tree):
        # the ranks share one device: the ship is the outer ring's roll;
        # the overlap lies in reading it one epoch later
        return self.recv_ring_outer(tree)

    def pmean_all(self, tree):
        return tree_map(lambda x: x.mean(0, keepdim=True).expand_as(x), tree)

    def recv_hypercube(self, tree, stage: int):
        """Value from partner rank ^ 2^stage."""
        def f(x):
            idx = torch.arange(self.n_ranks, device=x.device) ^ (1 << stage)
            return x[idx]
        return tree_map(f, tree)

    def inner_index(self, device=None):
        return torch.arange(self.n_inner, device=device).repeat(self.n_outer)
