"""`ProcComm` — the `Comm` surface over real cross-process mailboxes, the
counterpart of `repro.runtime.proccomm`.

Each worker process of `runtime/launch.py` owns one `ProcComm` and runs
the unchanged schedule layer (`core.sync`) against it: every
`recv_ring_*` / `pmean_all` call moves bytes through the mmap windows of
`runtime/mailbox.py` instead of rolling a stacked axis.

The port's `Comm` surface is stacked-first (`core.ring`): `VmapComm`
trees carry a leading [R] axis.  A `ProcComm` presents its one rank the
same way, with a leading [1]: `inner_index` is a [1] tensor holding the
rank's inner index, `mask_where` takes a [1] predicate, and `pmean_all`
stacks the R ranks' values in rank order and takes `.mean(0,
keepdim=True)`, the op `VmapComm.pmean_all` runs.  So `sync_gradients`,
`StaticSchedule` and `FusionSpec.flatten(stacked=True)` run over it
unchanged, and a lock-step run is bitwise the stacked engine's.

Two modes, fixed per run:

  lock-step (`lockstep=True`, the default) — every transfer is matched to
      its peer by a per-channel call counter and rendezvoused, so the run
      re-executes the stacked engine's pairing exactly: a zero-jitter
      lock-step run is BITWISE the per-rank computation exchanged through
      `VmapComm` (`tests/test_torch_runtime.py`, `chip_smoke.py` phase
      34).
  free-running (`lockstep=False`) — deposits overwrite one-sided windows
      and reads take the latest consistent snapshot without ever blocking
      on the producer: ranks drift apart.  A read before the first deposit
      returns the warmup value (zeros for float leaves, -1 for integer
      leaves — the mailbox tag convention).

Bytes leave the device through `.cpu()` (a synchronizing copy) in
`jax.tree.leaves` order (`core.tree`), so the wire format is the JAX
package's; bytes that arrive are copied out of the mmap snapshot before
`torch.from_numpy(...).to(device)`, never aliased.

Rank layout matches `VmapComm`: global rank = outer * n_inner + inner
(row-major), ring direction per Algorithm 1 (rank i receives from i-1).
`recv_hypercube` (the dbtree mode) is unsupported, as in the JAX package:
a log2(R)-stage barrier tree has no free-running reading.  The overlap
ship (`ship_outer`) and the chunked windows (`window_bytes`) come with
their schedules, ROADMAP.md queue A item 3.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.ring import Comm
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..obs.trace import span as _span
from .mailbox import Board, Mailbox

DEFAULT_TIMEOUT_S = 180.0


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf crosses the wire as: bf16 as its int16 bits
    (numpy has no bf16), every other dtype as itself."""
    return torch.int16 if dtype == torch.bfloat16 else dtype


def tree_to_bytes(tree) -> bytes:
    """Concatenate the leaves (`jax.tree.leaves` order) as raw
    little-endian bytes — the wire format of every mailbox payload."""
    return b"".join(
        leaf.detach().cpu().contiguous().view(_wire_dtype(leaf.dtype))
        .numpy().tobytes() for leaf in tree_leaves(tree))


def bytes_to_tree(buf: bytes, like):
    """Inverse of `tree_to_bytes` against `like`'s structure, shapes,
    dtypes and devices.  Each leaf is copied out of `buf` first."""
    out, off = [], 0
    for leaf in tree_leaves(like):
        wire = _wire_dtype(leaf.dtype)
        np_dtype = torch.empty(0, dtype=wire).numpy().dtype
        arr = np.frombuffer(buf, dtype=np_dtype, count=leaf.numel(),
                            offset=off).copy()
        out.append(torch.from_numpy(arr).view(leaf.dtype)
                   .reshape(leaf.shape).to(leaf.device))
        off += arr.nbytes
    if off != len(buf):
        raise ValueError(f"payload of {len(buf)} bytes for a tree of {off}")
    return tree_unflatten(like, out)


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def warmup_like(like):
    """The never-deposited value: zeros for float leaves, -1 for integer
    leaves (the mailbox tag convention: a -1 tag marks a warmup read)."""
    return tree_map(lambda x: torch.full_like(x, -1) if _is_integer(x.dtype)
                    else torch.zeros_like(x), like)


class ProcComm(Comm):
    """One worker process's view of the ring; see the module docstring."""

    def __init__(self, n_outer: int, n_inner: int, rank: int, run_dir: str,
                 lockstep: bool = True, timeout: float = DEFAULT_TIMEOUT_S):
        self.n_outer, self.n_inner = n_outer, n_inner
        self.rank, self.run_dir = rank, run_dir
        self.lockstep, self.timeout = lockstep, timeout
        self._epoch = 0
        self._out = {}                 # channel -> Mailbox (to successor)
        self._in = {}                  # channel -> Mailbox (from predecessor)
        self._board: Optional[Board] = None
        self._peer_boards = {}

    def close(self):
        """Unmap every window this rank opened."""
        for w in (*self._out.values(), *self._in.values(),
                  *self._peer_boards.values(),
                  *([self._board] if self._board is not None else [])):
            w.close()

    # -- ring neighbours (receive FROM predecessor, deposit TO successor) ----

    def _o(self):
        return self.rank // self.n_inner

    def _j(self):
        return self.rank % self.n_inner

    def _peers(self, channel: str):
        o, j, O, I = self._o(), self._j(), self.n_outer, self.n_inner
        if channel == "inner":
            return (o * I + (j + 1) % I,          # successor (my reader)
                    o * I + (j - 1) % I)          # predecessor (my writer)
        if channel == "outer":
            return (((o + 1) % O) * I + j,
                    ((o - 1) % O) * I + j)
        if channel == "all":
            R = self.n_ranks
            return ((self.rank + 1) % R, (self.rank - 1) % R)
        raise ValueError(channel)

    def _mbx_path(self, src: int, dst: int, channel: str) -> str:
        return os.path.join(self.run_dir, f"mbx_{src}to{dst}_{channel}.bin")

    # -- the transfer core ---------------------------------------------------

    def begin_epoch(self, epoch: int):
        """Stamp the local epoch onto subsequent deposits (the mailbox
        header's tag)."""
        self._epoch = int(epoch)

    def _transfer(self, channel: str, tree):
        """Deposit `tree` toward my successor, return the predecessor's
        deposit (lock-step: the matching entry; free-run: the latest)."""
        succ, pred = self._peers(channel)
        payload = tree_to_bytes(tree)
        with _span(f"exchange.{channel}", cat="wire", epoch=self._epoch,
                   bytes=len(payload)):
            out = self._out.get(channel)
            if out is None:
                out = self._out[channel] = Mailbox.for_writer(
                    self._mbx_path(self.rank, succ, channel), len(payload),
                    self.timeout)
            out.write(payload, self._epoch, self.lockstep)
            inc = self._in.get(channel)
            if inc is None:
                inc = self._in[channel] = Mailbox.for_reader(
                    self._mbx_path(pred, self.rank, channel), len(payload),
                    self.timeout)
            got = inc.read(self.lockstep)
            if got is None:            # free-run, producer not started yet
                return warmup_like(tree)
            return bytes_to_tree(got[0], tree)

    # -- Comm surface --------------------------------------------------------

    def recv_ring_all(self, tree):
        if self.n_ranks == 1:
            return tree
        return self._transfer("all", tree)

    def recv_ring_inner(self, tree):
        if self.n_inner == 1:          # size-1 group: identity, as VmapComm
            return tree
        return self._transfer("inner", tree)

    def recv_ring_outer(self, tree):
        if self.n_outer == 1:
            return tree
        return self._transfer("outer", tree)

    def pmean_all(self, tree):
        if self.n_ranks == 1:
            return tree
        with _span("exchange.pmean", cat="wire", epoch=self._epoch):
            return self._pmean_all(tree)

    def _pmean_all(self, tree):
        payload = tree_to_bytes(tree)
        if self._board is None:
            self._board = Board.for_writer(
                os.path.join(self.run_dir, f"board_{self.rank}.bin"),
                len(payload), self.n_ranks, self.timeout)
            self._readers = [r for r in range(self.n_ranks)
                             if r != self.rank]
        self._board.write(payload, self._readers, self.lockstep)
        vals = []
        for r in range(self.n_ranks):  # rank order: deterministic reduce
            if r == self.rank:
                vals.append(tree)
                continue
            b = self._peer_boards.get(r)
            if b is None:
                b = self._peer_boards[r] = Board.for_reader(
                    os.path.join(self.run_dir, f"board_{r}.bin"),
                    len(payload), self.n_ranks, self.timeout)
            got = b.read(self.rank, self.lockstep)
            if got is not None:        # free-run: a silent peer just drops
                vals.append(bytes_to_tree(got, tree))
        # VmapComm.pmean_all's op on the [R, ...] stack of the ranks' values
        return tree_map(lambda *xs: torch.cat(xs).mean(0, keepdim=True),
                        *vals)

    def recv_hypercube(self, tree, stage: int):
        raise NotImplementedError(
            "mode='dbtree' is a lock-step log2(R)-stage barrier tree and "
            "is not supported on the proc backend — use the stacked "
            "backend (VmapComm) for dbtree studies")

    def inner_index(self, device=None):
        return torch.full((1,), self._j(), dtype=torch.int64, device=device)
