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

A payload is serialized once: its leaves' bytes, in `jax.tree.leaves`
order (`core.tree`), are joined on their device and leave it in one
`.cpu()` (a synchronizing copy), so the wire format is the JAX package's
and a tuple of ring segments costs one D2H copy, not one a segment;
bytes that arrive are copied out of the mmap snapshot and go to the
device in one copy, never aliased.  A bf16 leaf (the payload of
`SyncConfig(payload_precision="bf16")`) crosses as its raw bits, never
widened or re-rounded, and a window is sized from the bytes it carries:
2 a scalar at bf16 (`mailbox.payload_nbytes`).

Chunked windows (`window_bytes`, `SyncConfig.ring_chunking`, the JAX
package's lines 89–99 and 138–185): 0 keeps one window a channel; > 0
splits every serialized payload into ceil(bytes / window_bytes) mmap
windows, each its own mailbox `{channel}w{i}` (the bare channel name
when there is one window, so unchunked runs keep their file layout).
Every window is written before any is read, lock-step runs rendezvous
window by window, and a free-running read that meets a window with no
deposit yet returns the warmup value.

Rank layout matches `VmapComm`: global rank = outer * n_inner + inner
(row-major), ring direction per Algorithm 1 (rank i receives from i-1).
`recv_hypercube` (the dbtree mode) is unsupported, as in the JAX package:
a log2(R)-stage barrier tree has no free-running reading.

The adaptive schedule's deposit is one tree, {"w": payload or its
segments, "tag": int32 [1] producer epoch}, so it crosses `_transfer`
as one serialized payload (the tag's 4 bytes first, in `jax.tree.leaves`
order), windowed as `window_bytes` says: a tag always arrives with the
payload it describes, and a free-running read before the first deposit
is zeros with a -1 tag.  Its skew crosses `pmean_all`'s board as one
fp32 [1].

The overlap schedule's ship (`ship_outer`, the JAX package's lines
205–221) crosses a channel of its own, "ship" (`mbx_*_ship.bin`, or
`mbx_*_shipw<i>.bin` in windows), so its call count, one a ship epoch,
never pairs with the outer ring's.  `cond_ship` branches in Python: an
off-epoch moves no bytes and, in lock-step, every rank skips the same
epochs, so the channels' call counters stay matched.
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


def tree_to_bytes(tree) -> bytes:
    """Concatenate the leaves (`jax.tree.leaves` order) as raw
    little-endian bytes — the wire format of every mailbox payload.  The
    leaves are joined where they lie and cross to the host in one copy."""
    parts = [leaf.detach().contiguous().reshape(-1).view(torch.uint8)
             for leaf in tree_leaves(tree)]
    if not parts:
        return b""
    flat = parts[0] if len(parts) == 1 else torch.cat(
        [p.to(parts[0].device) for p in parts])
    return flat.cpu().numpy().tobytes()


def bytes_to_tree(buf: bytes, like):
    """Inverse of `tree_to_bytes` against `like`'s structure, shapes,
    dtypes and devices.  The bytes are copied out of `buf`, and reach the
    first leaf's device in one copy."""
    leaves = tree_leaves(like)
    nbytes = [leaf.numel() * leaf.element_size() for leaf in leaves]
    if sum(nbytes) != len(buf):
        raise ValueError(f"payload of {len(buf)} bytes for a tree of "
                         f"{sum(nbytes)}")
    if not leaves:
        return tree_unflatten(like, [])
    raw = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy()).to(
        leaves[0].device)
    out, off = [], 0
    for leaf, n in zip(leaves, nbytes):
        part = raw[off:off + n].to(leaf.device)
        if off % leaf.element_size():     # a view needs an aligned start
            part = part.clone()
        out.append(part.view(leaf.dtype).reshape(leaf.shape))
        off += n
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
                 lockstep: bool = True, timeout: float = DEFAULT_TIMEOUT_S,
                 window_bytes: int = 0):
        self.n_outer, self.n_inner = n_outer, n_inner
        self.rank, self.run_dir = rank, run_dir
        self.lockstep, self.timeout = lockstep, timeout
        self.window_bytes = int(window_bytes)   # 0: one window a channel
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
        if channel in ("outer", "ship"):
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

    def _windows(self, nbytes: int):
        """Half-open byte spans of one payload's windows: one span when
        `window_bytes` is 0 or at least the payload, else the chunks."""
        w = self.window_bytes
        if w <= 0 or w >= nbytes:
            return [(0, nbytes)]
        return [(a, min(a + w, nbytes)) for a in range(0, nbytes, w)]

    def _transfer(self, channel: str, tree):
        """Deposit `tree` toward my successor, return the predecessor's
        deposit (lock-step: the matching entry; free-run: the latest).
        Every window is written before any is read; a free-running read
        may take windows of adjacent deposits, each consistent."""
        succ, pred = self._peers(channel)
        payload = tree_to_bytes(tree)
        spans = self._windows(len(payload))
        names = [channel] if len(spans) == 1 else \
            [f"{channel}w{i}" for i in range(len(spans))]
        with _span(f"exchange.{channel}", cat="wire", epoch=self._epoch,
                   bytes=len(payload), windows=len(spans)):
            for ch, (a, b) in zip(names, spans):
                out = self._out.get(ch)
                if out is None:
                    out = self._out[ch] = Mailbox.for_writer(
                        self._mbx_path(self.rank, succ, ch), b - a,
                        self.timeout)
                out.write(payload[a:b], self._epoch, self.lockstep)
            parts = []
            for ch, (a, b) in zip(names, spans):
                inc = self._in.get(ch)
                if inc is None:
                    inc = self._in[ch] = Mailbox.for_reader(
                        self._mbx_path(pred, self.rank, ch), b - a,
                        self.timeout)
                got = inc.read(self.lockstep)
                if got is None:        # free-run, producer not started yet
                    return warmup_like(tree)
                parts.append(got[0])
            return bytes_to_tree(b"".join(parts), tree)

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

    def ship_outer(self, tree):
        if self.n_outer == 1:
            return tree
        return self._transfer("ship", tree)

    def cond_ship(self, ship_due, tree, fallback):
        """A Python branch, not a select: an off-epoch moves no bytes.
        `ship_due` is read back to the host (one scalar; the exchange
        copies its payload to the host anyway).  The adaptive schedule's
        stretched gate (k_eff and `shipped_for`) reaches it the same way,
        as the `ship_due` of `_sync_core`.  In lock-step the predicate is
        the same on every rank, so the ship channel's call counters stay
        paired."""
        if bool(ship_due):
            return self.ship_outer(tree)
        return fallback

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
