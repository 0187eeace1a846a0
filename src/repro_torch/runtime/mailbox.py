"""mmap-backed cross-process one-sided windows for the proc runtime — the
port's own copy of `repro.runtime.mailbox`, byte for byte the same files.

Three primitives, all single-writer, built on shared-file `mmap` (the N
worker processes live on one host — the launcher's contract):

  * `Mailbox` — one directed ring edge (writer rank -> reader rank).
    Two protocols over the same file:

      lock-step   rendezvous by entry sequence number: the writer may not
                  overwrite entry n-1 until the reader acknowledged it,
                  the reader blocks until entry n is published.  Every
                  rank executes the same comm-call sequence (the schedule
                  layer's control flow is SPMD-uniform), so matching
                  calls by a per-channel counter reproduces the stacked
                  backend's pairing exactly — this is the bitwise mode.
      free-run    a true one-sided window: the writer overwrites the slot
                  under a seqlock (odd = in progress) and NEVER waits;
                  the reader snapshots the latest consistent entry and
                  NEVER blocks on the producer — `read()` returns None
                  until the first deposit lands (the caller substitutes
                  its warmup value).  Deposit tags carry real measured
                  skew in this mode.

  * `Board` — one rank's bulletin slot for `pmean_all`: depth-2
    (seq-parity double buffer) so a reader one logical step behind still
    finds its entry, plus one ack cell per reader rank so the lock-step
    writer cannot lap a slow reader.

  * `Barrier` — a counter-file barrier (arrive_and_wait) for run
    start/end; file-based, so it needs no process group.

Consistency model: CPython executes the mmap stores in program order and
x86-TSO keeps them ordered across processes; the seqlock re-check on the
read side catches the (rare) torn snapshot and retries.  Every spin loop
carries a timeout so a crashed peer surfaces as `MailboxTimeout` instead
of a hung run.

Crash recovery: a writer that dies and re-attaches (checkpoint resume)
must continue the on-file sequence, never restart it — a restarted
counter would replay already-used seqlock values and an old snapshot's
re-check could accept a torn payload (the classic ABA).  `for_writer`
therefore resumes the entry counter from the published header, and
`Board` attach rounds a crashed-mid-publish slot's odd lock word up to
even so the seqlock can advance again.  The JAX package model-checks
both protocols (`repro.analysis`); the `set_hook` trace points below are
where a fault harness pauses real threads, kept for the port's analysis
lane (ROADMAP.md queue A item 7).

File layout (`Mailbox`): u64 write_seq | u64 read_ack | i64 tag |
u64 nbytes | payload; (`Board`): two slots of u64 seqlock | u64
logical_seq | i64 tag | payload, then one u64 ack per reader rank.
Files appear atomically (temp + rename), so existence implies full size.
Every header offset derives from the struct layouts below, as in the JAX
package, so a writer of either package and a reader of the other share a
file.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Callable, Optional, Tuple

from ..obs.trace import span as _span

_POLL_S = 2e-4

# Mailbox header: write_seq, read_ack, tag, nbytes
_MBX_HDR = struct.Struct("<QQqQ")
# Board slot header: seqlock, logical_seq, tag
_SLOT_HDR = struct.Struct("<QQq")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")


def field_offsets(hdr: struct.Struct) -> Tuple[int, ...]:
    """Cumulative byte offset of every field in a little-endian struct —
    the single source of truth for the header layouts (no magic 0/8/16/24
    literals)."""
    offs, off = [], 0
    for ch in hdr.format.lstrip("<"):
        offs.append(off)
        off += struct.calcsize("<" + ch)
    assert off == hdr.size, (off, hdr.size)
    return tuple(offs)


_MBX_OFF_WSEQ, _MBX_OFF_ACK, _MBX_OFF_TAG, _MBX_OFF_NBYTES = \
    field_offsets(_MBX_HDR)
_SLOT_OFF_LOCK, _SLOT_OFF_LOGICAL, _SLOT_OFF_TAG = field_offsets(_SLOT_HDR)


def payload_nbytes(n_elems: int, dtype) -> int:
    """Window payload size for `n_elems` scalars of the `torch.dtype`
    `dtype` — from the dtype's ITEMSIZE (a bf16 window is half its fp32
    counterpart), never from an assumed 4-byte word.  `ProcComm` sizes its
    windows from the serialized payload (`len(tree_to_bytes(tree))`), which
    agrees with this by construction; callers that pre-size a window go
    through here so the derivation lives in one place."""
    return int(n_elems) * int(dtype.itemsize)


# -- fault-injection trace hook ----------------------------------------------
#
# A fault harness (the JAX package's `repro.analysis.faults`; the port's
# analysis lane is still to come) installs a callable here to pause real
# threads at protocol boundaries and force adversarial interleavings.
# `None` (the default) costs one attribute load per boundary.

_HOOK: Optional[Callable[[str, str], None]] = None


def set_hook(fn: Optional[Callable[[str, str], None]]):
    """Install (or clear with None) the trace hook: fn(event, path) is
    called at every publish/ack/snapshot boundary, in the acting thread."""
    global _HOOK
    _HOOK = fn


def _trace(event: str, path: str):
    if _HOOK is not None:
        _HOOK(event, path)


class MailboxTimeout(RuntimeError):
    """A peer process failed to make progress within the timeout."""


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise MailboxTimeout(f"timed out after {timeout:.0f}s "
                                 f"waiting for {what}")
        time.sleep(_POLL_S)


def _create_file(path: str, size: int):
    """Atomic appearance: write zeros to a temp file, rename into place."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(b"\x00" * size)
    os.rename(tmp, path)


def _close_mmap(owner):
    """Close `owner`'s map and file, if open (`close()` of each window)."""
    if owner._mm is not None:
        owner._mm.close()
        owner._file.close()
        owner._mm = owner._file = None


def _open_mmap(path: str, size: int, timeout: float):
    import mmap
    _wait(lambda: os.path.exists(path), timeout, f"file {path}")
    f = open(path, "r+b")
    return f, mmap.mmap(f.fileno(), size)


class Mailbox:
    """One directed edge; construct with `for_writer` / `for_reader`."""

    def __init__(self, path: str, nbytes: int, timeout: float):
        self.path, self.nbytes, self.timeout = path, nbytes, timeout
        self._size = _MBX_HDR.size + nbytes
        self._file = None
        self._mm = None
        self._seq = 0                   # entries written/read so far
        self._resume_pending = False

    # -- construction --------------------------------------------------------

    @classmethod
    def for_writer(cls, path: str, nbytes: int, timeout: float) -> "Mailbox":
        mbx = cls(path, nbytes, timeout)
        if not os.path.exists(path):
            _create_file(path, mbx._size)
        mbx._ensure_open()
        # Re-attach to an existing window (worker restart): the counter
        # must RESUME from the published header, not restart at 0 — a
        # replayed sequence value would let an old reader snapshot pass
        # its seqlock re-check over a torn payload (ABA).  The header's
        # meaning depends on the protocol (lock-step: n; free-run: 2n),
        # which is only known at the first write, so defer the decode.
        mbx._resume_pending = mbx._get(_MBX_OFF_WSEQ) != 0
        return mbx

    @classmethod
    def for_reader(cls, path: str, nbytes: int, timeout: float) -> "Mailbox":
        # lazily opened: in free-run mode the writer may not have created
        # the file yet, and the reader must not block on it
        return cls(path, nbytes, timeout)

    def _ensure_open(self):
        if self._mm is None:
            self._file, self._mm = _open_mmap(self.path, self._size,
                                              self.timeout)
        return self._mm

    def close(self):
        _close_mmap(self)

    # -- header accessors ----------------------------------------------------

    def _get(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _put(self, off: int, val: int):
        _U64.pack_into(self._mm, off, val)

    # -- write side ----------------------------------------------------------

    def _resume_counter(self, lockstep: bool):
        """Decode the on-file header into the resumed entry counter.
        Lock-step publishes n; free-run publishes 2n (odd 2n-1 == died
        mid-publish, so round UP: the next publish must move the seqlock
        strictly forward past every value a live reader may hold)."""
        w = self._get(_MBX_OFF_WSEQ)
        self._seq = w if lockstep else (w + 1) // 2
        self._resume_pending = False

    def write(self, payload: bytes, tag: int, lockstep: bool):
        assert len(payload) == self.nbytes, (len(payload), self.nbytes)
        mm = self._ensure_open()
        if self._resume_pending:
            self._resume_counter(lockstep)
        self._seq += 1
        n = self._seq
        if lockstep:
            # rendezvous: entry n-1 must be consumed before we overwrite
            with _span("mbx.rendezvous.write", cat="wait", path=self.path):
                _wait(lambda: self._get(_MBX_OFF_ACK) >= n - 1, self.timeout,
                      f"reader ack {n - 1} on {self.path}")
            with _span("mbx.write", cat="wire", path=self.path,
                       bytes=self.nbytes):
                mm[_MBX_HDR.size:self._size] = payload
                _I64.pack_into(mm, _MBX_OFF_TAG, tag)
                self._put(_MBX_OFF_NBYTES, self.nbytes)
                _trace("mbx.publish.pre", self.path)
                self._put(_MBX_OFF_WSEQ, n)  # publish AFTER the payload
                _trace("mbx.publish.post", self.path)
        else:
            # seqlock overwrite, never waits: odd = write in progress
            with _span("mbx.write", cat="wire", path=self.path,
                       bytes=self.nbytes):
                self._put(_MBX_OFF_WSEQ, 2 * n - 1)
                _trace("mbx.publish.begin", self.path)
                mm[_MBX_HDR.size:self._size] = payload
                _I64.pack_into(mm, _MBX_OFF_TAG, tag)
                self._put(_MBX_OFF_NBYTES, self.nbytes)
                _trace("mbx.publish.pre", self.path)
                self._put(_MBX_OFF_WSEQ, 2 * n)
                _trace("mbx.publish.post", self.path)

    # -- read side -----------------------------------------------------------

    def read(self, lockstep: bool) -> Optional[Tuple[bytes, int]]:
        """Lock-step: block for the next entry in sequence.  Free-run:
        latest consistent snapshot, or None before the first deposit."""
        if lockstep:
            self._ensure_open()
            self._seq += 1
            n = self._seq
            with _span("mbx.rendezvous.read", cat="wait", path=self.path):
                _wait(lambda: self._get(_MBX_OFF_WSEQ) >= n, self.timeout,
                      f"entry {n} on {self.path}")
            with _span("mbx.read", cat="wire", path=self.path,
                       bytes=self.nbytes):
                out = bytes(self._mm[_MBX_HDR.size:self._size])
                tag = _I64.unpack_from(self._mm, _MBX_OFF_TAG)[0]
                _trace("mbx.ack.pre", self.path)
                self._put(_MBX_OFF_ACK, n)  # acknowledge: writer may
                _trace("mbx.ack.post", self.path)         # overwrite
            return out, tag
        if self._mm is None and not os.path.exists(self.path):
            return None                 # producer has never deposited
        self._ensure_open()
        with _span("mbx.read", cat="wire", path=self.path,
                   bytes=self.nbytes):
            deadline = time.monotonic() + self.timeout
            while True:
                s1 = self._get(_MBX_OFF_WSEQ)
                if s1 == 0:
                    return None         # file exists but nothing published
                if s1 % 2 == 0:
                    _trace("mbx.read.snap", self.path)
                    out = bytes(self._mm[_MBX_HDR.size:self._size])
                    tag = _I64.unpack_from(self._mm, _MBX_OFF_TAG)[0]
                    if self._get(_MBX_OFF_WSEQ) == s1:  # seqlock re-check
                        return out, tag     # no torn read
                if time.monotonic() > deadline:
                    raise MailboxTimeout(
                        f"seqlock never settled on {self.path}")
                time.sleep(_POLL_S)


class Board:
    """One rank's depth-2 bulletin for `pmean_all` (single writer, many
    readers).  Entries are (logical_seq, payload); readers in lock-step
    mode fetch an exact logical_seq and ack it, free-run readers take the
    freshest consistent entry."""

    def __init__(self, path: str, nbytes: int, n_ranks: int, timeout: float):
        self.path, self.nbytes, self.timeout = path, nbytes, timeout
        self.n_ranks = n_ranks
        self._stride = _SLOT_HDR.size + nbytes
        self._acks_off = 2 * self._stride
        self._size = self._acks_off + _U64.size * n_ranks
        self._mm = None
        self._file = None
        self._seq = 0

    @classmethod
    def for_writer(cls, path, nbytes, n_ranks, timeout) -> "Board":
        b = cls(path, nbytes, n_ranks, timeout)
        if not os.path.exists(path):
            _create_file(path, b._size)
        b._ensure_open()
        b._recover()
        return b

    @classmethod
    def for_reader(cls, path, nbytes, n_ranks, timeout) -> "Board":
        return cls(path, nbytes, n_ranks, timeout)

    def _ensure_open(self):
        if self._mm is None:
            self._file, self._mm = _open_mmap(self.path, self._size,
                                              self.timeout)
        return self._mm

    def close(self):
        _close_mmap(self)

    def _recover(self):
        """Writer (re)attach repair.  A writer that died mid-publish left
        its slot's seqlock odd; `write`'s read-increment would then keep
        every later publish odd and readers would spin to MailboxTimeout.
        Round each slot's lock word up to even, and resume the entry
        counter from the highest published logical_seq so the sequence
        continues instead of replaying (a replay would pair a live
        reader's stale snapshot with new bytes — the same ABA the Mailbox
        resume guards against).  Rounding is safe: `write` stores the
        payload before logical_seq, so a slot whose logical_seq is fresh
        has a complete payload, and a torn slot keeps its OLD logical_seq
        and loses the freshest-entry race to its depth-2 sibling."""
        top = 0
        for slot in (0, 1):
            off = slot * self._stride
            lock = _U64.unpack_from(self._mm, off + _SLOT_OFF_LOCK)[0]
            if lock % 2 == 1:
                _U64.pack_into(self._mm, off + _SLOT_OFF_LOCK, lock + 1)
            logical = _U64.unpack_from(self._mm,
                                       off + _SLOT_OFF_LOGICAL)[0]
            top = max(top, logical)
        self._seq = top

    def _ack(self, reader_rank: int) -> int:
        return _U64.unpack_from(
            self._mm, self._acks_off + _U64.size * reader_rank)[0]

    def write(self, payload: bytes, readers, lockstep: bool):
        """Publish entry n into slot n % 2.  Lock-step writers first wait
        until every reader acked n-2 — with two slots live, nobody can be
        lapped."""
        assert len(payload) == self.nbytes
        mm = self._ensure_open()
        self._seq += 1
        n = self._seq
        if lockstep and n > 2:
            with _span("board.rendezvous.write", cat="wait",
                       path=self.path):
                _wait(lambda: all(self._ack(r) >= n - 2 for r in readers),
                      self.timeout, f"board acks {n - 2} on {self.path}")
        off = (n % 2) * self._stride
        lock = _U64.unpack_from(mm, off + _SLOT_OFF_LOCK)[0]
        _U64.pack_into(mm, off + _SLOT_OFF_LOCK, lock + 1)  # odd: writing
        _trace("board.publish.begin", self.path)
        mm[off + _SLOT_HDR.size:off + self._stride] = payload
        _U64.pack_into(mm, off + _SLOT_OFF_LOGICAL, n)
        _trace("board.publish.pre", self.path)
        _U64.pack_into(mm, off + _SLOT_OFF_LOCK, lock + 2)  # even: published
        _trace("board.publish.post", self.path)

    def _snapshot(self, slot: int) -> Optional[Tuple[int, bytes]]:
        off = slot * self._stride
        s1 = _U64.unpack_from(self._mm, off + _SLOT_OFF_LOCK)[0]
        if s1 == 0 or s1 % 2 == 1:
            return None
        _trace("board.read.snap", self.path)
        logical = _U64.unpack_from(self._mm, off + _SLOT_OFF_LOGICAL)[0]
        payload = bytes(self._mm[off + _SLOT_HDR.size:off + self._stride])
        if _U64.unpack_from(self._mm, off + _SLOT_OFF_LOCK)[0] != s1:
            return None                                     # torn, retry
        if logical == 0:
            return None     # crash-recovered slot: lock rounded even
        return logical, payload                             # before publish

    def read(self, reader_rank: int, lockstep: bool) -> Optional[bytes]:
        """Lock-step: block for logical entry n (the reader's own call
        counter) and ack it.  Free-run: freshest consistent entry or None."""
        if lockstep:
            self._ensure_open()
            self._seq += 1
            n = self._seq
            out = []

            def ready():
                snap = self._snapshot(n % 2)
                if snap is not None and snap[0] == n:
                    out.append(snap[1])
                    return True
                return False

            with _span("board.rendezvous.read", cat="wait", path=self.path):
                _wait(ready, self.timeout,
                      f"board entry {n} on {self.path}")
            _trace("board.ack.pre", self.path)
            _U64.pack_into(self._mm,
                           self._acks_off + _U64.size * reader_rank, n)
            _trace("board.ack.post", self.path)
            return out[0]
        if self._mm is None and not os.path.exists(self.path):
            return None
        self._ensure_open()
        best = None
        for slot in (0, 1):
            snap = self._snapshot(slot)
            if snap is not None and (best is None or snap[0] > best[0]):
                best = snap
        return None if best is None else best[1]


class Barrier:
    """Counter-file barrier over the run directory: rank r bumps its cell,
    then spins until every cell reached the round."""

    def __init__(self, run_dir: str, rank: int, n_ranks: int,
                 timeout: float = 600.0):
        self.rank, self.n_ranks, self.timeout = rank, n_ranks, timeout
        self.path = os.path.join(run_dir, "barrier.bin")
        self._round = 0
        if rank == 0 and not os.path.exists(self.path):
            _create_file(self.path, _U64.size * n_ranks)
        self._file, self._mm = _open_mmap(self.path, _U64.size * n_ranks,
                                          timeout)

    def close(self):
        _close_mmap(self)

    def arrive_and_wait(self, what: str = "barrier"):
        self._round += 1
        n = self._round
        _U64.pack_into(self._mm, _U64.size * self.rank, n)
        with _span("barrier", cat="wait", what=what, round=n):
            _wait(lambda: all(
                _U64.unpack_from(self._mm, _U64.size * r)[0] >= n
                for r in range(self.n_ranks)), self.timeout,
                f"{what} (round {n})")
