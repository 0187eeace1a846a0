"""Bounded request queue with backpressure — the admission control layer.

The port's own copy of `repro.serving.queue`, same behaviour and hooks.

One queue per service, internally segmented into per-(problem, bucket)
FIFO lanes so the drainer can pull a whole same-shape batch in one pop.
Admission is bounded by a GLOBAL capacity: a full queue REJECTS the
submit with `Backpressure` (carrying a `retry_after_s` hint) instead of
blocking the client — the overload signal must reach the caller while the
caller can still act on it (shed load, retry elsewhere), which a blocking
put never does.

Ordering guarantees (pinned by tests/test_torch_serving.py):
  * per-lane FIFO: requests of one (problem, bucket) are served in
    submission order;
  * cross-lane fairness: `next_key` returns the lane whose HEAD request
    is globally oldest (admission sequence number), so a busy bucket
    cannot starve a quiet one;
  * exactly-once: `drain` pops under the lock — a request is handed to
    exactly one drainer, never duplicated, never dropped (concurrency
    regression tests drive adversarial interleavings through the
    `set_hook` trace points).

Trace hooks (`set_hook`, same shape as `repro.runtime.mailbox.set_hook`): the
events "submit" / "admit" / "reject" / "drain" fire OUTSIDE the lock —
a fault-injection gate that parks a thread at a hook must not park it
while holding the queue lock, or the harness would deadlock the very
interleavings it exists to exercise.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

_HOOK: Optional[Callable[[str, str], None]] = None


def set_hook(hook: Optional[Callable[[str, str], None]]):
    """Install a trace hook `hook(event, path)` (None clears).  Events:
    'queue.submit' (pre-admission), 'queue.admit', 'queue.reject',
    'queue.drain'; `path` is the str() of the lane key."""
    global _HOOK
    _HOOK = hook


def _trace(event: str, path: str):
    hook = _HOOK
    if hook is not None:
        hook(event, path)


class Backpressure(RuntimeError):
    """Queue full: retry after `retry_after_s` (or shed the request)."""

    def __init__(self, retry_after_s: float, message: str):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class BoundedRequestQueue:
    def __init__(self, capacity: int, retry_after_s: float = 0.05,
                 counters=None):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.retry_after_s = retry_after_s
        self.counters = counters       # optional obs.counters.Counters
        self._lanes: Dict[Hashable, deque] = {}
        self._lock = threading.Lock()
        self._size = 0
        self._seq = 0
        self.stats: Dict[str, int] = {"admitted": 0, "rejected": 0,
                                      "drained": 0}

    def __len__(self) -> int:
        with self._lock:
            return self._size

    def submit(self, key: Hashable, item: Any):
        """Admit `item` into lane `key`, or raise `Backpressure` without
        blocking when the global capacity is reached."""
        _trace("queue.submit", str(key))
        with self._lock:
            if self._size >= self.capacity:
                # record the rejection HERE, inside the lock and before
                # the raise below: a counter bumped after (or skipped on)
                # the raise can undercount under adversarial
                # interleavings — a reader parked at the 'queue.reject'
                # hook must already see this rejection in every counter
                self.stats["rejected"] += 1
                if self.counters is not None:
                    self.counters.inc("queue.rejected")
                full = self._size
            else:
                full = None
                self._lanes.setdefault(key, deque()).append(
                    (self._seq, item))
                self._seq += 1
                self._size += 1
                self.stats["admitted"] += 1
                if self.counters is not None:
                    self.counters.inc("queue.admitted")
        if full is not None:
            _trace("queue.reject", str(key))
            raise Backpressure(
                self.retry_after_s,
                f"queue full ({full}/{self.capacity} requests pending); "
                f"retry after {self.retry_after_s}s")
        _trace("queue.admit", str(key))

    def next_key(self) -> Optional[Hashable]:
        """The lane whose head request is globally oldest (None if empty)."""
        with self._lock:
            best, best_seq = None, None
            for key, lane in self._lanes.items():
                if lane and (best_seq is None or lane[0][0] < best_seq):
                    best, best_seq = key, lane[0][0]
            return best

    def drain(self, key: Hashable, max_n: int) -> List[Any]:
        """Pop up to `max_n` items from lane `key` in FIFO order.  Atomic:
        each admitted item is returned by exactly one drain call."""
        out: List[Any] = []
        with self._lock:
            lane = self._lanes.get(key)
            while lane and len(out) < max_n:
                out.append(lane.popleft()[1])
                self._size -= 1
            self.stats["drained"] += len(out)
            if self.counters is not None and out:
                self.counters.inc("queue.drained", len(out))
        _trace("queue.drain", str(key))
        return out

    def pending(self) -> Dict[Hashable, int]:
        """Lane -> queued count snapshot (diagnostics)."""
        with self._lock:
            return {k: len(v) for k, v in self._lanes.items() if v}
