"""Warm-executable cache — the one place the serving surface builds a
solver.

The port's counterpart of `repro.serving.cache.CompileCache`.  The JAX
service keeps one compiled executable per (problem, bucket); here an
"executable" is a built solver whose draws are on the card and whose
kernels have been built and launched once, so a hit costs the solve only.
Building is the cold-start cost, so the pool is an LRU: hot keys stay
warm, cold ones are evicted past `capacity`, and an evicted key simply
builds again.  `stats["compiles"]` counts builds, under the JAX name.

Thread-safety: `get` is atomic under one lock (hit bookkeeping, miss
build, eviction).  The builder runs inside the lock, so two racing
drainers never build the same key twice.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List


class CompileCache:
    """LRU cache of warm solver callables keyed by an arbitrary hashable.

    `get(key, builder)` returns the cached callable, or calls `builder()`
    on a miss, inserts the result, and evicts the least-recently-used
    entries down to `capacity`.  Every hit refreshes the key's recency.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "compiles": 0, "evictions": 0}

    def get(self, key: Hashable, builder: Callable[[], Any]):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.stats["hits"] += 1
                return self._entries[key]
            self.stats["misses"] += 1
            fn = builder()
            self.stats["compiles"] += 1
            self._entries[key] = fn
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats["evictions"] += 1
            return fn

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[Hashable]:
        """Keys in eviction order: least-recently-used first."""
        with self._lock:
            return list(self._entries)
