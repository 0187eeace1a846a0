"""Thread-safe serving counters and latency histograms.

Backing store for `SolveService.snapshot()`: monotonically increasing
named counters plus log-spaced latency histograms with approximate
percentiles.  The port's own copy of `repro.obs.counters` (plain
host-side Python, same behaviour).
"""
import threading

__all__ = ["Counters", "LatencyHistogram", "DEFAULT_BOUNDS"]

# Geometric ladder 100 µs .. ~105 s (×2 per bucket) + overflow: wide
# enough for queue-inclusive request latencies on any of the problem
# buckets, coarse enough that a snapshot stays one screen.
DEFAULT_BOUNDS = tuple(1e-4 * 2 ** i for i in range(21))


class LatencyHistogram:
    """Fixed-bound histogram over seconds; NOT thread-safe on its own
    (callers hold the owning `Counters` lock)."""

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow bucket
        self.n = 0
        self.total = 0.0

    def observe(self, value: float):
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.n += 1
        self.total += float(value)

    def percentile(self, q: float) -> float:
        """Approximate q-quantile: the upper edge of the bucket where the
        cumulative count crosses q·n (overflow reports the top bound)."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        return {
            "count": self.n,
            "sum_s": self.total,
            "mean_s": self.total / self.n if self.n else 0.0,
            "p50_s": self.percentile(0.50),
            "p90_s": self.percentile(0.90),
            "p99_s": self.percentile(0.99),
        }


class Counters:
    """Named monotonic counters + named latency histograms, one lock.

    `inc` is safe to call while holding ANOTHER lock (it only takes its
    own, never calls out) — that is what lets `serving/queue.py` record
    a rejection inside its queue lock, BEFORE raising `Backpressure`,
    so adversarial interleavings can never observe an undercount.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._hists = {}

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def observe(self, name: str, value: float):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            h.observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counts),
                "latency": {k: h.snapshot()
                            for k, h in sorted(self._hists.items())},
            }
