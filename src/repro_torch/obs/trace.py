"""Host-side span tracer for the proc runtime — the port's own copy of
`repro.obs.trace` (plain Python, the same events).

A process installs one `Tracer` writing JSONL (`trace_rank<r>.jsonl` in
the JAX package's worker); every line is already a Chrome-trace event
(``ph="X"`` complete spans, ``ph="C"`` counters, ``ph="i"`` instants)
with the JAX tracer's keys, so `scripts/obsview.py` and `merge_traces`
read either package's files, and merging rank files into a
Perfetto/`chrome://tracing` document is concatenation plus metadata.

  * Wall-clock timestamps (``time.time()``, microseconds) so spans from
    different processes land on one timeline; durations use the
    monotonic clock, so a span is (wall start, monotonic duration).
  * Crash-safe: one `json.dumps` + newline + flush per event; a killed
    process loses at most a torn trailing line, which `load_events`
    skips.
  * With no tracer installed, `span()` returns a shared `nullcontext`:
    one attribute load and one branch.  The mailbox windows, the jitter
    and `ProcComm` record their waits and transfers through it.
"""
import bisect
import contextlib
import json
import threading
import time
from typing import Optional

__all__ = ["Tracer", "current_tracer", "install", "instant", "counter",
           "epoch_breakdown", "load_events", "merge_traces", "span",
           "uninstall", "write_chrome_trace"]


class Tracer:
    """Per-process JSONL event writer in Chrome-trace event format.

    ``pid`` in every event is the RANK (not the OS pid): the merged
    trace then groups each rank as one "process" row, which is the
    timeline the skew study wants to read.
    """

    def __init__(self, path: str, rank: int = 0):
        self.path, self.rank = path, rank
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._depth = 0
        self._closed = False

    # -- low level -------------------------------------------------------
    def _emit(self, ev: dict):
        line = json.dumps(ev, separators=(",", ":"))
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self._f.flush()                      # crash-safe: line-at-a-time

    # -- event kinds -----------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "runtime", **args):
        """Complete span (``ph="X"``): wall-clock start, monotonic dur."""
        t_wall = time.time()
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            dur_us = (time.perf_counter() - t0) * 1e6
            self._emit({
                "name": name, "cat": cat, "ph": "X",
                "ts": round(t_wall * 1e6, 3), "dur": round(dur_us, 3),
                "pid": self.rank, "tid": 0,
                "args": dict(args, depth=self._depth),
            })

    def instant(self, name: str, cat: str = "runtime", **args):
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": round(time.time() * 1e6, 3),
                    "pid": self.rank, "tid": 0, "args": args})

    def counter(self, name: str, value, cat: str = "metric"):
        self._emit({"name": name, "cat": cat, "ph": "C",
                    "ts": round(time.time() * 1e6, 3),
                    "pid": self.rank, "tid": 0, "args": {name: value}})

    def close(self):
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


# ----------------------------------------------------------------------------
# module-level installation — instrumented call sites go through these,
# so the disabled path costs one attribute load and one branch


_TRACER: Optional[Tracer] = None
_NULL_SPAN = contextlib.nullcontext()


def install(tracer: Tracer):
    global _TRACER
    _TRACER = tracer


def uninstall() -> Optional[Tracer]:
    """Detach (and return, unclosed) the installed tracer."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, cat: str = "runtime", **args):
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "runtime", **args):
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, value, cat: str = "metric"):
    t = _TRACER
    if t is not None:
        t.counter(name, value, cat=cat)


# ----------------------------------------------------------------------------
# reading + merging — scripts/obsview.py drives these


def load_events(path: str):
    """Parse one per-rank JSONL trace; returns (events, n_skipped).

    Torn/garbage lines (a worker killed mid-write) are skipped, not
    fatal — crash-safety is the point of line-at-a-time flushing.
    """
    events, skipped = [], 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(ev, dict) and "ph" in ev:
                events.append(ev)
            else:
                skipped += 1
    return events, skipped


def merge_traces(paths):
    """Merge per-rank JSONL traces into ONE Chrome-trace document.

    Timestamps are rebased to the earliest event so the trace opens at
    t=0; per-rank ``process_name`` metadata makes Perfetto label each
    rank row.  The returned dict is `json.dump`-able as-is.
    """
    events = []
    for p in sorted(paths):
        evs, _ = load_events(p)
        events.extend(evs)
    t0 = min((e["ts"] for e in events if "ts" in e), default=0.0)
    for e in events:
        if "ts" in e:
            e["ts"] = round(e["ts"] - t0, 3)
    ranks = sorted({e.get("pid", 0) for e in events})
    meta = [{"ph": "M", "name": "process_name", "pid": r, "tid": 0,
             "args": {"name": f"rank {r}"}} for r in ranks]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, trace: dict):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


# the spans a proc worker's epoch is made of (`runtime.launch`), each a
# direct child of its `epoch` span
EPOCH_PARTS = ("compute.grads", "exchange", "compute.apply", "jitter.sleep")


def epoch_breakdown(events, skip: int = 1):
    """Where a proc worker's epochs went, from trace events: per rank,
    over its epochs after the first `skip` (a worker's first epoch carries
    its lazy CUDA set-up), {"epochs": n, "epoch_s": their summed `epoch`
    span seconds, "epoch_p50_s": the median one, and the share of the
    summed time in each of `EPOCH_PARTS`, in "exchange.wait" (the wait
    spans nested in the exchange: rendezvous waits and seqlock retries)
    and in "other" (the epoch outside its parts)}.  A span belongs to the
    epoch span of its rank that holds its start."""
    spans = {}
    for ev in events:
        if ev.get("ph") == "X":
            spans.setdefault(ev.get("pid", 0), []).append(ev)
    out = {}
    for rank, evs in spans.items():
        epochs = sorted((e for e in evs if e["name"] == "epoch"
                         and e.get("args", {}).get("depth", 0) == 0),
                        key=lambda e: e["ts"])[skip:]
        starts = [e["ts"] for e in epochs]
        r = dict({k: 0.0 for k in EPOCH_PARTS}, **{"exchange.wait": 0.0})
        for ev in evs:
            i = bisect.bisect_right(starts, ev["ts"]) - 1
            if ev["name"] == "epoch" or i < 0 or \
                    ev["ts"] > starts[i] + epochs[i]["dur"]:
                continue
            depth = ev.get("args", {}).get("depth", 0)
            if ev["name"] in EPOCH_PARTS and depth == 1:
                r[ev["name"]] += ev["dur"]
            elif ev.get("cat") == "wait" and depth >= 2:
                r["exchange.wait"] += ev["dur"]
        durs = sorted(e["dur"] for e in epochs)
        total = sum(durs)
        r["other"] = total - sum(r[k] for k in EPOCH_PARTS)
        for k in list(r):
            r[k] /= total or 1.0
        r.update(epochs=len(epochs), epoch_s=total / 1e6,
                 epoch_p50_s=(durs[len(durs) // 2] if durs else 0.0) / 1e6)
        out[rank] = r
    return out
