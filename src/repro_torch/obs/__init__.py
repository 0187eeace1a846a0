"""Telemetry of the port, its own copy of `repro.obs`, in four modules:

  * ``obs.config``   — `ObsConfig`, the training loops' knob bundle
    (``metrics`` / ``metrics_out`` / ``trace_dir`` / ``profile_dir``).
    Plain configuration: every layer may import it.
  * the metrics channel — its device half is the schedule's obs tree in
    `core/sync.py` (`SyncSchedule.exchange_with_obs` and friends), so an
    epoch reads nothing back; ``obs.metrics`` holds only the host-side
    flush (`MetricsWriter`, `chunk_row`) of `train_stacked`.  The proc
    runtime and serving (`runtime/`, `serving/`) do not import it.
  * ``obs.trace``    — the proc runtime's host-side span tracer (per-rank
    JSONL, Chrome-trace export).  `core/sync.py`, `core/workflow.py` and
    `core/ring.py` do not import it: on the device, telemetry rides the
    metrics tree.
  * ``obs.counters`` — thread-safe counters and latency histograms behind
    `SolveService.snapshot()`.

`tests/test_torch_kernels.py` holds the layering, as the JAX package's
`scripts/repro_lint.py` check 9 holds its own.
"""
from .config import OBS_SCHEMA_VERSION, ObsConfig
from .trace import (Tracer, current_tracer, install, instant, load_events,
                    merge_traces, span, uninstall, write_chrome_trace)

__all__ = [
    "OBS_SCHEMA_VERSION", "ObsConfig", "Tracer", "current_tracer",
    "install", "instant", "load_events", "merge_traces", "span",
    "uninstall", "write_chrome_trace",
]
