"""ObsConfig — the observability knob bundle of the training loops;
the port's own copy of `repro.obs.config`.

Frozen and hashable like every other config dataclass.  The default is
inert: every obs code path of the epoch is gated on the Python-level
`metrics` flag, so a disabled run takes exactly the code path it took
before the channel existed (no obs method runs, the state has no "obs"
key).
"""
import dataclasses
from typing import Optional

# version stamp of the metrics JSONL schema (the JAX package's)
OBS_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Per-run observability switches.

    metrics      carry the metrics tree (`state["obs"]`, accumulated by
                 the schedule at every exchange).  It rides beside the
                 update and never feeds back into it: every other state
                 leaf is bitwise the metrics-off run's.
    metrics_out  JSONL path for the chunk-boundary flushes of
                 `train_stacked`.  Requires ``metrics=True``.
    trace_dir    directory for the proc workers' host-side span traces
                 (`trace_rank<r>.jsonl`, a relative path lands under the
                 run directory; merge with `scripts/obsview.py`).
    profile_dir  `torch.profiler` target wrapped around the epoch loop of
                 `train_stacked` (a Chrome trace of host and device).
    """
    metrics: bool = False
    metrics_out: Optional[str] = None
    trace_dir: Optional[str] = None
    profile_dir: Optional[str] = None

    def __post_init__(self):
        if self.metrics_out and not self.metrics:
            raise ValueError(
                "ObsConfig.metrics_out requires metrics=True — there is "
                "nothing to flush without the jit-safe metrics channel")
