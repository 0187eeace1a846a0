"""Host-side flush of the metrics channel — the port's own copy of
`repro.obs.metrics`, with its JSONL schema and separators, so a port
metrics file and a JAX one for the same run differ only in values.

The device half of the channel lives in `core/sync.py`
(`SyncSchedule.init_obs_state` / `exchange_with_obs` /
`accumulate_obs`); this module turns chunk-boundary values into rows.
The proc runtime and serving (`runtime/`, `serving/`) do not import it:
a worker writes its own summary.
"""
import json

import numpy as np

from .config import OBS_SCHEMA_VERSION

__all__ = ["MetricsWriter", "chunk_row", "OBS_SCHEMA_VERSION"]


class MetricsWriter:
    """JSONL metrics sink: one header line, then one row per flush, each
    line flushed as it is written.  The header carries the schema
    version and the run's provenance."""

    def __init__(self, path: str, header: dict = None):
        self.path = path
        self._f = open(path, "w", encoding="utf-8")
        self._emit(dict({"schema": OBS_SCHEMA_VERSION, "kind": "header"},
                        **(header or {})))

    def _emit(self, row: dict):
        self._f.write(json.dumps(row, separators=(",", ":")) + "\n")
        self._f.flush()

    def write_row(self, row: dict):
        self._emit(dict(row, kind="row"))

    def close(self):
        if not self._f.closed:
            self._f.close()


def _scalar(x, reduce=np.max):
    a = np.asarray(x, dtype=np.float64)
    a = a[np.isfinite(a)]
    return float(reduce(a)) if a.size else 0.0


_LOSSES = (("d_loss", np.mean), ("g_loss", np.mean), ("residuals", np.mean))
_OBS_INTS = ("k_eff", "shipped", "ship_count", "exchange_count")
_OBS_FLOATS = ("skew_ema", "deposit_age")


def _last_entries(leaves):
    """Each leaf's last entry as float64 numpy; tensors come back to the
    host in one copy (one cat on their device)."""
    if leaves and hasattr(leaves[0], "detach"):
        import torch
        lasts = [x[-1].detach().reshape(-1) for x in leaves]
        flat = torch.cat([x.double() for x in lasts]).cpu().numpy()
        return np.split(flat, np.cumsum([x.numel() for x in lasts])[:-1])
    return [np.asarray(x, dtype=np.float64)[-1] for x in leaves]


def chunk_row(epochs_done: int, metrics) -> dict:
    """One flush row from stacked metrics (leaves [chunk, ...], tensors or
    arrays; only the last entry of each is read).

    Loss and residual fields are rank means of the last epoch; the obs
    fields are rank maxima of the cumulative obs state at the chunk
    boundary (skew and staleness are worst-case quantities)."""
    losses = [(k, red) for k, red in _LOSSES if k in metrics]
    obs = metrics.get("obs")
    obs_keys = _OBS_INTS + _OBS_FLOATS if obs is not None else ()
    vals = iter(_last_entries([metrics[k] for k, _ in losses]
                              + [obs[k] for k in obs_keys]))
    row = {"epoch": int(epochs_done)}
    for k, red in losses:
        row["residual" if k == "residuals" else k] = _scalar(next(vals), red)
    for k in obs_keys:
        v = _scalar(next(vals))
        row[k] = int(v) if k in _OBS_INTS else v
    return row
