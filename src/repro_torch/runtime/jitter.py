"""Deterministic per-rank jitter injection for the proc runtime — the
port's own copy of `repro.runtime.jitter` (the same crc32 formula, so the
same delay for the same (seed, rank, epoch)).

The paper motivates RMA windows with compute-rate skew ("some ranks may
run the data generation task faster / slower than others", §IV-B3); the
free-running proc runtime reproduces that skew ON DEMAND so tests and
benchmarks measure a *reproducible* asynchrony instead of whatever the
host scheduler happens to do:

  * `rank_lag_ms` — systematic per-rank speed skew: rank r sleeps
    `r * rank_lag_ms` every epoch, making higher ranks proportionally
    slower producers (the straggler pattern ParaGAN measures);
  * `noise_ms` — zero-mean-ish per-epoch noise: a uniform draw in
    [0, noise_ms) seeded by `(seed, rank, epoch)` through crc32, so every
    run replays the identical sleep sequence.

The sleeps land BEFORE the epoch's compute, i.e. they model a slow
sampler/pipeline stage, and the deposit tags then carry the resulting
epoch-count skew into the exchange, where the adaptive schedule's
controller (`core.sync.AdaptiveSchedule`) reads it and widens its read
depth k_eff — no part of the schedule layer knows jitter exists.
"""
from __future__ import annotations

import dataclasses
import struct
import time
import zlib

from ..obs.trace import span as _span


@dataclasses.dataclass(frozen=True)
class JitterConfig:
    seed: int = 0
    rank_lag_ms: float = 0.0       # systematic: rank r adds r * rank_lag_ms
    noise_ms: float = 0.0          # seeded uniform [0, noise_ms) per epoch

    @property
    def enabled(self) -> bool:
        return self.rank_lag_ms > 0.0 or self.noise_ms > 0.0

    def sleep_s(self, rank: int, epoch: int) -> float:
        """Deterministic sleep for (rank, epoch) — pure, no global state."""
        t = rank * self.rank_lag_ms
        if self.noise_ms > 0.0:
            u = zlib.crc32(struct.pack("<III", self.seed & 0xFFFFFFFF,
                                       rank, epoch)) / 2**32
            t += u * self.noise_ms
        return t / 1e3

    def apply(self, rank: int, epoch: int):
        t = self.sleep_s(rank, epoch)
        if t > 0.0:
            with _span("jitter.sleep", cat="wait", ms=t * 1e3):
                time.sleep(t)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "JitterConfig":
        return cls(**d) if d else cls()
