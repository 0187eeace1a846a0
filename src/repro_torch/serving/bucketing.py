"""Shape bucketing — fixed-shape executables over variable-size requests.

The port's own copy of `repro.serving.bucketing`.  A solve request
carries `y` with a client-chosen event count `n`.  Serving every distinct
`n` with its own warm executable would melt the cache (and, once solves
are captured as CUDA graphs, each shape needs its own).  Instead the
service quantizes
`n` onto a small ladder of BUCKETS: a request is padded up to the smallest
bucket that admits it (`bucket_for`), runs through the per-(problem,
bucket) warm executable, and the padding rows are masked out of every
statistic the solver computes (`pad_events` returns the mask; the solver's
masked moments never read a padded row).

Invariants (pinned by tests/test_torch_serving.py):
  * a request with n <= max(buckets) lands in EXACTLY ONE bucket — the
    smallest admitting one; it is never split across buckets;
  * n > max(buckets) is rejected at submit time (`RequestTooLarge`), not
    silently truncated;
  * padded and unpadded evaluations of the same request are numerically
    identical (mask discipline).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class RequestTooLarge(ValueError):
    """Request event count exceeds the largest configured bucket."""


def make_buckets(max_events: int, base: int = 64, growth: int = 4,
                 ) -> Tuple[int, ...]:
    """Geometric bucket ladder: base, base*growth, ... up to >= max_events.

    A coarse (growth=4) ladder keeps the warm pool small — warm-up cost
    scales with the number of buckets, padding waste with the growth
    factor (worst case (growth-1)/growth of a bucket's rows are padding).
    """
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    if base < 1 or growth < 2:
        raise ValueError(f"need base >= 1 and growth >= 2, got "
                         f"base={base} growth={growth}")
    out = [base]
    while out[-1] < max_events:
        out.append(out[-1] * growth)
    return tuple(out)


def validate_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """A bucket ladder must be non-empty, positive and strictly increasing
    (duplicates would make 'the smallest admitting bucket' ambiguous)."""
    b = tuple(int(x) for x in buckets)
    if not b or any(x < 1 for x in b) or any(
            x >= y for x, y in zip(b, b[1:])):
        raise ValueError(
            f"buckets must be a non-empty strictly-increasing ladder of "
            f"positive sizes, got {buckets!r}")
    return b


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket admitting an n-event request."""
    if n < 1:
        raise ValueError(f"request must carry at least one event, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise RequestTooLarge(
        f"request with {n} events exceeds the largest bucket "
        f"{max(buckets)}; split it client-side or configure a larger "
        f"ladder (ServingConfig.buckets)")


def pad_events(y: np.ndarray, bucket: int):
    """Pad `y` [n, obs_dim] up to [bucket, obs_dim]; returns (padded,
    mask [bucket] bool) with mask True exactly on the n real rows.

    Padding rows are ZERO, but nothing may depend on that: the solver's
    masked moments multiply every row by the mask, so any padding value
    yields the same result (pinned by
    tests/test_torch_serving.py::test_padding_masked_out_of_results).
    """
    y = np.asarray(y)
    n = y.shape[0]
    if n > bucket:
        raise ValueError(f"{n} events do not fit bucket {bucket}")
    padded = np.zeros((bucket,) + y.shape[1:], dtype=y.dtype)
    padded[:n] = y
    mask = np.zeros((bucket,), dtype=bool)
    mask[:n] = True
    return padded, mask
