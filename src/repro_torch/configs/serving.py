"""Serving presets — ServingConfig/SolveConfig bundles for the solve
service, as in `repro.configs.serving`.

`DEFAULT` is the production-shaped surface (full bucket ladder, deep
queue); with a 16-rank stack its sampler call is u [2048, 64, 2].
`REDUCED` is test scale: tiny buckets and candidate counts.
"""
from ..core.workflow import SolveConfig
from ..serving.service import ServingConfig

DEFAULT = ServingConfig(
    buckets=(64, 256, 1024),
    max_batch=8,
    queue_capacity=64,
    cache_capacity=8,
    retry_after_s=0.05,
    solve=SolveConfig(n_candidates=128, events_per_candidate=64,
                      top_frac=0.25),
)

# test scale: small ladder, small candidate pool, batch of 4
REDUCED = ServingConfig(
    buckets=(16, 64),
    max_batch=4,
    queue_capacity=16,
    cache_capacity=4,
    retry_after_s=0.01,
    solve=SolveConfig(n_candidates=32, events_per_candidate=16,
                      top_frac=0.25),
)
