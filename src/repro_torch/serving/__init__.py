"""The port's solve service — batched inverse-problem solving on the card.

Counterpart of `repro.serving` (the solve service; the JAX package's LLM
engine scaffolding is not part of it).  Clients `submit(problem, y)`
observations; the service shape-buckets and batches them (`bucketing`),
runs them through a pool of warm per-(problem, bucket) solvers (`cache`,
LRU), and bounds admission with reject-not-block backpressure (`queue`).
What a solver computes comes from `core.workflow.make_solver`.
"""
from .bucketing import RequestTooLarge, bucket_for, make_buckets, pad_events
from .cache import CompileCache
from .queue import Backpressure, BoundedRequestQueue
from .service import ServingConfig, ServingError, SolveService, Ticket

__all__ = [
    "Backpressure", "BoundedRequestQueue", "CompileCache", "RequestTooLarge",
    "ServingConfig", "ServingError", "SolveService", "Ticket",
    "bucket_for", "make_buckets", "pad_events",
]
