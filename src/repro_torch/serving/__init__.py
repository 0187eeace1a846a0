"""The port's serving layer: the solve service and the LLM engine.

Counterpart of `repro.serving`.  The LLM engine (`engine`: prefill and
batched decode with the ring-buffer KV cache, `generate`) serves the
dense decoders of `repro_torch.configs`.  Solve-service clients
`submit(problem, y)` observations; the service shape-buckets and batches
them (`bucketing`), runs them through a pool of warm per-(problem,
bucket) solvers (`cache`, LRU), and bounds admission with
reject-not-block backpressure (`queue`).
What a solver computes comes from `core.workflow.make_solver`.
"""
from .bucketing import RequestTooLarge, bucket_for, make_buckets, pad_events
from .cache import CompileCache
from .engine import generate, make_prefill_fn, make_serve_step
from .queue import Backpressure, BoundedRequestQueue
from .service import ServingConfig, ServingError, SolveService, Ticket

__all__ = [
    "Backpressure", "BoundedRequestQueue", "CompileCache", "RequestTooLarge",
    "ServingConfig", "ServingError", "SolveService", "Ticket",
    "bucket_for", "generate", "make_buckets", "make_prefill_fn",
    "make_serve_step", "pad_events",
]
