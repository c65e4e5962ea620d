"""Sampler serving: bucketed batching over the port's DDIM loop.

Quickstart::

    from ddim_cold_torch import serve
    eng = serve.Engine(model, buckets=(4, 8))          # model on the card
    serve.warmup(eng, [serve.SamplerConfig(k=20)])
    t = eng.submit(seed=0, n=5, k=20)                  # → Ticket
    eng.run()                                          # drain the queue
    imgs = t.result()                                  # (5, H, W, C) in [0, 1]
"""

from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            SeqParallelConfigError, Ticket,
                                            cover_rows, plan_batches,
                                            select_bucket)
from ddim_cold_torch.serve.engine import Engine
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS,
                                          RequestFailedError, ServeError)
from ddim_cold_torch.serve.warmup import warmup

__all__ = [
    "BatchPlan", "Engine", "RETRYABLE_EXCEPTIONS", "Request",
    "RequestFailedError", "SamplerConfig", "SeqParallelConfigError",
    "ServeError", "Ticket", "cover_rows", "plan_batches", "select_bucket",
    "warmup",
]
