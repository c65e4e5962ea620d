"""Sampler serving: bucketed batching over the port's samplers, with the
robustness layer (bounded queue, deadlines, retries, bisection, drain, the
stall watchdog, fault injection) and the metrics registry and spans it
reports through.

Quickstart::

    from ddim_cold_torch import serve
    eng = serve.Engine(model, buckets=(4, 8))          # model on the card
    serve.warmup(eng, [serve.SamplerConfig(k=20)])
    t = eng.submit(seed=0, n=5, k=20)                  # → Ticket
    eng.run()                                          # drain the queue
    imgs = t.result()                                  # (5, H, W, C) in [0, 1]

Chaos: ``with serve.faults.inject(serve.faults.FaultSpec("serve.dispatch",
"transient", rate=0.3, seed=11)): ...``; counters: ``eng.stats``,
``eng.health()``, ``serve.metrics.snapshot()``; traces: ``with
serve.spans.tracing(): ...``.
"""

from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            SeqParallelConfigError, Ticket,
                                            cover_rows, plan_batches,
                                            select_bucket)
from ddim_cold_torch.serve.engine import Engine
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS, DeadlineExceeded,
                                          EngineClosedError, EngineStalledError,
                                          QueueFullError, RequestFailedError,
                                          RequestQuarantinedError, ServeError)
from ddim_cold_torch.serve.warmup import warmup
from ddim_cold_torch.utils import faults

__all__ = [
    "BatchPlan", "DeadlineExceeded", "Engine", "EngineClosedError",
    "EngineStalledError", "QueueFullError", "RETRYABLE_EXCEPTIONS", "Request",
    "RequestFailedError", "RequestQuarantinedError", "SamplerConfig",
    "SeqParallelConfigError", "ServeError", "Ticket", "cover_rows", "faults",
    "metrics", "plan_batches", "select_bucket", "spans", "warmup",
]
