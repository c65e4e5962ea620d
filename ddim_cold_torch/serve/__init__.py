"""Sampler serving: bucketed batching over the port's samplers, with the
robustness layer (bounded queue, deadlines, retries, bisection, drain, the
stall watchdog, fault injection) and the metrics registry and spans it
reports through, and the fleet over it: replica handles in process
(``LocalReplica``) or in subprocesses over a socket RPC
(``RemoteReplica``), the health-aware ``Router`` and the ``Autoscaler``.

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

Fleet::

    router = serve.Router(serve.local_factory(model, buckets=(8,)),
                          replicas=2, configs=[serve.SamplerConfig(k=20)])
    imgs = router.submit(seed=0, n=5, config=serve.SamplerConfig(k=20)).result()
    router.drain()

``serve.remote_factory(spec)`` in place of ``local_factory`` runs each
replica in its own process (``python -m ddim_cold_torch.serve.replica_main``).
Replicas across ranks: rank 0 of a mesh builds the router over
``serve.local_factory(model, mesh=mesh, buckets=(8,))`` while every other
rank calls ``serve.follow_replicas(model, mesh=mesh, buckets=(8,))``.
"""

from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.serve.autoscale import Autoscaler
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            SeqParallelConfigError, Ticket,
                                            cover_rows, plan_batches,
                                            select_bucket)
from ddim_cold_torch.serve.engine import Engine
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS, DeadlineExceeded,
                                          EngineClosedError, EngineStalledError,
                                          QueueFullError, RemoteRPCError,
                                          ReplicaCrashedError,
                                          ReplicaUnreachableError,
                                          RequestFailedError,
                                          RequestQuarantinedError, ServeError)
from ddim_cold_torch.serve.fleet import (LocalReplica, MeshReplica, ReplicaHandle,
                                         follow_replicas, local_factory)
from ddim_cold_torch.serve.remote import (RemoteReplica, remote_factory,
                                          save_params_npz)
from ddim_cold_torch.serve.router import Router
from ddim_cold_torch.serve.warmup import warmup
from ddim_cold_torch.utils import faults

__all__ = [
    "Autoscaler", "BatchPlan", "DeadlineExceeded", "Engine",
    "EngineClosedError", "EngineStalledError", "LocalReplica", "MeshReplica",
    "QueueFullError", "RETRYABLE_EXCEPTIONS", "RemoteRPCError",
    "RemoteReplica", "ReplicaCrashedError", "ReplicaHandle",
    "ReplicaUnreachableError", "Request", "RequestFailedError",
    "RequestQuarantinedError", "Router", "SamplerConfig",
    "SeqParallelConfigError", "ServeError", "Ticket", "cover_rows", "faults",
    "follow_replicas", "local_factory", "metrics", "plan_batches", "remote_factory",
    "save_params_npz", "select_bucket", "spans", "warmup",
]
