"""Typed failure surface of the serving engine.

Counterpart of ``ddim_cold_tpu/serve/errors.py``. Every way a request can
fail is a distinct exception, and every one reaches the caller through
exactly one of two doors: :meth:`Ticket.result` / :meth:`Ticket.exception`
(the request was admitted, then failed — the engine-stage exception rides
as ``__cause__``), or a raise straight out of ``Engine.submit`` (the request
was never admitted: overload, closed engine). No failure mode leaves a
ticket blocking forever.

The replica classes (``RemoteRPCError``, ``ReplicaUnreachableError``,
``ReplicaCrashedError``) and the exception wire format
(``encode_exception`` / ``decode_exception``) come with the fleet,
ROADMAP.md Queue 1 item 15.

Host-only: no torch import.
"""

from __future__ import annotations

from ddim_cold_torch.utils.faults import TRANSIENT_EXCEPTIONS


class ServeError(Exception):
    """Base class for serving-engine failures."""


class QueueFullError(ServeError):
    """Raised by ``submit`` when the bounded queue is at ``max_queue``
    (admission control: reject-on-overload beats unbounded latency)."""


class DeadlineExceeded(ServeError):
    """The request's deadline elapsed while it was queued or waiting to
    dispatch — it fails fast instead of occupying a bucket."""


class RequestFailedError(ServeError):
    """A pipeline stage (assembly / dispatch / fetch) failed this request's
    batch; the stage exception is attached as ``__cause__``."""


class RequestQuarantinedError(RequestFailedError):
    """Bisection isolated this request as the one that deterministically
    poisons any batch containing it; its batchmates completed."""


class EngineClosedError(ServeError):
    """The engine is draining / drained: queued tickets fail with this and
    new submissions are rejected."""


class EngineStalledError(ServeError):
    """The engine's stall watchdog fired: a device interaction went silent
    past the stall budget (wedged device call). In-flight and queued tickets
    fail with this; batches fetched before the stall keep their results."""


#: Exception classes the dispatch path treats as retryable (capped
#: exponential backoff) rather than deterministic. Built from the fault
#: registry's own transient table plus the real transfer class, so a new
#: transient fault kind is retryable by construction; anything else goes
#: straight to bisection.
RETRYABLE_EXCEPTIONS: tuple = TRANSIENT_EXCEPTIONS + (ConnectionError,)
