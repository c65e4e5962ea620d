"""Typed failure surface of the serving engine.

Counterpart of ``ddim_cold_tpu/serve/errors.py``. Every way a request can
fail is a distinct exception, and every one reaches the caller through
exactly one of two doors: :meth:`Ticket.result` / :meth:`Ticket.exception`
(the request was admitted, then failed — the engine-stage exception rides
as ``__cause__``), or a raise straight out of ``Engine.submit`` (the request
was never admitted: overload, closed engine). No failure mode leaves a
ticket blocking forever. The replica layer (``RemoteRPCError``,
``ReplicaUnreachableError``, ``ReplicaCrashedError``) is what the fleet
router and the subprocess replicas raise, and ``encode_exception`` /
``decode_exception`` carry any of these classes across the replica RPC.

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


class RankFailedError(RequestFailedError):
    """Another rank of a multi-rank engine failed its part of this batch's
    program. The ranks agree on every program's outcome, so rank 0 fails
    the batch as it would fail a program of its own: bisection follows."""


class RankLostError(EngineStalledError):
    """A rank of a multi-rank engine stopped answering (its process died, or
    a collective timed out): the engine fails its in-flight and queued
    tickets, closes, and refuses new work; results fetched before stand."""


class RemoteRPCError(ServeError):
    """The replica RPC protocol itself broke (malformed frame, unknown
    method, version skew) — a bug surface, not a load surface; never
    retried blindly."""


class ReplicaUnreachableError(ServeError, ConnectionError):
    """An RPC to an out-of-process replica could not complete (socket
    down, dropped frame, per-call deadline). Subclasses ConnectionError so
    ``RETRYABLE_EXCEPTIONS`` covers it BY CONSTRUCTION: the router treats
    it as "try another replica", never as a request failure."""


class ReplicaCrashedError(EngineClosedError):
    """The replica PROCESS died under this request (exit, SIGKILL, or
    heartbeat loss past the miss budget). Subclasses
    :class:`EngineClosedError` so the router's failover path — not the
    hedge path — re-places the dead replica's tickets onto survivors; the
    message names the replica and the detection cause."""


#: Exception classes the dispatch path (and the fleet router's hedging)
#: treats as retryable (capped exponential backoff / one hedged
#: re-placement) rather than deterministic. Built from the fault
#: registry's own transient table plus the real transfer/RPC class, so a
#: new transient fault kind is retryable by construction; anything else
#: goes straight to bisection.
RETRYABLE_EXCEPTIONS: tuple = TRANSIENT_EXCEPTIONS + (ConnectionError,)


# ---------------------------------------------------------------------------
# wire serialization (serve/remote.py RPC)
# ---------------------------------------------------------------------------

def _wire_types() -> dict:
    """Exception classes a replica server may legally put on the wire,
    by name. Covers this module's whole surface, the fault-injection
    classes (an injected fault crossing the RPC boundary must stay its
    typed self — the chaos tests assert the type, not a string), and the
    builtin failure classes the engine can surface."""
    from ddim_cold_torch.utils import faults

    classes = [ServeError, QueueFullError, DeadlineExceeded,
               RequestFailedError, RequestQuarantinedError,
               EngineClosedError, EngineStalledError, RemoteRPCError,
               ReplicaUnreachableError, ReplicaCrashedError,
               faults.FaultError, faults.TransientFault,
               faults.PermanentFault,
               TimeoutError, ConnectionError, ValueError, RuntimeError,
               KeyError, TypeError, OSError, AssertionError]
    return {c.__name__: c for c in classes}


def encode_exception(exc: BaseException) -> dict:
    """JSON-able wire form of an exception: type name, message, and the
    ``__cause__`` chain (depth-limited — a cycle-proof flattening)."""
    out: dict = {"type": type(exc).__name__, "message": str(exc)}
    cause = exc.__cause__
    chain = []
    for _ in range(4):
        if cause is None:
            break
        chain.append({"type": type(cause).__name__, "message": str(cause)})
        cause = cause.__cause__
    if chain:
        out["causes"] = chain
    return out


def decode_exception(data: dict) -> BaseException:
    """Rebuild a typed exception from :func:`encode_exception` output.
    Unknown types decode as :class:`RequestFailedError` with the original
    type name embedded — the failure stays typed and debuggable even
    across version skew. The cause chain is re-linked via ``__cause__``."""
    types = _wire_types()

    def build(d: dict) -> BaseException:
        cls = types.get(d.get("type", ""))
        msg = d.get("message", "")
        if cls is None:
            return RequestFailedError(f"[{d.get('type')}] {msg}")
        try:
            return cls(msg)
        except Exception:  # noqa: BLE001 — an exception class with a
            # picky __init__ must not break decoding; wrap it instead
            return RequestFailedError(f"[{d.get('type')}] {msg}")

    exc = build(data)
    node = exc
    for c in data.get("causes", ()):
        cause = build(c)
        node.__cause__ = cause
        node = cause
    return exc
