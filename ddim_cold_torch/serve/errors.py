"""Typed failure surface of the serving engine.

Counterpart of ``ddim_cold_tpu/serve/errors.py`` for the classes the core
engine raises. A request that was admitted and then failed reaches its
caller through :meth:`Ticket.result` / :meth:`Ticket.exception`, with the
stage exception as ``__cause__``; a request that was never admitted raises
out of ``Engine.submit``. The classes of the robustness layer (bounded
queue, deadlines, quarantine, drain, watchdog) come with it, and the wire
serialization with the subprocess fleet (ROADMAP.md Queue 1 items 6 and 15).
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for serving-engine failures."""


class TransientError(ServeError):
    """A failure that a retry may clear (the class the fault-injection
    registry raises when the robustness slice ports it)."""


class RequestFailedError(ServeError):
    """A pipeline stage (assembly / dispatch / fetch) failed this request's
    batch; the stage exception is attached as ``__cause__``."""


#: the transient (retry-recoverable) failure classes of the port
TRANSIENT_EXCEPTIONS: tuple = (TransientError,)

#: what a dispatch retry (and the fleet router's hedging) may retry: the
#: transient classes plus the transfer/RPC class
RETRYABLE_EXCEPTIONS: tuple = TRANSIENT_EXCEPTIONS + (ConnectionError,)
