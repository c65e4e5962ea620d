"""Replica handles — the fleet's unit of lifecycle management.

Counterpart of ``ddim_cold_tpu/serve/fleet.py``. A :class:`ReplicaHandle`
is what the router needs from one serving replica: warm it, hand it
requests, read its health, drain it, kill it. The surface is deliberately
narrow and host-typed (dicts, numpy-backed tickets) so a subprocess backend
(``serve/remote.py``) slots in behind the same interface — the router never
sees an Engine, a model, or a device tensor.

:class:`LocalReplica` is the in-process backend: one
:class:`~ddim_cold_torch.serve.engine.Engine` plus a worker thread that runs
the engine's dispatch loop whenever the queue is non-empty, so ``submit``
returns immediately and N replicas serve concurrently inside one process.
Their device work shares one card (each worker thread enqueues on its
current stream, the default one; each engine assembles on its own side
stream): the point here is failure isolation and lifecycle, not extra
FLOPs. The replicas of :func:`local_factory` share the caller's
``nn.Module`` (as the JAX replicas share ``params``); each engine keeps its
own model variants, spare step caches and metrics scope.

Lifecycle is a one-way street::

    new --warm()--> ready --drain()--> draining --> closed

The router only places onto ``ready`` replicas; ``drain()`` stops the
worker after the engine's own graceful drain (which fails still-queued
tickets with :class:`~ddim_cold_torch.serve.errors.EngineClosedError` — the
router's cue to fail those requests over to surviving replicas).

One name differs from the JAX package: the port builds programs, it does
not compile them (``Engine.stats["programs"]``), so the JAX handle's
``compiles_after_warmup`` and ``warmup_compiles`` are
``programs_after_warmup`` and ``warmup_programs`` here, on the handle and
in every health dict.

Host-only: no torch import — the engine and warmup are imported inside
:meth:`LocalReplica.warm` and :func:`local_factory`.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ddim_cold_torch.obs import metrics

#: replica lifecycle states (a handle only ever moves forward through these)
NEW, READY, DRAINING, CLOSED = "new", "ready", "draining", "closed"


def record_transition(scope, state: str) -> None:
    """The ONE emit site for replica lifecycle transitions — every
    ReplicaHandle backend (local thread, subprocess RPC) funnels its state
    changes through here, so a chaos run's replica churn is countable
    without scraping router internals."""
    scope.inc("fleet.replica_transitions", key=state)


class ReplicaHandle:
    """The router's view of one replica. Subclass per backend; every method
    is called from the router's control thread (plus ``submit`` from the
    router under its own lock), so implementations need to be thread-safe
    against their OWN worker, not against concurrent router calls."""

    replica_id: str = ""
    state: str = NEW

    def warm(self, configs, buckets=None, **kwargs) -> dict:
        """Build and run every (config, bucket) program; flips state to
        ready. After this, ``health()['programs_after_warmup']`` must stay 0
        for the replica's lifetime — the fleet-wide zero-program contract."""
        raise NotImplementedError

    def start(self) -> None:
        """Begin serving (idempotent)."""
        raise NotImplementedError

    def submit(self, *args, **kwargs):
        """Queue one request; returns its Ticket. Raises the engine's
        admission errors (QueueFullError / EngineClosedError)."""
        raise NotImplementedError

    def health(self) -> dict:
        """Engine health snapshot plus ``state`` and
        ``programs_after_warmup`` (the two fleet-level fields)."""
        raise NotImplementedError

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful stop: engine drain (queued tickets fail typed), worker
        stopped, state → closed. Returns the drain report."""
        raise NotImplementedError

    def close(self) -> None:
        """Hard stop (drain with a short timeout)."""
        raise NotImplementedError


class LocalReplica(ReplicaHandle):
    """In-process replica: an Engine plus its serving thread.

    The worker loop polls the engine queue every ``poll_s`` (and wakes
    immediately on ``submit``), calling :meth:`Engine.run` whenever work is
    pending — requests submitted mid-run join the run's next planning
    round, so the loop is a thin liveness shim, not a scheduler.
    """

    def __init__(self, engine, *, poll_s: float = 0.02, join_s: float = 5.0):
        self.engine = engine
        self.replica_id = engine.replica_id
        self.metrics = metrics.scope("fleet")
        self._set_state(NEW)
        self.poll_s = float(poll_s)
        self.join_s = float(join_s)
        self.warmup_programs = 0
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def _set_state(self, state: str) -> None:
        """The one state-write site: every lifecycle transition lands in the
        obs registry keyed by the state entered (via the module-level
        single emit site shared with the subprocess backend)."""
        self.state = state
        record_transition(self.metrics, state)

    def warm(self, configs, buckets=None, **kwargs) -> dict:
        from ddim_cold_torch.serve.warmup import warmup

        report = warmup(self.engine, configs, buckets, **kwargs)
        self.warmup_programs = self.engine.stats["programs"]
        self._set_state(READY)
        return report

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name=f"replica-{self.replica_id}",
                daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._work.wait(self.poll_s)
            self._work.clear()
            if self.engine.queue_depth():
                try:
                    self.engine.run()
                except Exception:  # noqa: BLE001 — run() isolates failures
                    # per batch; anything escaping it must not kill the
                    # worker (the router retires the replica via health())
                    pass

    def drain(self, timeout: Optional[float] = None) -> dict:
        self._set_state(DRAINING)
        report = self.engine.drain(timeout)
        self._stop.set()
        self._work.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            # bounded join: a wedged engine (report["idle"] False) can pin
            # the worker forever — it is a daemon thread, leave it behind
            thread.join(self.join_s)
        self._set_state(CLOSED)
        return report

    def close(self) -> None:
        if self.state != CLOSED:
            self.drain(self.join_s)

    # -------------------------------------------------------------- serving

    def submit(self, *args, **kwargs):
        # Guard the health()-snapshot → submit() window: a replica that
        # drained between the router's candidate scan and its placement must
        # raise the TYPED eviction error (the router's cue to try the next
        # candidate), never a raw engine error. The engine's own
        # closed-check rides behind this for the race where drain lands
        # mid-call.
        if self.state != READY:
            from ddim_cold_torch.serve.errors import EngineClosedError

            raise EngineClosedError(
                f"replica {self.replica_id} is {self.state}, not ready — "
                "placement raced a drain; retry on another replica")
        ticket = self.engine.submit(*args, **kwargs)
        self._work.set()
        return ticket

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    @property
    def programs_after_warmup(self) -> int:
        """Programs built since this replica's own warmup — the per-replica
        zero-program contract (a replacement replica proves 0 against its
        OWN warm, not the fleet's first)."""
        return self.engine.stats["programs"] - self.warmup_programs

    def health(self) -> dict:
        h = self.engine.health()
        h["state"] = self.state
        h["programs_after_warmup"] = self.programs_after_warmup
        return h


def local_factory(model, params=None,
                  **engine_kwargs) -> Callable[[str], LocalReplica]:
    """Factory of in-process replicas for :class:`~.router.Router`:
    ``factory(replica_id)`` builds an Engine (with that id threaded into
    its fault tags and failure messages) wrapped in a started-on-demand
    :class:`LocalReplica`. All replicas share the caller's ``model`` (one
    weight footprint for N replicas); ``params``, an optional float
    state_dict, is loaded into it once, here, before any replica serves.
    ``engine_kwargs`` go to every Engine (``buckets``, ``device``,
    ``max_queue``, ...), but not JAX's ``mesh=``: a replica across ranks
    needs a process group of its own per replica, and every rank of it
    following its leader, which the fleet does not build yet (ROADMAP.md
    Queue 1 item 14, the fleet across ranks). A replica's engine serves
    ``sp_degree`` only on a mesh, so it refuses sp configs too."""
    if "mesh" in engine_kwargs:
        raise NotImplementedError(
            "local_factory(mesh=...) is not ported yet: ROADMAP.md Queue 1 "
            "item 14 (the fleet across ranks: a process group per replica)")
    if params is not None:
        model.load_state_dict(params, strict=True)

    def factory(replica_id: str) -> LocalReplica:
        from ddim_cold_torch.serve.engine import Engine

        return LocalReplica(Engine(model, replica_id=replica_id,
                                   **engine_kwargs))
    return factory
