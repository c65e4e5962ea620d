"""Health-aware replica router: fleet-scale serving over N engine replicas.

Counterpart of ``ddim_cold_tpu/serve/router.py``. The fault-tolerant engine
(serve/engine.py) is a single-process unit — a
stalled or poisoned replica still takes its whole queue down with it. The
router makes the replica the blast radius instead of the fleet:

* **Failure-aware placement** — ``submit()`` queues at the router; the
  control loop places each request onto the least-loaded healthy replica
  (by ``health()`` queue depth + open tickets), skipping replicas that are
  stalled, closed, draining, or quarantine-heavy. Placement is itself a
  fault site (``router.place``) so chaos schedules can break the act of
  routing, not just the replicas.

* **Capped hedged re-placement** — a ticket that fails with a retryable
  cause (``errors.RETRYABLE_EXCEPTIONS``, e.g. an assembly-stage transient
  the engine does not retry internally) is transparently re-submitted once
  to a DIFFERENT replica. The request's seed/x_init ride along unchanged,
  so the hedged result is the same rows the engine would give — bitwise the
  direct call at the same dispatch shape, the engine's own contract,
  inherited. :class:`~.errors.RequestQuarantinedError` is
  terminal and never hedged: bisection already proved the request itself
  is the poison, and a hedge would just poison the next replica.

* **Replica lifecycle** — the control loop retires a replica whose health
  snapshot shows it stalled/closed/quarantine-heavy (or wedged by
  ``last_progress_s``), drains it (its queued engine tickets fail with
  ``EngineClosedError`` → the router fails them over to survivors via the
  ``router.failover`` site), and spawns a warmed replacement from the same
  ``(SamplerConfig, bucket)`` set — so zero-programs-after-warmup holds
  across replacement, per replica against its own warm.

* **Tenant QoS** — ``submit(..., tenant=, priority=)`` with weighted
  fair-share admission: with declared tenant weights, each tenant's
  admitted-but-unresolved requests are capped at
  ``max(1, max_pending * w / W)``; a flooding tenant exhausts only its own
  share (``QueueFullError``) while others keep theirs. Within the control
  loop, placement is weighted round-robin over per-tenant priority queues.

* **Sharding-blind** — the router never inspects a config beyond its
  task: every replica warms the SAME ``(SamplerConfig, bucket)`` set, so
  sequence-parallel configs (served by replicas across ranks,
  ``fleet.local_factory(model, mesh=...)``) route like any other. When it
  drains, the router calls its factory's ``close``, if it has one (the
  factory of replicas across ranks releases its followers there).

Requests carry a ``seed`` (or an ``x_init``): the port's engine draws each
start from ``torch.Generator(device).manual_seed(seed)``, and a seed is
what crosses a process boundary, so the JAX router's ``rng=`` (a PRNG key)
has no counterpart. The JAX ``compiles_after_warmup`` is
``programs_after_warmup`` here (serve/fleet.py).

Liveness contract (same as the engine's): no admitted ticket blocks
forever — every path ends in delivery or a typed failure naming the
replica it happened on.

Host-only (no torch import): routing must never touch a device tensor —
requests carry opaque seed/x_init/mask payloads straight through to the
replica's ``submit`` (editing workloads route like plain sampling; preview
frames come back through the replica ticket's preview-callback hook, host
numpy end to end).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.serve import fleet
from ddim_cold_torch.serve.batching import SamplerConfig, Ticket
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS, DeadlineExceeded,
                                          EngineClosedError, EngineStalledError,
                                          QueueFullError, RequestFailedError,
                                          RequestQuarantinedError)
from ddim_cold_torch.utils import faults


@dataclass
class _FleetRequest:
    """Router-side state of one admitted request: the frozen replica
    ``submit()`` call (hedges re-issue it verbatim — that is what keeps the
    result bitwise), plus placement history and the caller's ticket."""

    fid: int
    n: int
    tenant: str
    priority: int
    call: dict
    deadline: Optional[float]
    ticket: Ticket
    hedges: int = 0
    failovers: int = 0
    tried: set = field(default_factory=set)
    placed_on: Optional[str] = None
    resolved: bool = False
    #: obs root span of this request's trace (None with tracing disabled).
    #: Every placement attempt — hedges included — is a child of it, so the
    #: whole multi-replica life of the request shares ONE trace_id.
    span: object = None


class Router:
    """N replicas behind one ``submit()``.

    ::

        factory = fleet.local_factory(model, buckets=(8,))
        router = Router(factory, replicas=2, configs=[SamplerConfig(k=10)])
        t = router.submit(seed=0, n=4, config=SamplerConfig(k=10),
                          tenant="web", priority=1)
        imgs = t.result(timeout=60)
        router.drain()

    ``factory(replica_id)`` builds a :class:`~.fleet.ReplicaHandle`; the
    router warms each new replica with ``configs`` (× ``buckets``, default
    the replica's own) before placing onto it. ``auto_start=False`` defers
    the control loop (admission still works — deterministic QoS tests use
    this) until :meth:`start`.
    """

    def __init__(self, factory: Callable[[str], "fleet.ReplicaHandle"],
                 replicas: int = 2,
                 configs: Sequence[SamplerConfig] = (SamplerConfig(),),
                 buckets: Optional[Sequence[int]] = None, *,
                 tenants: Optional[dict] = None, default_weight: int = 1,
                 max_pending: Optional[int] = None,
                 max_hedges: int = 1, max_failovers: int = 3,
                 quarantine_limit: int = 2,
                 wedge_after_s: Optional[float] = None,
                 drain_timeout_s: float = 30.0, tick_s: float = 0.02,
                 warm_kwargs: Optional[dict] = None,
                 auto_start: bool = True):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1 or None, "
                             f"got {max_pending}")
        self._factory = factory
        self._configs = tuple(configs)
        self._buckets = tuple(buckets) if buckets is not None else None
        self._tenant_weights = dict(tenants or {})
        self._default_weight = max(1, int(default_weight))
        self.max_pending = max_pending
        self.max_hedges = int(max_hedges)
        self.max_failovers = int(max_failovers)
        self.quarantine_limit = int(quarantine_limit)
        self.wedge_after_s = wedge_after_s
        self.drain_timeout_s = float(drain_timeout_s)
        self.tick_s = float(tick_s)
        self._warm_kwargs = dict(warm_kwargs or {})
        self._lock = threading.RLock()
        # rid -> active ReplicaHandle
        self._replicas: dict = {}                       # guarded-by: _lock
        # drained handles (health still summed)
        self._retired: list = []                        # guarded-by: _lock
        self._target = int(replicas)
        # tenant -> heap of (-prio, seq, freq)
        self._queues: dict = {}                         # guarded-by: _lock
        # tenant -> admitted-unresolved count
        self._outstanding: dict = {}                    # guarded-by: _lock
        # (freq, rid, exc) failure reports
        self._events: deque = deque()                   # guarded-by: _lock
        self._seq = itertools.count()
        self._next_fid = 0                              # guarded-by: _lock
        self._next_rep = 0                              # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: obs emit handle (``router#N``): the counters the hand-rolled
        #: stats dict used to hold now live in the process metrics registry
        #: (obs/metrics.py); :attr:`stats` is a read-only view over it.
        self.metrics = metrics.scope("router")
        # the initial fleet: a spawn failure here is fatal (chaos specs
        # targeting replica.spawn at cold start surface immediately)
        for _ in range(self._target):
            self._spawn_replica()
        if auto_start:
            self.start()

    @property
    def stats(self) -> dict:
        """Legacy router counters, rendered from the metrics registry."""
        m = self.metrics
        return {
            "submitted": m.value("router.submitted"),
            "completed": m.value("router.completed"),
            "failed": m.value("router.failed"),
            "rejected": m.value("router.rejected"),
            "rejected_by_tenant": m.by_key("router.rejected_by_tenant"),
            "placements": m.value("router.placements"),
            "hedges": m.value("router.hedges"),
            "failovers": m.value("router.failovers"),
            "replicas_spawned": m.value("router.replicas_spawned"),
            "replicas_retired": m.value("router.replicas_retired"),
            "spawn_failures": m.value("router.spawn_failures"),
            "loop_errors": m.value("router.loop_errors"),
        }

    # -------------------------------------------------------------- replicas

    def _spawn_replica(self):
        """Build + warm + start one replica (the ``replica.spawn`` fault
        site fires first, so chaos can break the spawn path itself)."""
        with self._lock:
            rid = f"r{self._next_rep}"
            self._next_rep += 1
        faults.fire("replica.spawn", tag=f"replica:{rid}|")
        rep = self._factory(rid)
        # the FULL config set — a replacement replica that skipped a config
        # would build a program at its first failover ticket
        rep.warm(self._configs, self._buckets, **self._warm_kwargs)
        rep.start()
        with self._lock:
            self._replicas[rid] = rep
        self.metrics.inc("router.replicas_spawned")
        # replica lifetime span: its own trace, closed at retirement — a
        # chaos run's trace export shows exactly when each replica lived
        rep._obs_span = spans.begin("replica.lifetime", replica=rid) or None
        return rep

    def _retire(self, rid: str, rep) -> None:
        """Pull a bad replica out of rotation and drain it. Its queued
        engine tickets fail with EngineClosedError; their done-callbacks
        push failover events, which the next loop pass re-places onto
        survivors."""
        with self._lock:
            self._replicas.pop(rid, None)
            self._retired.append(rep)
        self.metrics.inc("router.replicas_retired")
        sp = getattr(rep, "_obs_span", None)
        if sp is not None:
            sp.end(retired=True)
        try:
            rep.drain(self.drain_timeout_s)
        except Exception:  # noqa: BLE001 — a broken drain must not stop
            pass           # supervision; the handle is out of rotation

    def _supervise(self) -> None:
        """Retire replicas whose snapshot shows them unhealthy, then spawn
        back up to the target count (a failed spawn leaves the deficit for
        the next tick — capped retry via the tick cadence)."""
        with self._lock:
            reps = list(self._replicas.items())
            closed = self._closed
        for rid, rep in reps:
            if rep.state in (fleet.DRAINING, fleet.CLOSED):
                # the replica left READY on its own — a subprocess handle
                # that detected its process dead self-transitions to closed
                # (crash detection), and an in-process replica can be
                # drained behind the router's back. Either way it can never
                # serve again (lifecycle is one-way): retire the
                # bookkeeping so a replacement spawns below.
                self._retire(rid, rep)
                continue
            if rep.state != fleet.READY:
                continue
            try:
                h = rep.health()
            except Exception:  # noqa: BLE001 — an unreachable replica is
                self._retire(rid, rep)  # by definition unhealthy
                continue
            wedged = (self.wedge_after_s is not None
                      and h.get("open_tickets", 0) > 0
                      and h.get("last_progress_s", 0.0) > self.wedge_after_s)
            if (h.get("stalled") or h.get("closed") or wedged
                    or h.get("quarantined", 0) >= self.quarantine_limit):
                self._retire(rid, rep)
        if closed:
            return
        while True:
            with self._lock:
                if len(self._replicas) >= self._target:
                    return
            try:
                self._spawn_replica()
            except Exception:  # noqa: BLE001 — injected or real spawn
                # failure: count it, retry on the next tick
                self.metrics.inc("router.spawn_failures")
                return

    # -------------------------------------------------------------- scaling

    @property
    def target(self) -> int:
        """The replica count supervision converges the fleet to."""
        return self._target

    def scale_to(self, n: int) -> int:
        """Move the supervision target to ``n`` (the autoscaler's one
        lever). Scale-DOWN retires the least-loaded ready replicas
        immediately (their queued tickets fail over through the normal
        eviction path — no request is lost to a scale decision);
        scale-UP is left to the next supervision tick, which already owns
        spawn-with-retry. Returns the clamped target."""
        n = max(1, int(n))
        with self._lock:
            if self._closed:
                return self._target
            self._target = n
            # excess counts READY replicas only: a crashed/DRAINING handle
            # still in the dict is already leaving (supervision retires it)
            # and must not cost an extra ready victim its place
            ready = [(rid, rep) for rid, rep in self._replicas.items()
                     if rep.state == fleet.READY]
            excess = len(ready) - n
        if excess > 0:
            scored = []
            for rid, rep in ready:
                try:
                    h = rep.health()
                except Exception:  # noqa: BLE001 — unreachable sorts first
                    scored.append((-1, rid, rep))
                    continue
                scored.append((h.get("queue_depth", 0)
                               + h.get("open_tickets", 0), rid, rep))
            scored.sort(key=lambda s: (s[0], s[1]))
            victims = [(rid, rep) for _, rid, rep in scored[:excess]]
            for rid, rep in victims:
                self._retire(rid, rep)
        self._kick.set()
        return n

    # -------------------------------------------------------------- admission

    def _weight(self, tenant: str) -> int:
        return self._tenant_weights.get(tenant, self._default_weight)

    def _share(self, tenant: str) -> Optional[int]:
        """This tenant's admitted-unresolved cap: its weighted slice of
        ``max_pending`` over the declared tenant set (an undeclared tenant
        joins at ``default_weight``). No declared tenants → one shared
        pool."""
        if self.max_pending is None:
            return None
        if not self._tenant_weights:
            return self.max_pending
        w = self._weight(tenant)
        total_w = sum(self._tenant_weights.values())
        if tenant not in self._tenant_weights:
            total_w += w
        return max(1, (self.max_pending * w) // total_w)

    def submit(self, seed: Optional[int] = None, n: int = 1, *,
               x_init=None, mask=None,
               config: Optional[SamplerConfig] = None,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None, **kwargs) -> Ticket:
        """Queue a request with the fleet; returns a :class:`Ticket` with
        the engine ticket's exact surface (``result``/``exception``/
        ``done``; timeout messages embed the ROUTER health snapshot).

        Editing workloads submit exactly like at the engine: ``config.task``
        picks the task, ``x_init`` carries its image input, ``mask=`` the
        inpaint pixel selector (see ``Engine.submit``). With
        ``config.preview_every`` set, the replica's completed preview frames
        are forwarded to THIS ticket's ``previews()`` stream — a hedged
        re-placement re-delivers its schedule, deduped per step.

        ``tenant`` scopes fair-share admission; higher ``priority`` places
        first within a tenant. Raises :class:`QueueFullError` when the
        tenant is at its share and :class:`EngineClosedError` after
        :meth:`drain`.
        """
        if config is None:
            config = SamplerConfig(**kwargs)
        elif kwargs:
            raise ValueError(
                f"pass config OR keyword options, not both: {kwargs}")
        task = config.task
        if mask is not None and task != "inpaint":
            raise ValueError(
                f"mask= is the inpaint task's input (config.task={task!r})")
        if task != "sample" and x_init is None:
            raise ValueError(f"task {task!r} needs x_init= — its image "
                             "input (see Engine.submit)")
        if task == "inpaint" and mask is None:
            raise ValueError("inpaint needs mask= (binary, 1 = known pixel)")
        if x_init is not None:
            x_init = np.asarray(x_init, np.float32)
            if task != "interp":
                # interp keeps the caller's n (the path length); everything
                # else takes its row count from the batch input
                n = x_init.shape[0] if x_init.ndim == 4 else 1
        needs_key = (task in ("inpaint", "draft", "interp")
                     or (task == "sample" and x_init is None))
        if needs_key and seed is None:
            raise ValueError("this request's init/noise draw is keyed — "
                             "pass seed=")
        n = int(n)
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        call = {"seed": seed, "n": n, "x_init": x_init, "mask": mask,
                "config": config}
        with self._lock:
            if self._closed:
                raise EngineClosedError(
                    "router is drained — no new requests accepted")
            share = self._share(tenant)
            if share is not None:
                cur = self._outstanding.get(tenant, 0)
                total = sum(self._outstanding.values())
                if cur >= share or total >= self.max_pending:
                    self.metrics.inc("router.rejected")
                    self.metrics.inc("router.rejected_by_tenant", key=tenant)
                    raise QueueFullError(
                        f"tenant {tenant!r} at its fair share "
                        f"({cur}/{share} of max_pending={self.max_pending}, "
                        f"weight {self._weight(tenant)}) — request rejected; "
                        "other tenants keep their share")
            ticket = Ticket(n)
            ticket._health_cb = self.health
            freq = _FleetRequest(fid=self._next_fid, n=n, tenant=tenant,
                                 priority=int(priority), call=call,
                                 deadline=deadline, ticket=ticket)
            self._next_fid += 1
            if spans.enabled():
                # ONE trace per fleet request: every placement attempt —
                # hedges and failovers included — is a child of this span
                freq.span = spans.begin("router.request", fid=freq.fid,
                                        tenant=tenant, n=n) or None
                ticket.span = freq.span
            self._enqueue(freq)
            self._outstanding[tenant] = self._outstanding.get(tenant, 0) + 1
        self.metrics.inc("router.submitted")
        self._kick.set()
        return ticket

    def _enqueue(self, freq: _FleetRequest) -> None:  # requires: _lock
        heapq.heappush(self._queues.setdefault(freq.tenant, []),
                       (-freq.priority, next(self._seq), freq))

    # -------------------------------------------------------------- placement

    def _candidates(self, freq: _FleetRequest) -> list:
        """Healthy replicas, least-loaded first; replicas this request
        already failed on are skipped while an untried one exists (the
        hedge must land somewhere else)."""
        with self._lock:
            cands = [(rid, rep) for rid, rep in self._replicas.items()
                     if rep.state == fleet.READY]
        fresh = [(rid, rep) for rid, rep in cands if rid not in freq.tried]
        if fresh:
            cands = fresh
        scored = []
        for rid, rep in cands:
            try:
                h = rep.health()
            except Exception:  # noqa: BLE001 — unreachable ≠ placeable;
                continue       # supervision will retire it
            if h.get("stalled") or h.get("closed"):
                continue
            if h.get("quarantined", 0) >= self.quarantine_limit:
                continue
            load = h.get("queue_depth", 0) + h.get("open_tickets", 0)
            scored.append((load, rid, rep))
        scored.sort(key=lambda s: (s[0], s[1]))
        return [(rid, rep) for _, rid, rep in scored]

    def _try_place(self, freq: _FleetRequest) -> bool:
        """One placement attempt over the healthy candidates. Returns True
        when the queue entry is consumed (placed OR terminally failed);
        False leaves the request for the next tick."""
        if freq.deadline is not None:
            remaining = freq.deadline - time.perf_counter()
            if remaining <= 0:
                self._fail_freq(freq, DeadlineExceeded(
                    f"request {freq.fid} (tenant {freq.tenant!r}) missed "
                    "its deadline while queued at the router"))
                return True
        for rid, rep in self._candidates(freq):
            try:
                faults.fire(
                    "router.place",
                    tag=f"replica:{rid}|freq:{freq.fid}|"
                        f"tenant:{freq.tenant}|")
            except RETRYABLE_EXCEPTIONS:
                continue  # transient placement fault: next candidate
            except Exception as exc:  # noqa: BLE001 — injected permanent
                # placement fault: this request cannot be routed
                err = RequestFailedError(
                    f"placement of request {freq.fid} onto replica {rid!r} "
                    f"failed: {exc!r}")
                err.__cause__ = exc
                self._fail_freq(freq, err)
                return True
            deadline_s = None
            if freq.deadline is not None:
                deadline_s = max(0.0,
                                 freq.deadline - time.perf_counter())
            # per-attempt child span: the replica's engine parents ITS
            # request span under this ctx, so a hedged ticket's attempts
            # share one trace across replicas (freq.call stays untouched —
            # hedges re-issue it verbatim)
            att = (freq.span.child("router.attempt", replica=rid)
                   if freq.span is not None else None)
            try:
                t = rep.submit(deadline_s=deadline_s,
                               trace=att.ctx if att is not None else None,
                               **freq.call)
            except (QueueFullError, EngineClosedError):
                if att is not None:
                    att.end(outcome="backpressure")
                continue  # replica-level backpressure: next candidate
            except RETRYABLE_EXCEPTIONS:
                # transient boundary failure (unreachable RPC replica,
                # dropped frame): the request is NOT consumed — try the
                # next candidate, supervision decides the replica's fate
                if att is not None:
                    att.end(outcome="unreachable")
                continue
            except Exception as exc:  # noqa: BLE001 — a replica whose
                # submit breaks outright cannot hold the request
                if att is not None:
                    att.end(outcome="submit_error")
                err = RequestFailedError(
                    f"replica {rid!r} rejected request {freq.fid}: {exc!r}")
                err.__cause__ = exc
                self._fail_freq(freq, err)
                return True
            freq.tried.add(rid)
            freq.placed_on = rid
            self.metrics.inc("router.placements")
            if freq.call["config"].preview_every:
                # forward completed replica frames to the router ticket;
                # its per-step dedupe absorbs a hedge's re-delivery
                t.add_preview_callback(
                    lambda step, frames, f=freq:
                        f.ticket._preview(step, 0, f.n, frames))
            t.add_done_callback(
                lambda t_, f=freq, r=rid, a=att: self._on_ticket(f, r, t_, a))
            return True
        return False  # no healthy candidate right now: stay queued

    def _place_round(self) -> None:
        """Weighted round-robin placement: each pass gives every tenant
        with queued work up to ``weight`` placements, until nothing can be
        placed (no healthy replica, or queues empty)."""
        progress = True
        while progress and not self._stop.is_set():
            progress = False
            with self._lock:
                tenants = sorted(t for t, q in self._queues.items() if q)
            for tenant in tenants:
                for _ in range(self._weight(tenant)):
                    with self._lock:
                        q = self._queues.get(tenant)
                        if not q:
                            break
                        _, _, freq = heapq.heappop(q)
                    if freq.resolved:
                        continue
                    if self._try_place(freq):
                        progress = True
                    else:
                        with self._lock:
                            self._enqueue(freq)
                        break

    # ---------------------------------------------------- outcome handling

    def _on_ticket(self, freq: _FleetRequest, rid: str, t: Ticket,
                   att=None) -> None:
        """Done-callback of a placed engine ticket (runs on the replica's
        worker thread — keep it cheap: deliveries resolve inline, failures
        queue an event for the control thread's hedging logic)."""
        if t.failed:
            if att is not None:
                att.end(outcome="failed")
            with self._lock:
                self._events.append((freq, rid, t.exception(0)))
            self._kick.set()
            return
        if att is not None:
            att.end(outcome="completed")
        self._complete(freq, t.result(0))

    def _complete(self, freq: _FleetRequest, rows) -> None:
        with self._lock:
            if freq.resolved:
                return
            freq.resolved = True
            self._outstanding[freq.tenant] -= 1
        if freq.ticket._deliver(0, freq.n, rows):
            self.metrics.inc("router.completed")
            if freq.span is not None:
                freq.span.end(hedges=freq.hedges, failovers=freq.failovers)

    def _fail_freq(self, freq: _FleetRequest, exc: BaseException) -> None:
        with self._lock:
            if freq.resolved:
                return
            freq.resolved = True
            self._outstanding[freq.tenant] -= 1
        if freq.ticket._fail(exc):
            self.metrics.inc("router.failed")
            if freq.span is not None:
                freq.span.end(error=type(exc).__name__,
                              hedges=freq.hedges, failovers=freq.failovers)

    def _drain_events(self) -> None:
        while True:
            with self._lock:
                if not self._events:
                    return
                freq, rid, exc = self._events.popleft()
            self._handle_failure(freq, rid, exc)

    def _handle_failure(self, freq: _FleetRequest, rid: str,
                        exc: BaseException) -> None:
        """Decide a failed placement's fate: hedge (retryable cause, once),
        fail over (the replica died under it), or fail through with the
        replica-naming error."""
        if freq.resolved:
            return
        if isinstance(exc, RequestQuarantinedError):
            # bisection proved the REQUEST is the poison — hedging it would
            # just quarantine it again on the next replica
            self._fail_freq(freq, exc)
            return
        cause = exc.__cause__ if exc.__cause__ is not None else exc
        retryable = isinstance(exc, RETRYABLE_EXCEPTIONS) \
            or isinstance(cause, RETRYABLE_EXCEPTIONS)
        evicted = isinstance(exc, (EngineClosedError, EngineStalledError))
        if retryable and freq.hedges < self.max_hedges:
            kind = "hedge"
            freq.hedges += 1
            self.metrics.inc("router.hedges")
        elif evicted and freq.failovers < self.max_failovers:
            kind = "failover"
            freq.failovers += 1
            self.metrics.inc("router.failovers")
        else:
            self._fail_freq(freq, exc)
            return
        if self._closed:
            # no re-placement after drain started — fail through typed
            self._fail_freq(freq, exc)
            return
        try:
            faults.fire("router.failover",
                        tag=f"replica:{rid}|freq:{freq.fid}|kind:{kind}|")
        except Exception as fexc:  # noqa: BLE001 — injected failover fault:
            # the re-placement path itself is broken, fail through
            err = RequestFailedError(
                f"fleet {kind} of request {freq.fid} away from replica "
                f"{rid!r} failed: {fexc!r}")
            err.__cause__ = fexc
            self._fail_freq(freq, err)
            return
        with self._lock:
            freq.placed_on = None
            self._enqueue(freq)
        self._kick.set()

    # ---------------------------------------------------------- control loop

    def start(self) -> None:
        """Start the control loop (idempotent). Placement, hedging,
        supervision, and replacement all happen here — one thread, so
        replica bookkeeping needs no cross-thread coordination."""
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._loop, name="router",
                                            daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.tick_s)
            self._kick.clear()
            try:
                self._drain_events()
                self._supervise()
                self._place_round()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive anything; a dead loop would strand every ticket
                self.metrics.inc("router.loop_errors")

    # ------------------------------------------------------------- shutdown

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful fleet shutdown: stop admission, let the control loop
        finish placing/hedging what is in flight (bounded by ``timeout``),
        drain every replica, then fail anything still queued with
        :class:`EngineClosedError`. Returns the final health snapshot."""
        with self._lock:
            self._closed = True
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        while True:
            with self._lock:
                busy = (any(self._queues.values())
                        or any(c > 0 for c in self._outstanding.values())
                        or bool(self._events))
            if not busy:
                break
            if deadline is not None and time.perf_counter() > deadline:
                break
            self._kick.set()
            time.sleep(self.tick_s)
        self._stop.set()
        self._kick.set()
        thread = self._thread
        if thread is not None:
            thread.join(5.0)
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            try:
                rep.drain(self.drain_timeout_s)
            except Exception:  # noqa: BLE001 — best-effort shutdown
                pass
            sp = getattr(rep, "_obs_span", None)
            if sp is not None:
                sp.end(retired=False)
        close = getattr(self._factory, "close", None)
        if close is not None:  # the factory's own resources, after its replicas
            close()
        # replica drains may have produced final failure events; with the
        # fleet closed, _handle_failure fails them through typed
        self._drain_events()
        with self._lock:
            leftovers = [f for q in self._queues.values() for _, _, f in q]
            for q in self._queues.values():
                q.clear()
        for freq in leftovers:
            self._fail_freq(freq, EngineClosedError(
                f"router drained with request {freq.fid} "
                f"(tenant {freq.tenant!r}) still queued"))
        return self.health()

    def close(self) -> dict:
        return self.drain(self.drain_timeout_s)

    # --------------------------------------------------------------- health

    def health(self) -> dict:
        """Fleet snapshot: per-replica health (active AND retired — a
        retired replica's program counter still counts against the fleet
        zero-program contract), queue/outstanding by tenant, and the
        router's own counters. ``programs_after_warmup`` sums every
        replica's per-own-warm count, replacement included."""
        with self._lock:
            reps = list(self._replicas.items())
            retired = [(r.replica_id, r) for r in self._retired]
            pending = {t: len(q) for t, q in self._queues.items() if q}
            outstanding = {t: c for t, c in self._outstanding.items() if c}
            closed = self._closed
        rep_health = {}
        programs_after_warmup = 0
        for rid, rep in reps + retired:
            try:
                h = rep.health()
            except Exception:  # noqa: BLE001 — an unreachable replica
                h = {"state": rep.state, "unreachable": True}
            rep_health[rid] = h
            programs_after_warmup += h.get("programs_after_warmup", 0)
        return {
            "replicas": rep_health,
            "active_replicas": len(reps),
            "retired_replicas": len(retired),
            "pending_by_tenant": pending,
            "outstanding_by_tenant": outstanding,
            "closed": closed,
            "programs_after_warmup": programs_after_warmup,
            **self.stats,
        }
