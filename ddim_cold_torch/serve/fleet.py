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

**Replicas across ranks** (``local_factory(model, mesh=mesh)``, JAX's
``mesh=``): every replica is an ``Engine(mesh=mesh)`` over the mesh's
ranks, one process per device. Rank 0 of the mesh hosts the
:class:`~.router.Router` and every replica's leading engine
(:class:`MeshReplica`); each other rank runs :func:`follow_replicas`,
which mirrors each replica's lifecycle over one gloo control group of the
fleet: rank 0 sends ``spawn`` (both build the engine, in the same order on
every rank, so the engines' own process groups line up), ``warm`` (the
configs and buckets: both warm), ``close`` (after rank 0 drained or
retired the replica: the follower's thread returns) and ``stop`` (the
router drained: both destroy every replica engine's process groups, then
the control group, and the follower returns its reports). A follower
serves each warmed replica from a thread of its own running
``Engine.follow()``, so two replicas serve at once on the same ranks, each
on its own groups. ``torch.distributed`` names a group by its ranks and
the number of groups alive, so group creation must run in one order on
every rank (each spawn holds the fleet's lock on rank 0 from its message
to its last group built), and a group destroyed while the fleet still
spawns would lend its name to a later one while another group holds it:
groups are destroyed only at ``stop``, their rendezvous keys deleted
first (:meth:`_Control.close`). Rank 0's waits on the control group are bounded
by ``stall_s``: a follower rank that is gone fails each replica's open
tickets with ``RankLostError`` naming the replica (the engine's own
behaviour), the supervisor retires it, and a replacement's spawn raises
within ``stall_s`` instead of hanging in group creation. The router stays
mesh-blind: it warms every replica with the same configs, sp ones
included, and calls the factory's ``close`` when it drains.

One name differs from the JAX package: the port builds programs, it does
not compile them (``Engine.stats["programs"]``), so the JAX handle's
``compiles_after_warmup`` and ``warmup_compiles`` are
``programs_after_warmup`` and ``warmup_programs`` here, on the handle and
in every health dict.

Host-only at import: torch, the engine and warmup are imported inside
the functions that use them.
"""

from __future__ import annotations

import pickle
import threading
import time
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


def local_factory(model, params=None, *, mesh=None,
                  **engine_kwargs) -> Callable[[str], LocalReplica]:
    """Factory of in-process replicas for :class:`~.router.Router`:
    ``factory(replica_id)`` builds an Engine (with that id threaded into
    its fault tags and failure messages) wrapped in a started-on-demand
    :class:`LocalReplica`. All replicas share the caller's ``model`` (one
    weight footprint for N replicas); ``params``, an optional float
    state_dict, is loaded into it once, here, before any replica serves.
    ``engine_kwargs`` go to every Engine (``buckets``, ``device``,
    ``max_queue``, ``stall_s``, ...).

    ``mesh`` (JAX's ``mesh=``): every replica is an ``Engine(mesh=mesh)``
    across the mesh's ranks (module docstring). Rank 0 of the mesh calls
    this and builds the router; every other rank calls
    :func:`follow_replicas` with the same model, mesh and ``engine_kwargs``
    at the same time (the fleet's control group is created here). Then the
    replicas serve ``sp_degree > 1`` configs; without a mesh a replica's
    engine is one process and refuses them at warmup."""
    if params is not None:
        model.load_state_dict(params, strict=True)
    if mesh is not None:
        return _MeshFactory(model, mesh, engine_kwargs)

    def factory(replica_id: str) -> LocalReplica:
        from ddim_cold_torch.serve.engine import Engine

        return LocalReplica(Engine(model, replica_id=replica_id,
                                   **engine_kwargs))
    return factory


# ------------------------------------------------------ replicas across ranks

#: the fleet's lifecycle messages, in the order a replica meets them
SPAWN, WARM, CLOSE, STOP = "spawn", "warm", "close", "stop"


def _stall_bound(engine_kwargs: dict) -> Optional[float]:
    """The ``stall_s`` a replica's engine resolves (None: unbounded)."""
    from ddim_cold_torch.utils.platform import resolve_device, watchdog_stall_s

    stall = engine_kwargs.get("stall_s")
    if stall is None:
        stall = watchdog_stall_s("DDIM_COLD_SERVE_STALL_S", 900.0,
                                 resolve_device(engine_kwargs.get("device")))
    return float(stall) if stall and stall > 0 else None


class _Control:
    """The fleet's control channel: one gloo group over the mesh's ranks on
    which rank 0 broadcasts each lifecycle message (a length, then the
    pickled ``(op, replica_id, payload)``) and the other ranks receive them
    in order. Rank 0's waits are bounded by ``bound`` seconds; a follower
    waits as long as rank 0 lives (its closed socket ends the wait)."""

    def __init__(self, mesh, bound: Optional[float]):
        from ddim_cold_torch.parallel import mesh as pmesh
        from ddim_cold_torch.serve.engine import _FOREVER_S

        self.ranks = pmesh.mesh_ranks(mesh)
        self.leader = self.ranks[0]
        self.bound = bound
        self.group = pmesh.local_group(self.ranks, _FOREVER_S, backend="gloo")
        self.lost: Optional[BaseException] = None

    def _broadcast(self, t, timeout: Optional[float]) -> None:
        import torch.distributed as dist

        from ddim_cold_torch.parallel import mesh as pmesh

        pmesh.wait(dist.broadcast(t, src=self.leader, group=self.group,
                                  async_op=True), timeout)

    def send(self, op: str, replica_id: str = "", payload=None) -> None:
        """Rank 0: one message to every other rank; raises
        :class:`~.errors.RankLostError` when a rank is gone (at once once
        one was)."""
        import torch

        from ddim_cold_torch.serve.errors import RankLostError

        if self.lost is not None:
            raise RankLostError(f"the fleet's ranks are out of reach since "
                                f"{self.lost!r}: no replica can be {op}ed")
        data = pickle.dumps((op, replica_id, payload))
        try:
            self._broadcast(torch.tensor([len(data)], dtype=torch.int64), self.bound)
            self._broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                            self.bound)
        except Exception as exc:  # noqa: BLE001 — a lost rank, typed here
            self.lost = exc
            raise RankLostError(
                f"a rank of the fleet did not take its {op} of replica "
                f"{replica_id!r} ({type(exc).__name__}: "
                f"{(str(exc).splitlines() or [''])[0][:200]})") from exc

    def receive(self) -> tuple:
        """A follower: the next ``(op, replica_id, payload)``."""
        import torch

        size = torch.zeros(1, dtype=torch.int64)
        self._broadcast(size, None)
        buf = torch.empty(int(size), dtype=torch.uint8)
        self._broadcast(buf, None)
        return pickle.loads(buf.numpy().tobytes())

    def close(self, engines: list) -> None:
        """Destroy every process group of ``engines`` and then the control
        group, every rank at once: rank 0 first deletes every group's
        rendezvous keys (:func:`_forget_rendezvous`), one barrier on the
        control group (rank 0's wait bounded, and passed over when a rank is
        gone) holds every rank until it has, then each rank destroys its
        groups. So no rank builds a group of a freed name while a stale key
        stands."""
        import torch.distributed as dist

        from ddim_cold_torch.parallel import mesh as pmesh

        groups = list(dict.fromkeys(g for engine in engines
                                    for g in engine.process_groups()))
        leader = dist.get_rank() == self.leader
        if leader:
            for group in [*groups, self.group]:
                _forget_rendezvous(group)
        try:
            pmesh.wait(dist.barrier(group=self.group, async_op=True),
                       self.bound if leader else None)
        except Exception:  # noqa: BLE001 — a rank that is gone: destroy ours anyway
            pass
        for group in [*groups, self.group]:
            dist.destroy_process_group(group)


def _forget_rendezvous(group) -> None:
    """Delete the store keys ``group``'s creation left (every rank's
    addresses). ``torch.distributed`` names a local group by its ranks and
    the number of groups alive, so once ``group`` is destroyed a later
    group of the same ranks may take its name, and would read the closed
    addresses under it."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    store = distributed_c10d._get_default_store()
    prefix = f"{group.group_name}/"
    try:
        keys = [k for k in store.list_keys() if k.startswith(prefix)]
    except (AttributeError, RuntimeError):  # a store that cannot list: gloo's keys
        keys = [f"{prefix}/{dev}//0/{r}" for dev in ("cpu", "cuda")
                for r in range(dist.get_world_size(group))]
    for key in keys:
        store.delete_key(key)


class _MeshFactory:
    """Rank 0's factory of replicas across ranks (:func:`local_factory`
    with ``mesh``): each call sends ``spawn`` and builds the leading engine;
    :meth:`close` (the router's drain) sends ``stop``."""

    def __init__(self, model, mesh, engine_kwargs: dict):
        self.model, self.mesh = model, mesh
        self.engine_kwargs = dict(engine_kwargs)
        self.control = _Control(mesh, _stall_bound(self.engine_kwargs))
        #: held from a lifecycle message to its last group built
        self.lock = threading.Lock()
        self._closed = False
        self._engines: list = []  # every replica's engine, released at close

    def __call__(self, replica_id: str) -> "MeshReplica":
        from ddim_cold_torch.serve.engine import Engine

        with self.lock:
            self.control.send(SPAWN, replica_id)
            engine = Engine(self.model, mesh=self.mesh, replica_id=replica_id,
                            **self.engine_kwargs)
            self._engines.append(engine)
        return MeshReplica(engine, self)

    def close(self) -> None:
        """Release the followers (``stop``), every replica engine's process
        groups and the control group (once); the router calls it after
        every replica drained."""
        with self.lock:
            if self._closed:
                return
            self._closed = True
            try:
                self.control.send(STOP)
            except Exception:  # noqa: BLE001 — the followers are gone already
                pass
            self.control.close(self._engines)


class MeshReplica(LocalReplica):
    """Rank 0's handle of a replica across ranks: a :class:`LocalReplica`
    whose warm and drain also reach the replica's followers (``warm``,
    ``close``); its engine's process groups go at the factory's
    ``close``."""

    def __init__(self, engine, factory: _MeshFactory, **kwargs):
        super().__init__(engine, **kwargs)
        self._factory = factory
        self._closed_on_followers = False

    def warm(self, configs, buckets=None, **kwargs) -> dict:
        try:
            with self._factory.lock:
                self._factory.control.send(
                    WARM, self.replica_id, (tuple(configs), buckets, dict(kwargs)))
                return super().warm(configs, buckets, **kwargs)
        except BaseException:
            self.close()
            raise

    def drain(self, timeout: Optional[float] = None) -> dict:
        report = super().drain(timeout)
        with self._factory.lock:
            if not self._closed_on_followers:
                self._closed_on_followers = True
                try:
                    self._factory.control.send(CLOSE, self.replica_id)
                except Exception:  # noqa: BLE001 — a lost follower: nothing to close
                    pass
        return report


def follow_replicas(model, params=None, *, mesh, **engine_kwargs) -> dict:
    """The loop of every rank of ``mesh`` but the first while rank 0 runs a
    fleet of replicas across it (:func:`local_factory` with ``mesh``): the
    same ``model``, ``mesh`` and ``engine_kwargs`` as rank 0's factory.
    Builds each replica's engine when rank 0 spawns it, warms it when rank
    0 does, serves it from a thread of its own (``Engine.follow()``) until
    rank 0 closes it, and when the router drains destroys every replica's
    process groups and returns:
    ``{"replicas": {replica_id: {"warm": ..., "follow": ..., "error":
    ...}}, "order": [(op, replica_id), ...]}``, each replica's warmup report
    (its ``programs``), its ``follow()`` report (batches, failed batches,
    programs built after warmup) and the last exception of its own, if
    any. Raises :class:`~.errors.RankLostError` when rank 0 is gone."""
    from ddim_cold_torch.serve.engine import Engine
    from ddim_cold_torch.serve.errors import RankLostError
    from ddim_cold_torch.serve.warmup import warmup

    if params is not None:
        model.load_state_dict(params, strict=True)
    control = _Control(mesh, _stall_bound(engine_kwargs))
    bound = control.bound
    live: dict = {}      # replica_id -> (engine, thread or None)
    engines: list = []   # every engine built, released at stop
    reports: dict = {}
    order: list = []

    def serve(replica_id: str, engine) -> None:
        try:
            reports[replica_id]["follow"] = engine.follow()
        except Exception as exc:  # noqa: BLE001 — reported
            reports[replica_id]["error"] = repr(exc)

    try:
        while True:
            try:
                op, replica_id, payload = control.receive()
            except Exception as exc:  # noqa: BLE001 — rank 0 is gone
                raise RankLostError(f"rank {control.leader} of the fleet is gone "
                                    f"({type(exc).__name__})") from exc
            order.append((op, replica_id))
            if op == STOP:
                break
            rep = reports.setdefault(replica_id, {"warm": None, "follow": None,
                                                  "error": None})
            try:
                if op == SPAWN:
                    engine = Engine(model, mesh=mesh, replica_id=replica_id,
                                    **engine_kwargs)
                    engines.append(engine)
                    live[replica_id] = (engine, None)
                elif op == WARM:
                    engine, _ = live[replica_id]
                    configs, buckets, kwargs = payload
                    rep["warm"] = warmup(engine, configs, buckets, **kwargs)
                    thread = threading.Thread(target=serve, args=(replica_id, engine),
                                              name=f"follow-{replica_id}", daemon=True)
                    live[replica_id] = (engine, thread)
                    thread.start()
                elif op == CLOSE:
                    _, thread = live.pop(replica_id, (None, None))
                    if thread is not None:
                        thread.join(bound)
            except Exception as exc:  # noqa: BLE001 — rank 0 meets it in step
                rep["error"] = repr(exc)
    finally:
        deadline = time.monotonic() + (bound or 0.0)
        for _, thread in live.values():
            if thread is not None:
                thread.join(max(0.0, deadline - time.monotonic()))
        # a follow() still wedged in a collective keeps the groups it waits on
        wedged = any(t is not None and t.is_alive() for _, t in live.values())
        control.close([] if wedged else engines)
    return {"replicas": reports, "order": order}
