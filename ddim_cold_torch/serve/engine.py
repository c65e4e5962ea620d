"""Bucketed sampler server: the core plan → assemble → dispatch → fetch loop.

Counterpart of ``ddim_cold_tpu/serve/engine.py`` (its core loop, the
sampler families, the step cache and its telemetry, the editing tasks,
previews and the student weight set).
Requests queue through :meth:`Engine.submit`; :meth:`Engine.run` coalesces
them per :class:`~ddim_cold_torch.serve.batching.SamplerConfig` into the
static bucket sizes (``plan_batches``), builds each padded batch, enqueues
the sampler loop on the device, and copies results back while the next
batch computes: PyTorch launches asynchronously, so the only host wait is
each batch's fetch, and up to ``inflight`` batches stay enqueued ahead of
it. Batch assembly (each request's start drawn at its own n, row slices,
padding) runs ``prefetch_depth`` batches ahead in a background thread
(``data.loader.background_map``). On CUDA that thread enqueues its work on
a side stream and records an event; the dispatching stream waits on the
event before the batch is used, and every assembled tensor is
``record_stream``'d on it, so the caching allocator keeps its memory until
the sampler is done with it (as ``data.loader.device_prefetch`` does for
host batches). Each request draws from its own ``torch.Generator``, so the
assembly thread shares none with the dispatching thread.

A program is one warmed (config, bucket) pair: the sampler call the engine
dispatches for that batch shape, on the model variant of the config. The
config picks the sampler: ``task="inpaint"`` the inpaint loop (the known
image and the mask ride the batch as extra inputs, zero-padded like x),
``sampler="cold"`` the cold loop, ``steps > 0`` the few-step loop, else the
k-strided DDIM loop; ``preview_every > 0`` the same loop returning its whole
trajectory. :func:`ddim_cold_torch.serve.warmup.warmup` builds and loads the
kernel libraries and runs every program once, and ``stats["programs"]``
counts the pairs built; after warmup, serving adds none.

**Editing tasks** (``ddim_cold_torch.workloads``): each request's start is
built at its own n by the same init functions the direct ``workloads.*``
calls use (draft: the forward-noised draft; interp: the slerp of the
encoded endpoint pair, ``n`` being the path length; inpaint: fresh noise;
superres: the caller's upsampled low-res input, no seed). A preview config
delivers every ``preview_every``-th intermediate x̂0 through
``Ticket.previews()`` (``workloads.preview_indices``), then the last frame
as the result.

**Variants.** The engine holds one float model, and optionally a second,
distilled float weight set (``student_params``, a state_dict of the same
architecture) that ``SamplerConfig(student=True)`` selects. A config runs
on a variant keyed by ``(quant, fused, student)`` (JAX ``_model_for`` and
``_params_for``), built once: a :meth:`DiffusionViT.clone` loaded with
``assign=True``, so it shares the weight set's tensors rather than copying
them (an sp config's variant is that one ``sp_clone``d, below). The quant
variants of a weight set share one int8 state, built from its float weights
on the first quant config that needs it; ``stats["param_bytes"]`` and
``stats["param_bytes_quant"]`` report the teacher's two states. Configs
never coalesce across variants.

**Step cache** (``SamplerConfig(cache_interval > 1)``, every sampler and
task): a cached program takes its cache as an argument and hands it back
(``sampling._*_cached_impl``). The engine keeps one spare cache per
(bucket, kind), ``"pair"`` for delta, full and token, ``"adaptive"`` for the
three-tensor adaptive cache (JAX ``_cache_kind``): a batch takes it, the
sampler overwrites it in place, and it goes back to the pool, so serving
allocates no cache after warmup (``prewarm_cache``). The schedule's step 0
always refreshes, so the contents a batch finds are never read. An
adaptive batch is coupled (its gate reduces over the batch with a max):
its request rides alone and its padding rows are replicas of its row 0,
which leave the max unchanged. A telemetry config's step aux is decoded
once per batch (``obs.device.summarize``) into ``Ticket.telemetry``
before the rows are delivered.

**Bitwise contract.** A seeded request's randomness is drawn at its own
``n`` from ``torch.Generator(device).manual_seed(seed)`` (it cannot
reproduce the JAX package's bits; parity with JAX runs through ``x_init``).
Every sampler row is computed independently of its batchmates, but cuBLAS
and MKL pick their GEMM algorithms by the row count M, so an engine row is
bitwise equal to the direct sampler or ``workloads.*`` call only AT THE SAME
DISPATCH SHAPE (the same padded bucket batch); across buckets the contract
is allclose. The assembly thread computes the same values the dispatching
thread would, a retry re-runs the same inputs, and a bisected half runs at
its parent's bucket: a row that completes is bitwise the direct call on the
batch it was dispatched in.

**Failure isolation** (the JAX engine's robustness layer). Every pipeline
stage (assembly → dispatch → fetch → preview) is wrapped so an exception
fails only the tickets of the batch it struck; the engine keeps serving.
Retryable faults (``errors.RETRYABLE_EXCEPTIONS``) get capped exponential
backoff; a batch that fails deterministically is BISECTED on request
boundaries: each half is re-assembled at the SAME bucket (so recovery
builds no program and keeps each survivor's dispatch shape) and
re-dispatched until the poisoned request is isolated and quarantined
(:class:`~.errors.RequestQuarantinedError`, the stage exception as cause).
Admission control bounds the queue (``max_queue`` →
:class:`~.errors.QueueFullError` at submit), and per-request deadlines are
enforced at plan AND at dispatch (:class:`~.errors.DeadlineExceeded`).
:meth:`Engine.drain` stops admission, lets a running drain flush, and fails
what is still queued; :meth:`Engine.health` is the live snapshot. A
soft-mode :class:`~ddim_cold_torch.utils.watchdog.StallWatchdog` bounds
every silent device window: on a stall it fails the open tickets
(:class:`~.errors.EngineStalledError`; results fetched before stand)
instead of hanging every waiter. Chaos injects faults at the ``serve.*``
sites (``utils/faults.py``). Counters live in the process metrics registry
(``obs/metrics.py``; ``stats`` and ``health()`` are views of the engine's
scope) and, with ``obs.spans`` tracing on, each request's stages are spans
of its trace. With faults disarmed and tracing off, a dispatch launches
exactly the kernels of its program and nothing else.

**Across ranks** (``Engine(..., mesh=mesh)``, JAX's ``mesh=``): every
batch is split over the mesh's ``data`` axis, so every bucket must divide
it. A config with ``sp_degree > 1`` runs on a ``(data, seq)`` mesh of its
degree over the engine's ranks (``parallel.submesh``, data-major as JAX's
``_sp_mesh``) with the model ``sp_clone``d onto it from its quant/fused
variant (JAX ``_model_for``): Ulysses falls back to the ring when the
heads do not divide the degree, the fused attention is gated off, the fused
Mlp still runs per token. ``sp_degree=1`` is the default config, and with
``mesh=None`` the engine is the one-process path above by identity.

JAX drives every device from one controller; the port runs one process per
device, so an engine across ranks is a rank protocol. Every rank builds the
engine on the same mesh (rank 0's weights are broadcast) and calls
:func:`~ddim_cold_torch.serve.warmup.warmup` with the same configs
(:meth:`Engine.warm`): the warmed configs are the table the other ranks can
run, every rank checks that all hold the same table (a digest compared with
an all_reduce), and every rank builds every sp degree's mesh at once. Rank 0
alone holds the queue, plans, assembles (its assembly thread issues no
collective), fires every fault site and owns the tickets. For each run of a
program (warmup's, each dispatch attempt, each bisected half) it broadcasts
a fixed int64 header (op, config index, bucket, rows, attempt) and then the
batch's inputs (``parallel.mesh.broadcast_header``, ``broadcast_tensors``);
every rank readies the program (builds it, takes its spare cache), one
all_reduce of a status flag makes the ranks agree that all are ready, and
every rank runs the program on its rows and tokens through the ``mesh=``
samplers; rank 0 reads the gathered rows. The other ranks sit in
:meth:`Engine.follow`, which returns its report when rank 0 drains (a stop
header). A rank that fails to ready a program fails the batch on rank 0 as
:class:`~.errors.RankFailedError` (no rank ran it), and retry and bisection
go on as on one process. A program that raises once it runs leaves the
other ranks inside its collectives, so nothing can run after it: it fails
the open tickets with :class:`~.errors.RankLostError`, an
:class:`~.errors.EngineStalledError`, and closes the engine, as does a
collective of the protocol that fails (a rank died) or outlives
``stall_s``, which bounds every group the engine creates (rank 0 waits in
a raising follower's collective that long). The groups are the engine's
own: it leaves the caller's mesh as it found it, and
:meth:`Engine.process_groups` names them for an owner that destroys them
(the fleet's replicas across ranks do). Every cached mode runs under
``sp_degree > 1``, the token cache included: its live tokens are one
global selection and each rank runs its block of them (``models/vit.py``).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import time
import traceback
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ddim_cold_torch.data.loader import background_map
from ddim_cold_torch.models.vit import sp_clone
from ddim_cold_torch.obs import device as obs_device
from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.ops import _build, quant, sampling, step_cache
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            Ticket, plan_batches)
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS, DeadlineExceeded,
                                          EngineClosedError, EngineStalledError,
                                          QueueFullError, RankFailedError,
                                          RankLostError, RequestFailedError,
                                          RequestQuarantinedError)
from ddim_cold_torch.utils import faults
from ddim_cold_torch.utils.platform import resolve_device, watchdog_stall_s
from ddim_cold_torch.utils.profiling import latency_summary
from ddim_cold_torch.utils.watchdog import StallWatchdog
from ddim_cold_torch.workloads import preview as workload_preview
from ddim_cold_torch.workloads import tasks as workload_tasks

#: per-task batch inputs that ride along with x through assembly, in the
#: program's positional order after x: sliced per request row range and
#: zero-padded like x (inpaint: the known image, (n, H, W, C), and the
#: mask, (n, H, W, 1))
_EXTRA_INPUTS = {"inpaint": ("known", "mask")}
_NO_STUDENT = ("config.student=True but this engine holds no student tree — "
               "pass student_params= at construction (the distilled "
               "weight set's state_dict)")

#: the rank protocol's header ops: run a program, end warmup (its status),
#: stop following
_RUN, _WARM_END, _WARM_FAILED, _STOP = 1, 2, 3, 4
#: a rank's readiness for a program: ready, or raised
_OK, _FAILED = 0, 1
#: the header group's timeout: a follower waits for rank 0's next header as
#: long as rank 0 lives (its closed socket ends the wait at once). Gloo
#: takes no "never" (0 is 0 ms, and a deadline past ~292 years overflows),
#: so a century stands for it
_FOREVER_S = 100 * 365 * 24 * 3600.0


def _detach(exc: BaseException) -> BaseException:
    """Strip the tracebacks from ``exc`` and every exception it was raised
    from or while handling, each kept as a note of its printed frames.

    A failure stored in a ticket would otherwise hold the engine frames it
    passed through, and through their locals (and each frame's caller) the
    batch's plan, hence the ticket itself, its device inputs and outputs,
    and the engine: a reference cycle that pins that device memory until
    the garbage collector happens to run."""
    seen: list = []
    stack = [exc]
    while stack:
        e = stack.pop()
        if e is None or any(e is s for s in seen):
            continue
        seen.append(e)
        if e.__traceback__ is not None:
            e.add_note("Traceback (frames released):\n"
                       + "".join(traceback.format_tb(e.__traceback__)).rstrip())
            e.__traceback__ = None
        stack += [e.__cause__, e.__context__]
    return exc


def _need_seed(seed) -> int:
    if seed is None:
        raise ValueError("this request's init/noise draw is keyed — pass seed=")
    return int(seed)


class Engine:
    """Bucketed batching sampler server over one port ``DiffusionViT``.

    ::

        eng = Engine(model, buckets=(4, 8))           # device=None → "cuda"
        warmup(eng, [SamplerConfig(k=20)])
        tickets = [eng.submit(seed=s, n=3, k=20) for s in range(4)]
        eng.run()
        imgs = tickets[0].result()   # (3, H, W, C) numpy in [0, 1]

    ``params`` is an optional state_dict loaded into ``model`` (strict);
    ``model`` must be a float, unfused model (quant and fused variants are
    built from it per config) and must already live on ``device``.
    ``student_params`` is an optional second float state_dict of the same
    architecture, the weight set ``SamplerConfig(student=True)`` serves.

    The robustness knobs take the JAX engine's names and defaults:
    ``prefetch_depth`` batches assembled ahead in the background thread,
    ``inflight`` batches enqueued ahead of the one being fetched,
    ``max_queue`` (None: unbounded) pending requests before ``submit``
    raises :class:`QueueFullError`, ``max_retries`` retries of a transient
    dispatch failure with backoff from ``retry_base_s`` doubling up to
    ``retry_cap_s``, and ``stall_s`` the watchdog's silence budget (None:
    ``DDIM_COLD_SERVE_STALL_S`` if set, else 900 s on CUDA and off on the
    CPU; 0 disarms). ``replica_id`` names the engine in fault tags,
    failure messages and :meth:`health`.
    ``submit`` is thread-safe; ``run`` drains the queue; ``drain`` closes
    admission and fails what is still queued.

    ``mesh`` (a ``DeviceMesh`` of :mod:`ddim_cold_torch.parallel`) serves
    across its ranks, one process per device (module docstring): every rank
    builds the engine and calls ``warmup`` with the same configs, then rank
    0 (the mesh's first rank) submits and runs while the others call
    :meth:`follow`::

        mesh = parallel.make_mesh({"data": world})
        eng = Engine(model, buckets=(8,), mesh=mesh)
        warmup(eng, configs)
        if eng.is_leader:
            t = eng.submit(seed=0, n=3, k=20); eng.run(); eng.drain()
        else:
            eng.follow()          # returns when rank 0 drains

    The engine runs on groups of its own over the mesh's ranks, each
    bounded by ``stall_s``; ``mesh``'s own groups are not used or changed.
    """

    def __init__(self, model, params=None, buckets: Sequence[int] = (8, 32, 128),
                 *, mesh=None, student_params=None, prefetch_depth: int = 2,
                 inflight: int = 2, max_queue: Optional[int] = None,
                 max_retries: int = 2, retry_base_s: float = 0.05,
                 retry_cap_s: float = 1.0, stall_s: Optional[float] = None,
                 replica_id: str = "", device=None):
        self.device = resolve_device(device)
        have = model.device
        if have.type != self.device.type or (
                self.device.index is not None and self.device.index != have.index):
            raise ValueError(f"model lives on {have}, engine asked for {self.device}")
        self.device = have
        if model.quant is not None or model.fused:
            raise ValueError("the engine serves a float, unfused model; pass "
                             "SamplerConfig(quant=..., fused=...) to serve its "
                             "quantized or fused variants")
        if params is not None:
            model.load_state_dict(params, strict=True)
        self.model = model
        # fleet identity: names this engine in fault tags ("replica:r0|"),
        # failure messages and the health snapshot
        self.replica_id = str(replica_id)
        self._rname = (f"replica {self.replica_id!r}" if self.replica_id
                       else "engine")
        # the distilled weight set, on the engine's device: its variants
        # load it with assign=True and share these tensors
        self.student_params = (None if student_params is None else
                               {k: torch.as_tensor(v).to(self.device)
                                for k, v in student_params.items()})
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        shards = pmesh.data_axis_size(mesh)
        bad = [b for b in self.buckets if b % shards]
        if bad:
            raise ValueError(
                f"buckets {bad} do not divide the mesh data axis ({shards}); "
                "sharded placement needs even divisibility")
        self.mesh = mesh
        self.prefetch_depth = int(prefetch_depth)
        self.inflight = max(1, int(inflight))
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.stall_s = (watchdog_stall_s("DDIM_COLD_SERVE_STALL_S", 900.0, self.device)
                        if stall_s is None else float(stall_s))
        self._init_ranks(mesh)
        # the assembly thread's stream (CUDA only; on the CPU it computes)
        self._side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                      else None)
        self._programs: dict = {}
        self._spare_caches: dict = {}  # (bucket, kind) -> a step cache
        # (quant, fused, student, sp_mode, sp_degree) -> model variant
        self._variants: dict = {}
        self._qstates: dict = {}      # student -> that weight set's int8 state
        self._sp_meshes: dict = {}    # sp_degree -> (data, seq) DeviceMesh
        self._lock = threading.Lock()
        # draws each request's start once, whichever thread assembles first
        self._init_lock = threading.Lock()
        self._pending: list[Request] = []               # guarded-by: _lock
        # rid -> unresolved Request (the stall's fail set)
        self._open: dict = {}                           # guarded-by: _lock
        self._next_rid = 0                              # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._stalled = False
        self._running = False
        self._wd: Optional[StallWatchdog] = None
        self._idle = threading.Event()
        self._idle.set()
        self._t0 = time.monotonic()
        # (monotonic time, label) of the last pipeline beacon: health()
        # reports its age, so a wedged engine shows before the watchdog fires
        self._last_mark = (self._t0, "init")
        self.quarantined: list[int] = []  # rids bisection isolated
        #: the engine's emit scope (``engine#N``) in the process metrics
        #: registry; :attr:`stats` and :meth:`health` are views of it, and
        #: warmup reports its counts under it
        self.metrics = metrics.scope("engine")
        self.metrics.gauge("engine.param_bytes", quant.param_bytes(model.state_dict()))

    @property
    def stats(self) -> dict:
        """Counters rendered from the metrics registry (``param_bytes_quant``
        is None until an int8 state is built; ``latencies_s`` is the raw
        per-ticket sample list)."""
        m = self.metrics
        return {
            "programs": m.value("engine.programs"),
            "dispatches": m.value("engine.dispatches"),
            "rows": m.value("engine.rows"),
            "padded_rows": m.value("engine.padded_rows"),
            "max_queue_depth": int(m.raw("engine.max_queue_depth") or 0),
            "preview_frames": m.value("engine.preview_frames"),
            "latencies_s": m.samples("engine.latency_s"),
            "param_bytes": m.raw("engine.param_bytes"),
            "param_bytes_quant": m.raw("engine.param_bytes_quant"),
            "retries": m.value("engine.retries"),
            "failed_batches": m.value("engine.failed_batches"),
            "failed_tickets": m.value("engine.failed_tickets"),
            "quarantined": m.value("engine.quarantined"),
            "deadline_expired": m.value("engine.deadline_expired"),
            "rejected": m.value("engine.rejected"),
            "skipped_batches": m.value("engine.skipped_batches"),
            "stalls": m.value("engine.stalls"),
        }

    # ----------------------------------------------------------------- ranks

    def _init_ranks(self, mesh) -> None:
        """The engine's ranks and its protocol's groups. With no mesh, or a
        mesh of one rank, the engine is one process. Otherwise every rank
        builds the engine's own groups over the mesh's ranks: a copy of the
        mesh (``parallel.submesh``: the programs' collectives), a group of
        the mesh's backend for the batches' inputs, both bounded by
        ``stall_s``, and a gloo group for the headers and the status
        flags (CPU tensors; a follower waits on it as long as rank 0 is
        idle, and rank 0 bounds each of its own waits by ``stall_s``);
        then every rank takes rank 0's weights (teacher and student)."""
        self._ranks = pmesh.mesh_ranks(mesh) if mesh is not None else None
        self._multi = mesh is not None and len(self._ranks) > 1
        self._leader = self._ranks[0] if mesh is not None else 0
        #: True on the rank that submits, runs and drains: the mesh's first
        self.is_leader = not self._multi or dist.get_rank() == self._leader
        self._bound = self.stall_s if self.stall_s > 0 else None
        self._lost: Optional[RankLostError] = None
        self._stopped = False
        self._table: tuple = ()   # the warmed configs: a header's config index
        self._index: dict = {}
        self._follow_errors: list = []
        if not self._multi:
            return
        shape = {axis: int(size) for axis, size in zip(mesh.mesh_dim_names,
                                                       mesh.mesh.shape)}
        self.mesh = pmesh.submesh(self._ranks, shape, device=self.device,
                                  timeout=self._bound)
        self._ctrl = pmesh.local_group(self._ranks, _FOREVER_S, backend="gloo")
        self._wire = pmesh.local_group(self._ranks, self._bound)
        tensors = list(self.model.parameters()) + list(self.model.buffers())
        if self.student_params is not None:
            tensors += [self.student_params[k] for k in sorted(self.student_params)]
        pmesh.broadcast_tensors(tensors, self._leader, self._wire)

    def process_groups(self) -> list:
        """The process groups this engine created across ranks (its mesh
        copy, the header and wire groups, every sp degree's mesh), for its
        owner to destroy once no rank runs it (the fleet's replicas across
        ranks do); empty for an engine of one process."""
        if not self._multi:
            return []
        groups = [self._ctrl, self._wire]
        for mesh in [self.mesh, *self._sp_meshes.values()]:
            groups += [mesh.get_group(axis) for axis in mesh.mesh_dim_names]
        return list(dict.fromkeys(groups))

    def _need_leader(self, what: str) -> None:
        if not self.is_leader:
            raise RuntimeError(
                f"{what} runs on rank {self._leader}, which leads this engine; "
                f"rank {dist.get_rank()} calls follow()")

    def _ctrl_max(self, values: list) -> list:
        """``values`` reduced with MAX over the engine's ranks on the header
        group, each rank's wait bounded by ``stall_s``."""
        both = torch.tensor(values, dtype=torch.int64)
        try:
            pmesh.wait(dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self._ctrl,
                                       async_op=True), self._bound)
        except Exception as exc:  # noqa: BLE001 — a lost rank, typed below
            raise self._lose(exc) from exc
        return [int(v) for v in both.tolist()]

    def _set_table(self, configs: Sequence[SamplerConfig]) -> None:
        """Add ``configs`` to the configs every rank can run: a header names
        its config by its place here. Across ranks, every rank must hold the
        same table and buckets: a digest of them is compared with an
        all_reduce, and a mismatch raises on every rank."""
        table = tuple(dict.fromkeys(self._table + tuple(configs)))
        if self._multi:
            digest = int.from_bytes(hashlib.sha256(
                repr((table, self.buckets)).encode()).digest()[:7], "big")
            high, low = self._ctrl_max([digest, -digest])
            if high != digest or -low != digest:
                raise ValueError(
                    f"the ranks of {self._rname} warm different configs or "
                    "buckets: every rank builds the engine with the same "
                    "buckets and calls warmup with the same configs")
        self._table = table
        self._index = {c: i for i, c in enumerate(table)}

    def _lost_error(self, exc: BaseException) -> RankLostError:
        reason = (str(exc).splitlines() or [""])[0][:200]
        return RankLostError(
            f"{self._rname}: its ranks can no longer run in step "
            f"({type(exc).__name__}: {reason}) — in-flight and queued tickets "
            "failed and the engine is closed; results fetched before stand")

    def _lose(self, exc: BaseException) -> RankLostError:
        """A collective of the protocol failed or outlived ``stall_s``, or a
        program raised while running (the other ranks wait in its
        collectives): the ranks can no longer run in step. Fail every open
        ticket (once), close the engine, and return the error to raise."""
        if self._lost is None:
            self._lost = self._lost_error(exc)
            self._stalled = True
            self.metrics.inc("engine.stalls", key="rank_lost")
            with self._lock:
                self._closed = True
                open_reqs = list(self._open.values())
            for req in open_reqs:
                self._fail_request(req, self._lost_error(exc))
        return self._lost_error(exc)

    def _header(self, op: int, index: int = 0, bucket: int = 0, rows: int = 0,
                attempt: int = 0) -> None:
        """Rank 0: broadcast one header to the engine's ranks."""
        try:
            pmesh.broadcast_header((op, index, bucket, rows, attempt), self._leader,
                                   self._ctrl, timeout=self._bound)
        except Exception as exc:  # noqa: BLE001 — a lost rank, typed below
            raise self._lose(exc) from exc

    def _run_lockstep(self, config: SamplerConfig, bucket: int, xs: tuple,
                      rows: int, attempt: int):
        """Rank 0's run of a program across ranks: the header and the inputs
        out, every rank's readiness agreed, the program on every rank."""
        if self._lost is not None:
            raise RankLostError(str(self._lost))
        index = self._index.get(config)
        if index is None:
            raise ValueError(
                f"{config} was not warmed on every rank of {self._rname}: an "
                "engine across ranks runs the configs warmup gave every rank")
        self._header(_RUN, index, bucket, rows, attempt)
        try:
            pmesh.broadcast_tensors(xs, self._leader, self._wire)
        except Exception as exc:  # noqa: BLE001 — a lost rank, typed below
            raise self._lose(exc) from exc
        err, ready = None, None
        try:
            ready = self._prepare(config, bucket)
        except Exception as exc:  # noqa: BLE001 — agreed on, then re-raised
            err = exc
        (failed,) = self._ctrl_max([_FAILED if err is not None else _OK])
        if failed != _OK:
            self._unprepare(config, bucket, ready)
            if err is not None:
                raise err
            raise RankFailedError(
                f"another rank of {self._rname} could not ready its part of a "
                f"batch (bucket {bucket}, config {index}, attempt {attempt}), "
                "so no rank ran it; that rank's follow() report holds the "
                "exception")
        try:
            return self._launch(config, bucket, xs, *ready)
        except Exception as exc:  # noqa: BLE001 — the ranks are out of step
            raise self._lose(exc) from exc

    def follow(self) -> dict:
        """The loop of every rank but rank 0 of an engine across ranks:
        receive each header and its inputs, ready the program, agree on
        every rank's readiness, run it on this rank's rows and tokens;
        return when rank 0 drains. Returns ``{"rank", "batches",
        "failed_batches", "programs", "new_programs", "errors"}``: the
        programs run and those no rank ran because a rank could not ready
        its part, the programs this rank has built and how many of them
        this call built (0 after a warmup that covered every config and
        bucket), and the last exceptions of this rank's own failures.
        Raises :class:`RankLostError` when rank 0 stops answering, or when
        this rank's part of a running program raises (the other ranks wait
        in its collectives until ``stall_s``)."""
        if not self._multi or self.is_leader:
            raise RuntimeError("follow() runs on the ranks after the first of an "
                               "engine across ranks (Engine(mesh=...))")
        return self._follow(_STOP)

    def _follow(self, until: int) -> dict:
        rank = dist.get_rank()
        p0 = self.metrics.value("engine.programs")
        report = {"rank": rank, "batches": 0, "failed_batches": 0}
        while True:
            try:
                op, index, bucket, _, _ = pmesh.broadcast_header(
                    None, self._leader, self._ctrl)
            except Exception as exc:  # noqa: BLE001 — rank 0 is gone
                raise self._lose(exc) from exc
            if op == until or op == _STOP:
                break
            if op == _WARM_FAILED:
                raise RuntimeError(f"warmup failed on rank {self._leader} of "
                                   f"{self._rname}; its exception says why")
            if op != _RUN:
                raise RuntimeError(f"rank {rank}: header op {op}, expected a run")
            config = self._table[index]
            xs = self.zero_inputs(config, bucket)
            try:
                pmesh.broadcast_tensors(xs, self._leader, self._wire)
            except Exception as exc:  # noqa: BLE001 — rank 0 is gone
                raise self._lose(exc) from exc
            err, ready = None, None
            try:
                ready = self._prepare(config, bucket)
            except Exception as exc:  # noqa: BLE001 — agreed on, reported
                err = exc
                self._follow_errors = (self._follow_errors + [repr(exc)])[-4:]
            (failed,) = self._ctrl_max([_FAILED if err is not None else _OK])
            if failed != _OK:
                self._unprepare(config, bucket, ready)
                report["failed_batches"] += 1
                continue
            try:
                self._launch(config, bucket, xs, *ready)
            except Exception as exc:  # noqa: BLE001 — the ranks are out of step
                self._follow_errors = (self._follow_errors + [repr(exc)])[-4:]
                raise self._lose(exc) from exc
            report["batches"] += 1
        programs = self.metrics.value("engine.programs")
        report.update(programs=programs, new_programs=programs - p0,
                      errors=list(self._follow_errors))
        return report

    def warm(self, configs: Sequence[SamplerConfig], buckets: Sequence[int], *,
             tolerate_errors: bool = False) -> dict:
        """Warmup's work (:func:`~ddim_cold_torch.serve.warmup.warmup`):
        make ``configs`` the table the engine's ranks run, build every sp
        degree's mesh (on every rank at once, across ranks), load the kernel
        libraries, then run every (config, bucket) program once on a zero
        batch, each spare cache allocated first: across ranks rank 0 runs
        them as it serves a batch while the other ranks follow, and a
        failure on rank 0 fails warmup on every rank. Returns ``{"errors":
        {(config, bucket): exception}, "sp_meshes": ...}``; with
        ``tolerate_errors`` a failing program is recorded and skipped."""
        self._set_table(configs)
        ranks = len(self._devices())
        for degree in sorted({c.sp_degree for c in configs if c.sp_degree > 1}):
            if ranks % degree == 0:  # else each of its programs raises, below
                self._sp_mesh(degree)
        errors: dict = {}
        if not self.is_leader:
            self.load_kernels(configs)
            self._follow(_WARM_END)
            return {"errors": errors, "sp_meshes": self.sp_meshes}
        ok = False
        try:
            self.load_kernels(configs)
            for config in configs:
                for bucket in buckets:
                    try:
                        self.prewarm_cache(config, bucket)
                        self.run_program(config, bucket, self.zero_inputs(config, bucket))
                    except Exception as exc:  # noqa: BLE001 — optionally isolated
                        if not tolerate_errors or isinstance(exc, RankLostError):
                            raise
                        errors[(config, bucket)] = exc
            ok = True
        finally:
            if self._multi and self._lost is None:
                self._header(_WARM_END if ok else _WARM_FAILED)
        return {"errors": errors, "sp_meshes": self.sp_meshes}

    @property
    def sp_meshes(self) -> dict:
        """The sequence-parallel meshes built: ``{degree: {axis: size}}``."""
        return {d: dict(zip(m.mesh_dim_names, m.mesh.shape))
                for d, m in self._sp_meshes.items()}

    def _send_stop(self) -> None:
        """Rank 0: release the followers (once), when nothing runs."""
        with self._lock:
            if not self._multi or self._stopped or self._lost is not None:
                return
            self._stopped = True
        try:
            self._header(_STOP)
        except RankLostError:
            pass  # the followers are gone: nothing left to release

    # ---------------------------------------------------------------- submit

    def submit(self, seed: Optional[int] = None, n: int = 1, *,
               x_init=None, mask=None, config: Optional[SamplerConfig] = None,
               deadline_s: Optional[float] = None, trace=None,
               **kwargs) -> Ticket:
        """Queue a sampling request; returns its :class:`Ticket`.

        Fresh starts pass ``seed`` (the engine draws the same start the
        direct sampler would from ``torch.Generator(device).manual_seed(seed)``);
        guided starts pass ``x_init``, an (n, H, W, C) or (H, W, C) array
        (pair it with ``t_start`` for the ``sample_from`` path). Sampler
        options go in ``config`` or as keyword arguments.

        Editing tasks (``config.task`` in ``workloads.EDIT_TASKS``) take
        their image input as ``x_init``: the known image (``inpaint``, with
        ``mask=`` selecting the pixels to preserve), the upsampled low-res
        start (``superres``, see ``workloads.superres_init``), the draft to
        forward-noise (``draft``), or the (2, H, W, C) endpoint pair
        (``interp``, where ``n`` stays the path length). ``inpaint``,
        ``draft`` and ``interp`` also need ``seed``: their noise is drawn
        exactly as the direct ``workloads.*`` call draws it.

        ``deadline_s`` bounds the request's time in the engine: past it, the
        request fails fast with :class:`DeadlineExceeded` instead of
        occupying a bucket. Raises :class:`QueueFullError` when the queue is
        at ``max_queue`` and :class:`EngineClosedError` after :meth:`drain`.
        ``trace`` (an ``obs.spans`` span or TraceContext) parents the
        request's span when tracing is on; without one the request starts a
        trace of its own.
        """
        if config is None:
            config = SamplerConfig(**kwargs)
        elif kwargs:
            raise ValueError(f"pass config OR keyword options, not both: {kwargs}")
        self._need_leader("submit")
        if config.student and self.student_params is None:
            raise ValueError(_NO_STUDENT)
        if self._multi and config not in self._index:
            raise ValueError(
                f"{config} was not warmed: an engine across ranks serves the "
                "configs warmup gave every rank")
        task = config.task
        if mask is not None and task != "inpaint":
            raise ValueError(
                f"mask= is the inpaint task's input (config.task={task!r})")
        extras = None
        if task == "sample":
            if x_init is not None:
                if config.sampler != "ddim":
                    raise ValueError(
                        "guided starts (x_init) are a DDIM path; "
                        "cold sampling has no encoded-start analogue")
                x_init = self._as_batch(x_init)
                n = x_init.shape[0]
                key = None
            else:
                key = _need_seed(seed)
        else:
            if x_init is None:
                raise ValueError(
                    f"task {task!r} needs x_init= — its image input "
                    "(inpaint: known image; superres: upsampled low-res; "
                    "draft: the draft; interp: the (2, H, W, C) endpoints)")
            x_init = self._as_batch(x_init)
            if task == "interp":
                # n stays the caller's path length; x_init is the pair
                if x_init.shape[0] != 2:
                    raise ValueError(
                        "interp x_init is the endpoint PAIR (2, H, W, C) — "
                        f"n= is the path length; got shape {x_init.shape}")
            else:
                n = x_init.shape[0]
            key = None if task == "superres" else _need_seed(seed)
            if task == "inpaint":
                if mask is None:
                    raise ValueError(
                        "inpaint needs mask= (binary, 1 = known pixel — "
                        "see workloads.normalize_mask)")
                extras = {"known": np.ascontiguousarray(x_init),
                          "mask": workload_tasks.normalize_mask(
                              mask, int(n), self.model.img_size)}
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        req = Request(config=config, n=int(n), key=key, x_init=x_init,
                      ticket=Ticket(n), deadline=deadline, extras=extras)
        req.ticket._health_cb = self.health
        with self._lock:
            if self._closed:
                raise EngineClosedError(
                    "engine is drained — no new requests accepted")
            if self.max_queue is not None and len(self._pending) >= self.max_queue:
                self.metrics.inc("engine.rejected")
                raise QueueFullError(
                    f"queue at max_queue={self.max_queue} "
                    f"({len(self._pending)} pending) — request rejected "
                    "(overload backpressure; retry later or raise max_queue)")
            req.rid = self._next_rid
            self._next_rid += 1
            self._pending.append(req)
            self._open[req.rid] = req
            depth = len(self._pending)
            self.metrics.gauge(
                "engine.max_queue_depth",
                max(int(self.metrics.raw("engine.max_queue_depth") or 0), depth))
        if spans.enabled():
            req.ticket.span = spans.begin(
                "engine.request", parent=trace, rid=req.rid, n=req.n,
                replica=self.replica_id) or None
        return req.ticket

    def _as_batch(self, x_init) -> np.ndarray:
        x_init = np.asarray(x_init, np.float32)
        if x_init.ndim == 3:
            x_init = x_init[None]
        H, W = self.model.img_size
        if x_init.ndim != 4 or x_init.shape[1:] != (H, W, self.model.in_chans):
            raise ValueError(f"x_init must be (n, {H}, {W}, {self.model.in_chans}) "
                             f"or ({H}, {W}, {self.model.in_chans}), got "
                             f"{x_init.shape}")
        return x_init

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------- programs

    def load_kernels(self, configs: Sequence[SamplerConfig] = ()) -> None:
        """Build and load the kernel libraries the float model and the
        variants of ``configs`` launch (nothing on the CPU)."""
        if self.device.type != "cuda":
            return
        libs = set(self.model.kernel_libraries())
        for config in configs:
            libs.update(self._model_for(config).kernel_libraries())
        for name in sorted(libs):
            _build.load_library(name)

    def _state_for(self, config: SamplerConfig) -> dict:
        """The state_dict a config's variant loads: the teacher's or the
        student's float weights, or that weight set's int8 state (one per
        weight set, built once)."""
        if config.student:
            if self.student_params is None:
                raise ValueError(_NO_STUDENT)
            float_state = self.student_params
        else:
            float_state = self.model.state_dict()
        if config.quant is None:
            return float_state
        qstate = self._qstates.get(config.student)
        if qstate is None:
            qstate = self._qstates[config.student] = quant.quantize_state_dict(
                float_state)
            if not config.student:
                self.metrics.gauge("engine.param_bytes_quant", quant.param_bytes(qstate))
        return qstate

    def _variant(self, config: SamplerConfig):
        """The float model, or its ``(quant, fused, student)`` variant, built
        once."""
        key = (config.quant, config.fused, config.student)
        if key == (None, False, False):
            return self.model
        model = self._variants.get(key)
        if model is None:
            state = self._state_for(config)
            model = self.model.clone(quant=config.quant, fused=config.fused)
            model.load_state_dict(state, strict=True, assign=True)
            self._variants[key] = model
        return model

    def _model_for(self, config: SamplerConfig):
        """The model a config's programs run (JAX ``_model_for``): its
        ``(quant, fused, student)`` variant, and for ``sp_degree > 1`` that
        variant ``sp_clone``d onto the degree's ``(data, seq)`` mesh, built
        once per ``(quant, fused, student, sp_mode, sp_degree)``."""
        base = self._variant(config)
        if config.sp_degree == 1:
            return base
        key = (config.quant, config.fused, config.student, config.sp_mode,
               config.sp_degree)
        model = self._variants.get(key)
        if model is None:
            # sp_clone is the one resolver of Ulysses' fallback to the ring
            model = self._variants[key] = sp_clone(
                base, self._sp_mesh(config.sp_degree), sp_mode=config.sp_mode)
        return model

    # -------------------------------------------------- sequence parallelism

    def _devices(self) -> list:
        """The ranks sp meshes are built over: the engine mesh's, else this
        process alone."""
        if self._ranks is not None:
            return list(self._ranks)
        return [dist.get_rank() if dist.is_initialized() else 0]

    def _sp_mesh(self, degree: int):
        """The ``(data, seq)`` mesh of one ``sp_degree``, built once over the
        engine's ranks (data-major: each seq group is consecutive ranks), by
        every rank at once (:meth:`warm` builds them all before any program
        runs, so no rank builds one while another waits in a collective)."""
        mesh = self._sp_meshes.get(degree)
        if mesh is None:
            ranks = self._devices()
            if len(ranks) % degree:
                raise ValueError(
                    f"sp_degree={degree} does not divide the {len(ranks)} "
                    "rank(s) of this engine — the (data, seq) mesh needs a "
                    "whole data axis; pick an sp_degree from the divisors of "
                    "the rank count (an engine spans the ranks of its mesh=)")
            mesh = self._sp_meshes[degree] = pmesh.submesh(
                ranks, {"data": len(ranks) // degree, "seq": degree},
                device=self.device, timeout=self._bound)
        return mesh

    def _mesh_for(self, config: SamplerConfig):
        """The mesh a config's programs run on: the engine's own for the
        degree-1 configs (None: one process), else the degree's."""
        if config.sp_degree == 1:
            return self.mesh
        return self._sp_mesh(config.sp_degree)

    def _build_program(self, config: SamplerConfig):
        """The sampler call of a config, taking the batch's inputs in
        assembly order: x, then the task's extras, then (cached configs)
        the cache, which it returns beside the images. On a mesh every rank
        runs its rows (and tokens) and gets the whole batch back."""
        model = self._model_for(config)
        mesh = self._mesh_for(config)
        seq = config.preview_every > 0
        if config.cached:
            return self._build_cached_program(model, config, seq, mesh)
        kw = dict(return_sequence=seq, device=self.device, mesh=mesh)
        if config.task == "inpaint":
            return functools.partial(sampling.ddim_inpaint, model, k=config.k,
                                     t_start=config.t_start, **kw)
        if config.sampler == "cold":
            fn = functools.partial(sampling.cold_sample, model,
                                   levels=config.levels, **kw)
        elif config.steps > 0:
            fn = functools.partial(sampling.ddim_sample_fewstep, model,
                                   steps=config.steps, t_start=config.t_start, **kw)
        else:
            fn = functools.partial(sampling.ddim_sample, model, k=config.k,
                                   t_start=config.t_start, **kw)
        return lambda x: fn(x_init=x)

    @staticmethod
    def _build_cached_program(model, config: SamplerConfig, seq: bool, mesh):
        """The cached loop of a config (JAX ``_ddim_cached_spec``,
        ``_ddim_cached_tel_spec``, ``_fewstep_cached_spec``,
        ``_cold_cached_spec``, ``_inpaint_cached_spec``), taking the batch's
        inputs and its cache (this rank's rows of it on a mesh)."""
        kw = dict(cache_interval=config.cache_interval, cache_mode=config.cache_mode,
                  cache_threshold=config.cache_threshold,
                  cache_tokens=config.cache_tokens or None)
        ddim = dict(k=config.k, t_start=config.t_start, eta=0.0, **kw)
        if config.task == "inpaint":
            def impl(x, known, mask, cache, rows):
                return sampling._ddim_cached_impl(
                    model, x, None, cache, sequence=seq, known=known, mask=mask,
                    rows=rows, **ddim)
        elif config.sampler == "cold":
            def impl(x, cache, rows):
                return sampling._cold_cached_impl(
                    model, x, cache, levels=config.levels, return_sequence=seq,
                    rows=rows, **kw)
        elif config.steps > 0:
            def impl(x, cache, rows):
                return sampling._fewstep_cached_impl(
                    model, x, None, cache, steps=config.steps, t_start=config.t_start,
                    eta=0.0, sequence=seq, rows=rows, **kw)
        else:
            def impl(x, cache, rows):
                return sampling._ddim_cached_impl(
                    model, x, None, cache, sequence=seq, telemetry=config.telemetry,
                    rows=rows, **ddim)

        def program(*args):
            *inputs, cache = args
            rows = sampling._data_rows(mesh, inputs[0].shape[0])
            out = impl(*(sampling._take(t, rows) for t in inputs), cache, rows)
            return (sampling._gather(out[0], rows, 1 if seq else 0),) + tuple(out[1:])
        return program

    def ensure_program(self, config: SamplerConfig, bucket: int):
        """The program for one (config, bucket) pair — the only place one is
        built, counted in ``stats["programs"]``; the ``serve.compile`` fault
        site fires only when one is built."""
        key = (config, bucket)
        prog = self._programs.get(key)
        if prog is None:
            if config.sp_degree > 1:
                shards = pmesh.data_axis_size(self._sp_mesh(config.sp_degree))
                if bucket % shards:
                    raise ValueError(
                        f"bucket {bucket} does not tile the sp config's data "
                        f"axis ({shards} = {len(self._devices())} ranks / "
                        f"sp_degree {config.sp_degree}); pick buckets that it "
                        "divides, or a larger sp_degree (which shrinks the "
                        "data axis)")
            if self.is_leader:  # rank 0 alone fires the fault sites
                faults.fire("serve.compile", tag=f"bucket:{bucket}|")
            self._mark(f"build bucket={bucket}", budget_s=4 * self.stall_s)
            prog = self._programs[key] = self._build_program(config)
            self.metrics.inc("engine.programs")
        return prog

    def zero_inputs(self, config: SamplerConfig, bucket: int) -> tuple:
        """A zero batch of ``bucket`` rows for each of the config's program
        inputs (x, then the task's extras): what warmup runs."""
        H, W = self.model.img_size
        x = torch.zeros((bucket, H, W, self.model.in_chans), device=self.device)
        if config.task != "inpaint":
            return (x,)
        return x, torch.zeros_like(x), torch.zeros((bucket, H, W, 1), device=self.device)

    def run_program(self, config: SamplerConfig, bucket: int, xs: tuple, *,
                    rows: Optional[int] = None, attempt: int = 0):
        """Run the (config, bucket) program on a batch's inputs (``rows`` of
        them real; ``attempt`` counts retries). A cached program takes the
        spare cache of its (bucket, kind) and gives it back. Returns the
        images, or ``(images, StepTelemetry)`` for a telemetry config.
        Across ranks (rank 0 only), every rank runs it in lockstep."""
        if not self._multi:
            return self._launch(config, bucket, xs, *self._prepare(config, bucket))
        self._need_leader("run_program")
        return self._run_lockstep(config, bucket, tuple(xs),
                                  bucket if rows is None else rows, attempt)

    def _prepare(self, config: SamplerConfig, bucket: int) -> tuple:
        """A program made ready to run, with no collective: ``(program,
        cache)``, the cache its (bucket, kind)'s spare (None uncached)."""
        prog = self.ensure_program(config, bucket)
        return prog, (self._take_cache(bucket, config) if config.cached else None)

    def _unprepare(self, config: SamplerConfig, bucket: int, ready) -> None:
        """Give back what :meth:`_prepare` took for a program that will not
        run (its spare cache)."""
        if ready is not None and ready[1] is not None:
            self._recycle_cache(bucket, config, ready[1])

    def _launch(self, config: SamplerConfig, bucket: int, xs: tuple, prog, cache):
        """Run a ready program; a cached one hands its cache back to the
        pool."""
        if cache is None:
            return prog(*xs)
        out = prog(*xs, cache)
        self._recycle_cache(bucket, config, out[1])
        return (out[0], out[2]) if config.telemetry else out[0]

    # ---------------------------------------------------------- cache pool

    @staticmethod
    def _cache_kind(config: SamplerConfig):
        """Pool key suffix: delta, full and token share the two-tensor
        (B, N+1, E) cache ("pair"; every schedule refreshes at step 0
        before it reads one), adaptive adds ``x_ref`` and has its own; an sp
        config's cache holds its token block on its own mesh, keyed
        ``(kind, sp_mode, sp_degree)`` (JAX ``_cache_kind``)."""
        kind = "adaptive" if config.cache_mode == "adaptive" else "pair"
        if config.sp_degree > 1:
            return (kind, config.sp_mode, config.sp_degree)
        return kind

    def _take_cache(self, bucket: int, config: SamplerConfig):
        cache = self._spare_caches.pop((bucket, self._cache_kind(config)), None)
        if cache is None:
            # this rank's rows and token block of the whole batch's cache
            model = self._model_for(config)
            H, W = self.model.img_size
            cache = step_cache.init_cache(
                bucket // pmesh.data_axis_size(self._mesh_for(config)),
                model.local_tokens, model.embed_dim, model.dtype,
                mode=config.cache_mode, img_shape=(H, W, self.model.in_chans),
                device=self.device)
        return cache

    def _recycle_cache(self, bucket: int, config: SamplerConfig, cache) -> None:
        self._spare_caches[(bucket, self._cache_kind(config))] = cache

    def prewarm_cache(self, config: SamplerConfig, bucket: int) -> None:
        """Allocate the spare cache of a cached (config, bucket) now, so no
        dispatch pays for it (warmup calls this); a no-op for an uncached
        config or when the pool already holds one of the kind."""
        if not config.cached:
            return
        key = (bucket, self._cache_kind(config))
        if key not in self._spare_caches:
            self._spare_caches[key] = self._take_cache(bucket, config)

    # -------------------------------------------------------------- stages

    def _request_init(self, req: Request) -> torch.Tensor:
        """The request's whole start, built once at its own n by the same
        init functions the direct calls use; batches take row slices of it.
        The task's extras move to the device here, once."""
        if req._x_full is None:
            dev, config = self.device, req.config
            gen = (None if req.key is None
                   else torch.Generator(device=dev).manual_seed(int(req.key)))
            if config.task == "draft":
                x = workload_tasks.draft_init(gen, req.x_init, config.t_start,
                                              self.model.total_steps)
            elif config.task == "interp":
                x = workload_tasks.interp_init(gen, req.x_init[0], req.x_init[1],
                                               req.n, config.t_start,
                                               self.model.total_steps)
            elif config.task == "inpaint":
                # fresh noise: the known image rides along as an extra
                x = sampling.fresh_start(self.model, gen, req.n, dev)
            elif req.x_init is not None:
                x = torch.as_tensor(req.x_init, device=dev)
            elif config.sampler == "cold":
                x = sampling.cold_init(self.model, gen, req.n, dev)
            else:
                x = sampling.fresh_start(self.model, gen, req.n, dev)
            if req.extras:
                req.extras = {name: torch.as_tensor(a, device=dev)
                              for name, a in req.extras.items()}
            req._x_full = x
        return req._x_full

    def _tag(self, plan: BatchPlan) -> str:
        """Fault/beacon tag: ``|``-separated fields naming the replica (when
        one is named), the bucket and every request in the batch
        (``match="req:3|"`` targets request 3)."""
        reqs = {id(req): req for req, *_ in plan.entries}
        head = f"replica:{self.replica_id}|" if self.replica_id else ""
        return (head + f"bucket:{plan.bucket}|"
                + "".join(f"req:{r.rid}|" for r in reqs.values()))

    def _build_batch(self, plan: BatchPlan) -> tuple:
        """The padded bucket batch: x first, then the task's extras, each
        request's rows sliced in and zero rows appended (a padding row's
        mask is 0, so the inpaint projection leaves it alone). A
        batch-coupled (adaptive) plan pads with replicas of its row 0
        instead: they evolve as row 0 does, so the gate's batch max is the
        unpadded batch's (JAX engine.py:731)."""
        with self._init_lock:
            inputs = [[self._request_init(req)[lo:hi]
                       for req, lo, hi, _ in plan.entries]]
        for name in _EXTRA_INPUTS.get(plan.config.task, ()):
            inputs.append([req.extras[name][lo:hi] for req, lo, hi, _ in plan.entries])
        out = []
        for parts in inputs:
            if plan.padded_rows:
                pad = (plan.padded_rows,) + parts[0].shape[1:]
                parts.append(parts[0][:1].expand(pad) if plan.config.batch_coupled
                             else torch.zeros(pad, dtype=torch.float32,
                                              device=self.device))
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=0))
        return tuple(out)

    def _assemble(self, plan: BatchPlan):
        """Assembly stage (the background thread's; bisection calls it on
        the dispatching thread). Returns ``(plan, staged)``: the batch's
        inputs and, on CUDA, the event recorded on the side stream after
        the work that builds them (:meth:`_ready` hands them over)."""
        self._mark(f"assemble bucket={plan.bucket}")
        t0 = spans.now() if spans.enabled() else 0.0
        faults.fire("serve.assemble", tag=self._tag(plan))
        if self._side is None:
            staged = (self._build_batch(plan), None)
        else:
            with torch.cuda.stream(self._side):
                xs = self._build_batch(plan)
                event = torch.cuda.Event()
                event.record(self._side)
            staged = (xs, event)
        self._record_stage(plan, "assemble", t0)
        return plan, staged

    def _assemble_safe(self, plan: BatchPlan):
        """Assembly with the exception CAPTURED, not raised: the prefetch
        generator must keep producing the other plans when one batch's
        assembly fails (a raise would end it and strand every later
        batch)."""
        try:
            plan, staged = self._assemble(plan)
            return plan, staged, None
        except Exception as exc:  # noqa: BLE001 — isolated per batch
            return plan, None, exc

    def _ready(self, staged) -> tuple:
        """The assembled inputs, safe to use on the dispatching stream: it
        waits for the side stream's event, and each tensor is recorded on it
        so the allocator does not hand its memory to the side stream's next
        batch while the sampler still reads it."""
        xs, event = staged
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in xs:
                t.record_stream(current)
        return xs

    def _record_stage(self, plan: BatchPlan, name: str, t0: float,
                      **attrs) -> None:
        """Attribute one per-batch pipeline stage to every request riding
        the batch: a closed span of the measured window under each
        request's trace. No-op with tracing disabled."""
        if not spans.enabled():
            return
        t1 = spans.now()
        for req in {id(r): r for r, *_ in plan.entries}.values():
            spans.record(req.ticket.span, name, t0, t1,
                         bucket=plan.bucket, **attrs)

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, plan: BatchPlan, xs: tuple, attempt: int = 0):
        self.ensure_program(plan.config, plan.bucket)
        self._mark(f"dispatch bucket={plan.bucket}")
        t0 = spans.now() if spans.enabled() else 0.0
        faults.fire("serve.dispatch", tag=self._tag(plan))
        out = self.run_program(plan.config, plan.bucket, xs, rows=plan.rows,
                               attempt=attempt)
        self.metrics.inc("engine.dispatches")
        self.metrics.inc("engine.rows", plan.rows)
        self.metrics.inc("engine.padded_rows", plan.padded_rows)
        self._record_stage(plan, "dispatch", t0)
        return out

    def _dispatch_retry(self, plan: BatchPlan, xs: tuple):
        """Dispatch with capped exponential backoff on the retryable fault
        class. Unlike the JAX engine's, the inputs need no rebuild between
        attempts: the port donates nothing (a sampler copies or only reads
        its start, and never writes the inpaint extras), so ``xs`` survives
        a failed attempt unchanged."""
        delay = self.retry_base_s
        for attempt in range(self.max_retries + 1):
            try:
                return self._dispatch(plan, xs, attempt)
            except RETRYABLE_EXCEPTIONS:
                if attempt == self.max_retries:
                    raise
                self.metrics.inc("engine.retries")
                time.sleep(min(delay, self.retry_cap_s))
                delay = min(delay * 2, self.retry_cap_s)
        raise AssertionError("unreachable: loop returns or raises")

    def _subplan(self, plan: BatchPlan, entries) -> BatchPlan:
        """A sub-batch of ``entries`` repacked densely at the SAME bucket:
        bisection recovery reuses the warmed program and keeps the dispatch
        shape."""
        packed, offset = [], 0
        for req, lo, hi, _ in entries:
            packed.append((req, lo, hi, offset))
            offset += hi - lo
        return BatchPlan(config=plan.config, bucket=plan.bucket,
                         entries=tuple(packed), rows=offset)

    def _dispatch_safe(self, plan: BatchPlan, xs: tuple) -> list:
        """Dispatch with full failure isolation; returns the list of
        (plan, out) that actually went to the device.

        Deadlines are re-checked here (a request can expire while earlier
        batches run): expired entries fail fast, and a batch with no live
        entry left skips the device. A deterministic batch failure bisects
        on request boundaries: halves re-assemble at the same bucket and
        recurse; a single-request batch that still fails is the poisoned
        one, quarantined with the stage exception as cause."""
        now = time.perf_counter()
        for req, *_ in plan.entries:
            if req.deadline is not None and now > req.deadline \
                    and not req.ticket.done:
                self.metrics.inc("engine.deadline_expired", key="dispatch")
                self._fail_request(req, DeadlineExceeded(
                    f"request {req.rid} missed its deadline before dispatch "
                    f"on {self._rname} (expired {now - req.deadline:.3f}s "
                    "ago waiting for a bucket) — failing fast instead of "
                    "occupying one"))
        if all(req.ticket.failed for req, *_ in plan.entries):
            self.metrics.inc("engine.skipped_batches")
            return []
        try:
            return [(plan, self._dispatch_retry(plan, xs))]
        except RankLostError:
            return []  # the engine is closed and its tickets failed
        except Exception as exc:  # noqa: BLE001 — isolate, bisect, quarantine
            self.metrics.inc("engine.failed_batches", key="dispatch")
            reqs = list({id(r): r for r, *_ in plan.entries}.values())
            if len(reqs) == 1:
                req = reqs[0]
                if not req.ticket.done:
                    err = RequestQuarantinedError(
                        f"request {req.rid} deterministically fails its "
                        f"batch (bucket {plan.bucket}) on {self._rname} — "
                        "quarantined by bisection; batchmates completed "
                        "separately")
                    err.__cause__ = exc
                    self.quarantined.append(req.rid)
                    self.metrics.inc("engine.quarantined")
                    self._fail_request(req, err)
                return []
            results = []
            mid = len(reqs) // 2
            for part in (reqs[:mid], reqs[mid:]):
                ids = {id(r) for r in part}
                sub = self._subplan(
                    plan, [e for e in plan.entries if id(e[0]) in ids])
                sub, staged, err = self._assemble_safe(sub)
                if err is not None:
                    self._fail_plan(sub, err, "assembly (bisect)")
                    continue
                results += self._dispatch_safe(sub, self._ready(staged))
            return results

    # ---------------------------------------------------------------- fetch

    def _finish(self, plan: BatchPlan, out) -> None:
        """One blocking device → host copy per batch; rows land in each
        ticket, padding rows are never read. A preview config's output is
        the trajectory: its scheduled intermediate frames go to each
        ticket's previews first, then the last frame is the result. A
        telemetry config's step aux is summarised once and set on every
        ticket of the batch before its rows are delivered. A fetch or
        preview failure fails only this batch's tickets."""
        config = plan.config
        try:
            self._mark(f"fetch bucket={plan.bucket}")
            t0 = spans.now() if spans.enabled() else 0.0
            tel = None
            if config.telemetry:
                out, tel = out
                tel = obs_device.StepTelemetry(tel.branch, tel.drift.cpu().numpy())
            host = out.cpu().numpy()
            host = faults.fire("serve.fetch", tag=self._tag(plan), payload=host)
        except Exception as exc:  # noqa: BLE001 — isolated per batch
            self._fail_plan(plan, exc, "fetch")
            return
        self._record_stage(plan, "fetch", t0)
        if tel is not None:
            summary = obs_device.summarize(
                tel, cache_interval=config.cache_interval,
                cache_mode=config.cache_mode,
                cache_threshold=config.cache_threshold or 0.0,
                cache_tokens=config.cache_tokens)
            self.metrics.inc("engine.cache_refresh_steps", summary["refreshes"])
            self.metrics.inc("engine.cache_reuse_steps", summary["reuses"])
            for req in {id(r): r for r, *_ in plan.entries}.values():
                req.ticket.telemetry = summary
        every = config.preview_every
        if every:
            try:
                t0 = spans.now() if spans.enabled() else 0.0
                faults.fire("serve.preview", tag=self._tag(plan))
                for j in workload_preview.preview_indices(host.shape[0] - 1, every):
                    for req, lo, hi, offset in plan.entries:
                        if req.ticket._preview(j, lo, hi,
                                               host[j, offset:offset + (hi - lo)]):
                            self.metrics.inc("engine.preview_frames")
            except Exception as exc:  # noqa: BLE001 — isolated per batch
                self._fail_plan(plan, exc, "preview")
                return
            self._record_stage(plan, "preview", t0)
            host = host[-1]
        for req, lo, hi, offset in plan.entries:
            if req.ticket._deliver(lo, hi, host[offset:offset + (hi - lo)]):
                self.metrics.observe("engine.latency_s", req.ticket.latency_s)
                sp = req.ticket.span
                if sp is not None:
                    sp.end(rows=req.n, latency_s=req.ticket.latency_s)
                with self._lock:
                    self._open.pop(req.rid, None)

    # -------------------------------------------------------------- failure

    def _fail_request(self, req: Request, exc: BaseException) -> None:
        with self._lock:
            self._open.pop(req.rid, None)
        if req.ticket._fail(_detach(exc)):
            self.metrics.inc("engine.failed_tickets")
            sp = req.ticket.span
            if sp is not None:
                sp.end(error=type(exc).__name__)

    def _fail_plan(self, plan: BatchPlan, exc: BaseException, stage: str) -> None:
        """Fail exactly this batch's tickets, the stage exception as cause."""
        self.metrics.inc("engine.failed_batches", key="plan")
        for req in {id(r): r for r, *_ in plan.entries}.values():
            if req.ticket.done:
                continue
            err = RequestFailedError(
                f"batch {stage} failed for request {req.rid} "
                f"(bucket {plan.bucket}, {self._rname}): {exc!r}")
            err.__cause__ = exc
            self._fail_request(req, err)

    # ----------------------------------------------------- watchdog / drain

    def _mark(self, label: str, budget_s: Optional[float] = None) -> None:
        self._last_mark = (time.monotonic(), label)
        wd = self._wd
        if wd is not None:
            wd.mark(label, budget_s)

    def _on_stall(self, label: str, silent: float) -> None:
        """Soft watchdog abort: a device interaction went silent past the
        stall budget. Fail every unresolved ticket so no waiter hangs;
        batches fetched before the stall keep their delivered results."""
        self._stalled = True
        self.metrics.inc("engine.stalls")
        err = EngineStalledError(
            f"{self._rname} made no progress for {silent:.1f}s after "
            f"{label!r} — wedged device call; in-flight and queued tickets "
            "failed, results fetched before the stall stand")
        with self._lock:
            open_reqs = list(self._open.values())
        for req in open_reqs:
            self._fail_request(req, err)

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful shutdown: stop admission (``submit`` raises
        :class:`EngineClosedError`), let an active :meth:`run` flush its
        in-flight batches, then fail everything still queued. Returns the
        final health snapshot plus ``"idle"``.

        When the idle wait TIMES OUT (``idle: False``) a :meth:`run` is
        still mid-flight, so the queued-request sweep is skipped: failing
        requests while their batches are on the device would race delivery.
        The run itself fails what it finds queued once it sees the engine
        closed. Both sides take the queue by swapping ``_pending`` under
        ``_lock``, so each request is failed or served exactly once.

        Across ranks, the drained engine releases the other ranks' ``follow``
        (a stop header), from here when idle, else from the run when it
        ends."""
        self._need_leader("drain")
        with self._lock:
            self._closed = True
        idle = self._idle.wait(timeout)
        if idle:
            with self._lock:
                pending, self._pending = self._pending, []
            for req in pending:
                self._fail_request(req, EngineClosedError(
                    f"{self._rname} drained with request {req.rid} "
                    "still queued"))
            self._send_stop()
        report = self.health()
        report["idle"] = idle
        return report

    def health(self) -> dict:
        """Live health snapshot (also rendered into a Ticket's timeout
        message): queue and engine state, the failure counters (views of the
        metrics registry) and realized fault injections by site.
        ``last_stage`` / ``stalled_for_s`` name the last pipeline beacon and
        its age."""
        with self._lock:
            depth = len(self._pending)
            open_n = len(self._open)
            mark_t, mark_label = self._last_mark
        now = time.monotonic()
        s = self.stats
        lat = latency_summary(s["latencies_s"])
        return {
            "replica": self.replica_id,
            "queue_depth": depth,
            "open_tickets": open_n,
            "latency_p50_s": lat["p50_s"],
            "latency_p95_s": lat["p95_s"],
            "latency_p99_s": lat["p99_s"],
            "max_queue": self.max_queue,
            "uptime_s": now - self._t0,
            "last_progress_s": now - mark_t,
            "last_stage": mark_label,
            "stalled_for_s": round(now - mark_t, 3),
            "running": self._running,
            "closed": self._closed,
            "stalled": self._stalled,
            "programs": s["programs"],
            "dispatches": s["dispatches"],
            "retries": s["retries"],
            "failed_batches": s["failed_batches"],
            "failed_tickets": s["failed_tickets"],
            "quarantined": s["quarantined"],
            "deadline_expired": s["deadline_expired"],
            "rejected": s["rejected"],
            "skipped_batches": s["skipped_batches"],
            "stalls": s["stalls"],
            "faults_by_site": faults.snapshot()["by_site"],
        }

    # ------------------------------------------------------------------ run

    def run(self) -> dict:
        """Drain the queue: plan → assemble (background thread) → dispatch
        → fetch, pipelined. Returns this drain's report (throughput over
        real rows: padding is excluded from img/s). Failures never escape a
        batch; with ``stall_s > 0`` a soft watchdog guards the drain."""
        self._need_leader("run")
        t0 = time.perf_counter()
        s0 = self.stats
        counters0 = {k: s0[k] for k in ("programs", "retries", "failed_tickets",
                                        "quarantined")}
        rows = padded = batches = 0
        n_lat0 = self.metrics.count("engine.latency_s")
        self._stalled = False
        self._running = True
        self._idle.clear()
        wd = None
        if self.stall_s > 0:
            wd = StallWatchdog(self.stall_s, exit_code=None,
                               on_abort=self._on_stall, name="engine")
            self._wd = wd
            wd.start()
        try:
            while not self._stalled:
                with self._lock:
                    pending, self._pending = self._pending, []
                    closed = self._closed
                if closed:
                    for req in pending:
                        self._fail_request(req, EngineClosedError(
                            f"{self._rname} drained with request {req.rid} "
                            "still queued"))
                    break
                if not pending:
                    break
                live = self._admit(pending)
                if not live:
                    continue
                self._mark(f"plan {len(live)} requests")
                tp = spans.now() if spans.enabled() else 0.0
                plans = plan_batches(live, self.buckets)
                if spans.enabled():
                    tp1 = spans.now()
                    for req in live:
                        spans.record(req.ticket.span, "plan", tp, tp1,
                                     batches=len(plans))
                inflight: deque = deque()
                with contextlib.closing(background_map(
                        plans, self._assemble_safe, self.prefetch_depth)) as assembled:
                    for plan, staged, err in assembled:
                        if self._stalled:
                            break
                        if err is not None:
                            self._fail_plan(plan, err, "assembly")
                            continue
                        for item in self._dispatch_safe(plan, self._ready(staged)):
                            inflight.append(item)
                            batches += 1
                            rows += item[0].rows
                            padded += item[0].padded_rows
                        while len(inflight) > self.inflight:
                            self._finish(*inflight.popleft())
                while inflight:
                    self._finish(*inflight.popleft())
        finally:
            self._running = False
            if wd is not None:
                wd.done()
                self._wd = None
            if self._closed:  # a drain timed out while this run was going
                self._send_stop()
            self._idle.set()
        wall = time.perf_counter() - t0
        s1 = self.stats
        return {
            "batches": batches,
            "rows": rows,
            "padded_rows": padded,
            "wall_s": wall,
            "img_per_sec": rows / wall if wall > 0 else 0.0,
            "latency": latency_summary(
                self.metrics.samples("engine.latency_s")[n_lat0:]),
            "max_queue_depth": s1["max_queue_depth"],
            "stalled": self._stalled,
            **{k: s1[k] - v0 for k, v0 in counters0.items()},
        }

    def _admit(self, pending) -> list:
        """Plan-time deadline gate: expired requests fail fast HERE, before
        they cost a bucket slot or an assembly."""
        now = time.perf_counter()
        live = []
        for req in pending:
            if req.deadline is not None and now > req.deadline:
                self.metrics.inc("engine.deadline_expired", key="plan")
                self._fail_request(req, DeadlineExceeded(
                    f"request {req.rid} missed its deadline while queued "
                    f"on {self._rname} (expired {now - req.deadline:.3f}s "
                    "before planning)"))
            else:
                live.append(req)
        return live
