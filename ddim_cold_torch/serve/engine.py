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
architecture) that ``SamplerConfig(student=True)`` selects. A config runs on
a variant keyed by ``(quant, fused, student)`` (JAX ``_model_for`` and
``_params_for``), built once: a :meth:`DiffusionViT.clone` loaded with
``assign=True``, so it shares the weight set's tensors rather than copying
them. The quant variants of a weight set share one int8 state, built from
its float weights on the first quant config that needs it;
``stats["param_bytes"]`` and ``stats["param_bytes_quant"]`` report the
teacher's two states. Configs never coalesce across variants.

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

Sequence-parallel configs (``sp_degree > 1``) raise
``NotImplementedError`` at ``submit`` naming their ROADMAP.md item: the
JAX engine builds a ``(data, seq)`` mesh over one controller's devices,
and in the port, one process per device, an engine spanning ranks is a
design of its own (item 14).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import traceback
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ddim_cold_torch.data.loader import background_map
from ddim_cold_torch.obs import device as obs_device
from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.ops import _build, quant, sampling, step_cache
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            Ticket, plan_batches)
from ddim_cold_torch.serve.errors import (RETRYABLE_EXCEPTIONS, DeadlineExceeded,
                                          EngineClosedError, EngineStalledError,
                                          QueueFullError, RequestFailedError,
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


def refuse_unported(config: SamplerConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the port so far."""
    if config.sp_degree > 1:
        raise NotImplementedError(
            f"SamplerConfig(sp_degree={config.sp_degree}) is not ported yet: "
            "ROADMAP.md Queue 1 item 14 (a multi-rank engine: sequence "
            "parallelism across processes)")


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
    """

    def __init__(self, model, params=None, buckets: Sequence[int] = (8, 32, 128),
                 *, student_params=None, prefetch_depth: int = 2, inflight: int = 2,
                 max_queue: Optional[int] = None, max_retries: int = 2,
                 retry_base_s: float = 0.05, retry_cap_s: float = 1.0,
                 stall_s: Optional[float] = None, replica_id: str = "",
                 device=None):
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
        # the assembly thread's stream (CUDA only; on the CPU it computes)
        self._side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                      else None)
        self._programs: dict = {}
        self._spare_caches: dict = {}  # (bucket, kind) -> a step cache
        self._variants: dict = {}     # (quant, fused, student) -> model variant
        self._qstates: dict = {}      # student -> that weight set's int8 state
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
        refuse_unported(config)
        if config.student and self.student_params is None:
            raise ValueError(_NO_STUDENT)
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

    def _model_for(self, config: SamplerConfig):
        """The model a config's programs run: the float model, or its
        ``(quant, fused, student)`` variant, built once."""
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

    def _build_program(self, config: SamplerConfig):
        """The sampler call of a config, taking the batch's inputs in
        assembly order: x, then the task's extras, then (cached configs)
        the cache, which it returns beside the images."""
        model = self._model_for(config)
        seq = config.preview_every > 0
        if config.cached:
            return self._build_cached_program(model, config, seq)
        kw = dict(return_sequence=seq, device=self.device)
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
    def _build_cached_program(model, config: SamplerConfig, seq: bool):
        """The cached loop of a config (JAX ``_ddim_cached_spec``,
        ``_ddim_cached_tel_spec``, ``_fewstep_cached_spec``,
        ``_cold_cached_spec``, ``_inpaint_cached_spec``), taking the batch's
        inputs and its cache."""
        kw = dict(cache_interval=config.cache_interval, cache_mode=config.cache_mode,
                  cache_threshold=config.cache_threshold,
                  cache_tokens=config.cache_tokens or None)
        ddim = dict(k=config.k, t_start=config.t_start, eta=0.0, **kw)
        if config.task == "inpaint":
            return lambda x, known, mask, cache: sampling._ddim_cached_impl(
                model, x, None, cache, sequence=seq, known=known, mask=mask, **ddim)
        if config.sampler == "cold":
            return lambda x, cache: sampling._cold_cached_impl(
                model, x, cache, levels=config.levels, return_sequence=seq, **kw)
        if config.steps > 0:
            return lambda x, cache: sampling._fewstep_cached_impl(
                model, x, None, cache, steps=config.steps, t_start=config.t_start,
                eta=0.0, sequence=seq, **kw)
        return lambda x, cache: sampling._ddim_cached_impl(
            model, x, None, cache, sequence=seq, telemetry=config.telemetry, **ddim)

    def ensure_program(self, config: SamplerConfig, bucket: int):
        """The program for one (config, bucket) pair — the only place one is
        built, counted in ``stats["programs"]``; the ``serve.compile`` fault
        site fires only when one is built."""
        key = (config, bucket)
        prog = self._programs.get(key)
        if prog is None:
            refuse_unported(config)
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

    def run_program(self, config: SamplerConfig, bucket: int, xs: tuple):
        """Run the (config, bucket) program on a batch's inputs. A cached
        program takes the spare cache of its (bucket, kind) and gives it
        back. Returns the images, or ``(images, StepTelemetry)`` for a
        telemetry config."""
        prog = self.ensure_program(config, bucket)
        if not config.cached:
            return prog(*xs)
        out = prog(*xs, self._take_cache(bucket, config))
        self._recycle_cache(bucket, config, out[1])
        return (out[0], out[2]) if config.telemetry else out[0]

    # ---------------------------------------------------------- cache pool

    @staticmethod
    def _cache_kind(config: SamplerConfig) -> str:
        """Pool key suffix: delta, full and token share the two-tensor
        (B, N+1, E) cache ("pair"; every schedule refreshes at step 0
        before it reads one), adaptive adds ``x_ref`` and has its own."""
        return "adaptive" if config.cache_mode == "adaptive" else "pair"

    def _take_cache(self, bucket: int, config: SamplerConfig):
        cache = self._spare_caches.pop((bucket, self._cache_kind(config)), None)
        if cache is None:
            H, W = self.model.img_size
            cache = step_cache.init_cache(
                bucket, self.model.num_patches + 1, self.model.embed_dim,
                self.model.dtype, mode=config.cache_mode,
                img_shape=(H, W, self.model.in_chans), device=self.device)
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

    def _dispatch(self, plan: BatchPlan, xs: tuple):
        self.ensure_program(plan.config, plan.bucket)
        self._mark(f"dispatch bucket={plan.bucket}")
        t0 = spans.now() if spans.enabled() else 0.0
        faults.fire("serve.dispatch", tag=self._tag(plan))
        out = self.run_program(plan.config, plan.bucket, xs)
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
                return self._dispatch(plan, xs)
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
        ``_lock``, so each request is failed or served exactly once."""
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
