"""Bucketed sampler server: the core plan → assemble → dispatch → fetch loop.

Counterpart of ``ddim_cold_tpu/serve/engine.py`` (its core loop, the
sampler families, the step cache and its telemetry, the editing tasks,
previews and the student weight set).
Requests queue through :meth:`Engine.submit`; :meth:`Engine.run` coalesces
them per :class:`~ddim_cold_torch.serve.batching.SamplerConfig` into the
static bucket sizes (``plan_batches``), builds each padded batch, enqueues
the sampler loop on the device, and copies results back while the next
batch computes: PyTorch launches asynchronously, so the only host wait is
each batch's fetch, and up to two batches stay enqueued ahead of it.

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
is allclose.

Sequence-parallel configs (``sp_degree > 1``) raise
``NotImplementedError`` at ``submit`` naming their ROADMAP.md item. Fault
injection, retries, bisection, deadlines, the watchdog, the metrics
registry, spans and the prefetch thread come with the robustness and
observability slices.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ddim_cold_torch.obs import device as obs_device
from ddim_cold_torch.ops import _build, quant, sampling, step_cache
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            Ticket, plan_batches)
from ddim_cold_torch.serve.errors import RequestFailedError
from ddim_cold_torch.utils.platform import resolve_device
from ddim_cold_torch.utils.profiling import latency_summary
from ddim_cold_torch.workloads import preview as workload_preview
from ddim_cold_torch.workloads import tasks as workload_tasks

#: batches kept enqueued on the device ahead of the one being fetched
_INFLIGHT = 2
#: per-task batch inputs that ride along with x through assembly, in the
#: program's positional order after x: sliced per request row range and
#: zero-padded like x (inpaint: the known image, (n, H, W, C), and the
#: mask, (n, H, W, 1))
_EXTRA_INPUTS = {"inpaint": ("known", "mask")}
_NO_STUDENT = ("config.student=True but this engine holds no student tree — "
               "pass student_params= at construction (the distilled "
               "weight set's state_dict)")


def _need_seed(seed) -> int:
    if seed is None:
        raise ValueError("this request's init/noise draw is keyed — pass seed=")
    return int(seed)


def refuse_unported(config: SamplerConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the port so far."""
    if config.sp_degree > 1:
        raise NotImplementedError(
            f"SamplerConfig(sp_degree={config.sp_degree}) is not ported yet: "
            "ROADMAP.md Queue 1 item 14 (sequence parallelism)")


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
    ``submit`` is thread-safe; ``run`` drains the queue.
    """

    def __init__(self, model, params=None, buckets: Sequence[int] = (8, 32, 128),
                 *, student_params=None, device=None):
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
        # the distilled weight set, on the engine's device: its variants
        # load it with assign=True and share these tensors
        self.student_params = (None if student_params is None else
                               {k: torch.as_tensor(v).to(self.device)
                                for k, v in student_params.items()})
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self._programs: dict = {}
        self._spare_caches: dict = {}  # (bucket, kind) -> a step cache
        self._variants: dict = {}     # (quant, fused, student) -> model variant
        self._qstates: dict = {}      # student -> that weight set's int8 state
        self._lock = threading.Lock()
        self._pending: list[Request] = []               # guarded-by: _lock
        self._next_rid = 0                              # guarded-by: _lock
        self._stats = {"programs": 0, "dispatches": 0, "rows": 0,
                       "padded_rows": 0, "failed_tickets": 0,
                       "max_queue_depth": 0, "preview_frames": 0,
                       "param_bytes": quant.param_bytes(model.state_dict()),
                       "param_bytes_quant": None}      # guarded-by: _lock
        self._latencies: list[float] = []

    @property
    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats, latencies_s=list(self._latencies))

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._stats[key] += by

    # ---------------------------------------------------------------- submit

    def submit(self, seed: Optional[int] = None, n: int = 1, *,
               x_init=None, mask=None, config: Optional[SamplerConfig] = None,
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
        req = Request(config=config, n=int(n), key=key, x_init=x_init,
                      ticket=Ticket(n), extras=extras)
        with self._lock:
            req.rid = self._next_rid
            self._next_rid += 1
            self._pending.append(req)
            self._stats["max_queue_depth"] = max(self._stats["max_queue_depth"],
                                                 len(self._pending))
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
                with self._lock:
                    self._stats["param_bytes_quant"] = quant.param_bytes(qstate)
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
        built, counted in ``stats["programs"]``."""
        key = (config, bucket)
        prog = self._programs.get(key)
        if prog is None:
            refuse_unported(config)
            prog = self._programs[key] = self._build_program(config)
            self._count("programs")
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

    def _assemble(self, plan: BatchPlan) -> tuple:
        """The padded bucket batch: x first, then the task's extras, each
        request's rows sliced in and zero rows appended (a padding row's
        mask is 0, so the inpaint projection leaves it alone). A
        batch-coupled (adaptive) plan pads with replicas of its row 0
        instead: they evolve as row 0 does, so the gate's batch max is the
        unpadded batch's (JAX engine.py:731)."""
        inputs = [[self._request_init(req)[lo:hi] for req, lo, hi, _ in plan.entries]]
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

    def _dispatch(self, plan: BatchPlan):
        out = self.run_program(plan.config, plan.bucket, self._assemble(plan))
        with self._lock:
            self._stats["dispatches"] += 1
            self._stats["rows"] += plan.rows
            self._stats["padded_rows"] += plan.padded_rows
        return out

    def _finish(self, plan: BatchPlan, out) -> None:
        """One blocking device → host copy per batch; rows land in each
        ticket, padding rows are never read. A preview config's output is
        the trajectory: its scheduled intermediate frames go to each
        ticket's previews first, then the last frame is the result. A
        telemetry config's step aux is summarised once and set on every
        ticket of the batch before its rows are delivered."""
        config = plan.config
        if config.telemetry:
            out, tel = out
        host = out.cpu().numpy()
        if config.telemetry:
            summary = obs_device.summarize(
                obs_device.StepTelemetry(tel.branch, tel.drift.cpu().numpy()),
                cache_interval=config.cache_interval, cache_mode=config.cache_mode,
                cache_threshold=config.cache_threshold or 0.0,
                cache_tokens=config.cache_tokens)
            for req in {id(r): r for r, *_ in plan.entries}.values():
                req.ticket.telemetry = summary
        every = config.preview_every
        if every:
            for j in workload_preview.preview_indices(host.shape[0] - 1, every):
                for req, lo, hi, offset in plan.entries:
                    if req.ticket._preview(j, lo, hi, host[j, offset:offset + (hi - lo)]):
                        self._count("preview_frames")
            host = host[-1]
        for req, lo, hi, offset in plan.entries:
            if req.ticket._deliver(lo, hi, host[offset:offset + (hi - lo)]):
                self._latencies.append(req.ticket.latency_s)

    def _fail_plan(self, plan: BatchPlan, exc: BaseException, stage: str) -> None:
        for req in {id(r): r for r, *_ in plan.entries}.values():
            err = RequestFailedError(f"batch {stage} failed for request "
                                     f"{req.rid} (bucket {plan.bucket}): {exc!r}")
            err.__cause__ = exc
            if req.ticket._fail(err):
                self._count("failed_tickets")

    # ------------------------------------------------------------------ run

    def run(self) -> dict:
        """Drain the queue; returns this drain's report (throughput over real
        rows: padding is excluded from img/s)."""
        t0 = time.perf_counter()
        s0 = self.stats
        n_lat0 = len(self._latencies)
        rows = padded = batches = 0
        while True:
            with self._lock:
                pending, self._pending = self._pending, []
            if not pending:
                break
            inflight: deque = deque()
            for plan in plan_batches(pending, self.buckets):
                try:
                    inflight.append((plan, self._dispatch(plan)))
                except Exception as exc:  # noqa: BLE001 — fails this batch only
                    self._fail_plan(plan, exc, "dispatch")
                    continue
                batches += 1
                rows += plan.rows
                padded += plan.padded_rows
                while len(inflight) > _INFLIGHT:
                    self._finish_safe(*inflight.popleft())
            while inflight:
                self._finish_safe(*inflight.popleft())
        wall = time.perf_counter() - t0
        s1 = self.stats
        return {
            "batches": batches,
            "rows": rows,
            "padded_rows": padded,
            "wall_s": wall,
            "img_per_sec": rows / wall if wall > 0 else 0.0,
            "latency": latency_summary(self._latencies[n_lat0:]),
            "programs": s1["programs"] - s0["programs"],
            "max_queue_depth": s1["max_queue_depth"],
            "failed_tickets": s1["failed_tickets"] - s0["failed_tickets"],
        }

    def _finish_safe(self, plan: BatchPlan, out) -> None:
        try:
            self._finish(plan, out)
        except Exception as exc:  # noqa: BLE001 — fails this batch only
            self._fail_plan(plan, exc, "fetch")
