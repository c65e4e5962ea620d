"""Bucketed sampler server: the core plan → assemble → dispatch → fetch loop.

Counterpart of ``ddim_cold_tpu/serve/engine.py`` (its core loop only).
Requests queue through :meth:`Engine.submit`; :meth:`Engine.run` coalesces
them per :class:`~ddim_cold_torch.serve.batching.SamplerConfig` into the
static bucket sizes (``plan_batches``), builds each padded batch, enqueues
the DDIM loop on the device, and copies results back while the next batch
computes: PyTorch launches asynchronously, so the only host wait is each
batch's fetch, and up to two batches stay enqueued ahead of it.

A program is one warmed (config, bucket) pair: the sampler call the engine
dispatches for that batch shape, on the model variant of the config.
:func:`ddim_cold_torch.serve.warmup.warmup` builds and loads the kernel
libraries and runs every program once, and ``stats["programs"]`` counts the
pairs built; after warmup, serving adds none.

**Quantized and fused configs.** The engine holds one float model. A
``SamplerConfig(quant=…, fused=…)`` runs on a variant of it, built once per
``(quant, fused)`` pair (JAX ``_model_for``): a :meth:`DiffusionViT.clone`
loaded with ``assign=True``, so it shares the float model's tensors rather
than copying them. Every quant variant shares one int8 state, built from the
float weights on the first quant config (JAX ``_params_for``);
``stats["param_bytes"]`` and ``stats["param_bytes_quant"]`` report the two
states' sizes. A quant or fused config is a different program: it never
coalesces with a float one (``plan_batches`` groups by config).

**Bitwise contract.** A fresh start is drawn at the request's own ``n`` from
``torch.Generator(device).manual_seed(seed)`` (it cannot reproduce the JAX
package's bits; parity with JAX runs through ``x_init``). Every sampler row
is computed independently of its batchmates, but cuBLAS and MKL pick their
GEMM algorithms by the row count M, so an engine row is bitwise equal to a
direct :func:`~ddim_cold_torch.ops.sampling.ddim_sample` call only AT THE
SAME DISPATCH SHAPE (the same padded bucket batch); across buckets the
contract is allclose.

Configs outside this slice (cached, sequence-parallel,
few-step, student, editing tasks, cold, previews, telemetry) raise
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

from ddim_cold_torch.ops import _build, quant, sampling
from ddim_cold_torch.serve.batching import (BatchPlan, Request, SamplerConfig,
                                            Ticket, plan_batches)
from ddim_cold_torch.serve.errors import RequestFailedError
from ddim_cold_torch.utils.platform import resolve_device
from ddim_cold_torch.utils.profiling import latency_summary

#: batches kept enqueued on the device ahead of the one being fetched
_INFLIGHT = 2


def refuse_unported(config: SamplerConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside this slice."""
    later = [
        (config.sampler == "cold", "sampler='cold'", "Queue 1 item 4 (cold_sample)"),
        (config.cached, f"cache_interval={config.cache_interval}",
         "Queue 1 item 8 (step cache)"),
        (config.sp_degree > 1, f"sp_degree={config.sp_degree}",
         "Queue 1 item 14 (sequence parallelism)"),
        (config.steps > 0, f"steps={config.steps}", "Queue 1 item 9 (few-step)"),
        (config.student, "student=True", "Queue 1 item 9 (few-step)"),
        (config.task != "sample", f"task={config.task!r}",
         "Queue 1 item 10 (editing workloads)"),
        (config.preview_every > 0, f"preview_every={config.preview_every}",
         "Queue 1 item 10 (previews)"),
        (config.telemetry, "telemetry=True", "Queue 1 item 8 (telemetry)"),
    ]
    for hit, what, item in later:
        if hit:
            raise NotImplementedError(
                f"SamplerConfig({what}) is not ported yet: ROADMAP.md {item}")


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
    ``submit`` is thread-safe; ``run`` drains the queue.
    """

    def __init__(self, model, params=None, buckets: Sequence[int] = (8, 32, 128),
                 *, device=None):
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
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self._programs: dict = {}
        self._variants: dict = {}     # (quant, fused) -> model variant
        self._qstate: Optional[dict] = None  # the shared int8 state
        self._lock = threading.Lock()
        self._pending: list[Request] = []               # guarded-by: _lock
        self._next_rid = 0                              # guarded-by: _lock
        self._stats = {"programs": 0, "dispatches": 0, "rows": 0,
                       "padded_rows": 0, "failed_tickets": 0,
                       "max_queue_depth": 0,
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
               x_init=None, config: Optional[SamplerConfig] = None,
               **kwargs) -> Ticket:
        """Queue a sampling request; returns its :class:`Ticket`.

        Fresh starts pass ``seed`` (the engine draws ``n`` images from
        ``torch.Generator(device).manual_seed(seed)``); guided starts pass
        ``x_init``, an (n, H, W, C) or (H, W, C) array (pair it with
        ``t_start`` for the ``sample_from`` path). Sampler options go in
        ``config`` or as keyword arguments.
        """
        if config is None:
            config = SamplerConfig(**kwargs)
        elif kwargs:
            raise ValueError(f"pass config OR keyword options, not both: {kwargs}")
        refuse_unported(config)
        if x_init is not None:
            x_init = np.asarray(x_init, np.float32)
            if x_init.ndim == 3:
                x_init = x_init[None]
            H, W = self.model.img_size
            if x_init.shape[1:] != (H, W, self.model.in_chans):
                raise ValueError(f"x_init must be (n, {H}, {W}, "
                                 f"{self.model.in_chans}), got {x_init.shape}")
            n = x_init.shape[0]
            seed = None
        elif seed is None:
            raise ValueError("a fresh start is drawn from a seed — pass seed= "
                             "or x_init=")
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        req = Request(config=config, n=int(n), key=seed, x_init=x_init,
                      ticket=Ticket(n))
        with self._lock:
            req.rid = self._next_rid
            self._next_rid += 1
            self._pending.append(req)
            self._stats["max_queue_depth"] = max(self._stats["max_queue_depth"],
                                                 len(self._pending))
        return req.ticket

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

    def _quant_state(self) -> dict:
        """The int8 state every quant variant loads, built once."""
        if self._qstate is None:
            self._qstate = quant.quantize_state_dict(self.model.state_dict())
            with self._lock:
                self._stats["param_bytes_quant"] = quant.param_bytes(self._qstate)
        return self._qstate

    def _model_for(self, config: SamplerConfig):
        """The model a config's programs run: the float model, or its
        ``(quant, fused)`` variant, built once."""
        if config.quant is None and not config.fused:
            return self.model
        key = (config.quant, config.fused)
        model = self._variants.get(key)
        if model is None:
            model = self.model.clone(quant=config.quant, fused=config.fused)
            state = (self._quant_state() if config.quant is not None
                     else self.model.state_dict())
            model.load_state_dict(state, strict=True, assign=True)
            self._variants[key] = model
        return model

    def ensure_program(self, config: SamplerConfig, bucket: int):
        """The program for one (config, bucket) pair — the only place one is
        built, counted in ``stats["programs"]``."""
        key = (config, bucket)
        prog = self._programs.get(key)
        if prog is None:
            refuse_unported(config)
            prog = functools.partial(sampling.ddim_sample, self._model_for(config),
                                     k=config.k, t_start=config.t_start,
                                     device=self.device)
            self._programs[key] = prog
            self._count("programs")
        return prog

    # -------------------------------------------------------------- stages

    def _request_init(self, req: Request) -> torch.Tensor:
        """The request's whole start, drawn once at its own n; batches take
        row slices of it."""
        if req._x_full is None:
            if req.x_init is not None:
                req._x_full = torch.as_tensor(req.x_init, device=self.device)
            else:
                H, W = self.model.img_size
                gen = torch.Generator(device=self.device).manual_seed(int(req.key))
                req._x_full = torch.randn((req.n, H, W, self.model.in_chans),
                                          generator=gen, device=self.device,
                                          dtype=torch.float32)
        return req._x_full

    def _assemble(self, plan: BatchPlan) -> torch.Tensor:
        parts = [self._request_init(req)[lo:hi] for req, lo, hi, _ in plan.entries]
        if plan.padded_rows:
            parts.append(torch.zeros((plan.padded_rows,) + parts[0].shape[1:],
                                     dtype=torch.float32, device=self.device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def _dispatch(self, plan: BatchPlan) -> torch.Tensor:
        prog = self.ensure_program(plan.config, plan.bucket)
        out = prog(x_init=self._assemble(plan))
        with self._lock:
            self._stats["dispatches"] += 1
            self._stats["rows"] += plan.rows
            self._stats["padded_rows"] += plan.padded_rows
        return out

    def _finish(self, plan: BatchPlan, out: torch.Tensor) -> None:
        """One blocking device → host copy per batch; rows land in each
        ticket, padding rows are never read."""
        host = out.cpu().numpy()
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

    def _finish_safe(self, plan: BatchPlan, out: torch.Tensor) -> None:
        try:
            self._finish(plan, out)
        except Exception as exc:  # noqa: BLE001 — fails this batch only
            self._fail_plan(plan, exc, "fetch")
