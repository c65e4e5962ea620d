"""Request queue → static bucket plans (the batching half of the engine).

The port's verbatim copy of ``ddim_cold_tpu/serve/batching.py`` (host-only;
the port imports nothing of the JAX package), except that
``SeqParallelConfigError`` is defined here instead of in the JAX package's
``parallel/ulysses.py``. The planner's output is pinned equal to the JAX
package's by the tests.

A compiled program (or, on the GPU, a captured graph and a tuned kernel
set) exists per input shape, so a naive server rebuilds on every new
request count. Here requests are coalesced per sampler config and
packed row-by-row into a small static set of batch buckets (padding the last
batch with zero rows), so the engine only ever dispatches shapes it warmed.
Requests larger than the biggest bucket simply split across batches — packing is by ROW RANGE, not whole requests, which is sound because
every sampler row is computed independently of its batchmates (the trunk is
per-row: attention mixes tokens within an image, never across the batch), so
a request's rows are bitwise identical no matter which batch they ride in.

``SamplerConfig`` deliberately has no ``eta``: stochastic DDIM draws
batch-SHAPED per-step noise (``torch.randn(x.shape, generator=g)``), whose
per-row values depend on the batch size — coalescing would change every
row. Deterministic sampling (the reference's path) is what serving batches.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

_SAMPLERS = ("ddim", "cold")
_CACHE_MODES = ("delta", "full", "adaptive", "token")
_QUANT_MODES = (None, "xla", "pallas", "w8a8")  # ops/quant.py QUANT_MODES + off
#: the JAX package's workloads.TASKS, as literals
_TASKS = ("sample", "inpaint", "superres", "draft", "interp")
_SP_MODES = ("none", "ulysses", "ring")


class SeqParallelConfigError(ValueError):
    """A sequence-parallel geometry that cannot run (``sp_mode`` /
    ``sp_degree``). Subclasses ValueError, as the JAX package's class of
    the same name does."""


@dataclass(frozen=True)
class SamplerConfig:
    """Everything that selects a compiled sampler program (all statics).

    Hashable on purpose: it is half of the engine's program-cache key
    ``(config, bucket)``. Two requests share a batch iff their configs are
    equal — mixed configs never coalesce (in particular quant and non-quant
    requests never share a batch: they run different programs over different
    param trees).
    """

    sampler: str = "ddim"          # "ddim" | "cold"
    k: int = 10                    # DDIM stride (ignored by cold)
    t_start: Optional[int] = None  # guided start level (ddim only)
    levels: int = 6                # cold-diffusion levels (cold only)
    cache_interval: int = 1        # 1 = exact sampler; >1 = step cache
    cache_mode: str = "delta"      # "delta" | "full" | "adaptive" | "token"
    cache_threshold: Optional[float] = None  # "adaptive" only: drift gate τ
    # (≥ 0; 0.0 = refresh every step = bitwise exact). Static — part of the
    # compiled-program key, mirrored by ops/step_cache.cache_spec validation.
    cache_tokens: int = 0          # "token" only: static top-k live tokens
    # per reuse step (≥ 1; = num_patches+1 is bitwise exact — the model-
    # dependent upper bound is enforced at program build, not here: this
    # module is host-only and never sees the model).
    quant: Optional[str] = None    # None = float params; "xla" | "pallas" =
    # the w8a16 trunk (ops/quant.py) over the engine's int8 param tree;
    # "w8a8" additionally feeds int8 activations (per-tensor dynamic scale)
    # — FID-guard gated (eval/fid.quantized_sampler_guard)
    fused: bool = False            # fused sampler-trunk megakernels
    # (models/vit.py fused=True): qkv-dequant → flash → proj as one Pallas
    # kernel plus the fused Mlp kernel. Same param tree as unfused — but a
    # DIFFERENT compiled program, so fused and unfused requests never
    # coalesce. Requires quant != "xla" (pure-XLA mode has no kernels to
    # fuse); f32 results are bitwise the unfused program's (tests pin it).
    task: str = "sample"           # "sample" = plain generation; an editing
    # task name (ddim_cold_tpu/workloads) selects that task's init function
    # and — for "inpaint" — its per-step-constrained scan. Static: mixed
    # tasks never coalesce, and the inpaint program has a different input
    # signature (known + mask ride the batch).
    preview_every: int = 0         # 0 = final result only; m > 0 streams
    # every m-th intermediate x̂0 frame via Ticket.previews() — the engine
    # then dispatches the SEQUENCE scan variant (a distinct program, part of
    # the warmed set)
    sp_mode: str = "none"          # "none" | "ulysses" | "ring": sequence
    # parallelism for this config's programs. Off by default — the defaults
    # keep every pre-sp config hash-equal to its old self, so sp_degree=1
    # dispatches are bitwise the existing serve path by construction.
    sp_degree: int = 1             # seq-axis size of the (data, seq) mesh
    # the engine builds for this config (its local device count must divide
    # by it). Static: part of the program key — sp and non-sp requests never
    # coalesce, they run differently-sharded programs.
    telemetry: bool = False        # True: the cached DDIM scan also stacks
    # its per-step (branch, drift) aux (ops/step_cache.apply_step_tel) and
    # the engine decodes it into ``Ticket.telemetry`` (obs/device.py).
    # Static: selects a distinct compiled program (one extra warmup entry);
    # images stay bitwise identical with telemetry on or off.
    steps: int = 0                 # 0 = the k-STRIDED family above (the
    # pre-fewstep default — every existing config stays hash-equal to its
    # old self); >= 1 selects the few-step family
    # (ops/sampling.ddim_sample_fewstep): exactly ``steps`` model
    # evaluations along the proportional schedule, the distilled-student
    # serving path (k∈{1,2,4}). ``k`` is ignored when steps > 0; ``t_start``
    # still sets the schedule's start level. Static: part of the program
    # key — fewstep and stride requests never coalesce.
    student: bool = False          # route this config's dispatches through
    # the engine's distilled-student param tree (Engine(student_params=...))
    # instead of the teacher's. Purely a PARAM selection — the compiled
    # program is identical to the teacher's at the same steps (warmup dedup
    # exploits exactly that) — but student and teacher requests must never
    # share a batch, so it is part of the config (and the cache key).

    def __post_init__(self):
        if self.sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be one of {_SAMPLERS}, "
                             f"got {self.sampler!r}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.cache_interval < 1:
            raise ValueError("cache_interval must be >= 1, "
                             f"got {self.cache_interval}")
        if self.cache_mode not in _CACHE_MODES:
            raise ValueError(f"cache_mode must be one of {_CACHE_MODES}, "
                             f"got {self.cache_mode!r}")
        if self.cache_mode == "adaptive":
            if self.cache_threshold is None:
                raise ValueError(
                    "cache_mode='adaptive' needs cache_threshold=<drift "
                    "gate, ≥ 0.0> (0.0 refreshes every step — bitwise the "
                    "exact sampler)")
            if not float(self.cache_threshold) >= 0.0:  # rejects NaN too
                raise ValueError("cache_threshold must be >= 0.0, "
                                 f"got {self.cache_threshold!r}")
        elif self.cache_threshold is not None:
            raise ValueError(
                "cache_threshold is the 'adaptive' drift gate — meaningless "
                f"under cache_mode={self.cache_mode!r}")
        if self.cache_mode == "token":
            if self.cache_tokens < 1:
                raise ValueError(
                    "cache_mode='token' needs cache_tokens=<static top-k "
                    f"live tokens, >= 1>, got {self.cache_tokens}")
        elif self.cache_tokens != 0:
            raise ValueError(
                "cache_tokens is the 'token' top-k — meaningless under "
                f"cache_mode={self.cache_mode!r}")
        if self.quant not in _QUANT_MODES:
            raise ValueError(f"quant must be one of {_QUANT_MODES}, "
                             f"got {self.quant!r}")
        if self.fused and self.quant == "xla":
            raise ValueError(
                "fused=True requests the Pallas fused trunk kernels but "
                "quant='xla' explicitly opts out of Pallas — use "
                "quant='pallas' or 'w8a8' (or quant=None for the float "
                "fused Mlp alone)")
        if self.task not in _TASKS:
            raise ValueError(f"task must be one of {_TASKS}, "
                             f"got {self.task!r}")
        if self.preview_every < 0:
            raise ValueError(f"preview_every must be >= 0, "
                             f"got {self.preview_every}")
        if self.task == "superres":
            if self.sampler != "cold":
                raise ValueError(
                    "task 'superres' is the cold path (nearest-downsampling "
                    "IS the cold degradation) — pass sampler='cold' with "
                    "levels=<the input's downsampling level>")
        elif self.task != "sample":
            if self.sampler != "ddim":
                raise ValueError(f"task {self.task!r} is a DDIM path, "
                                 f"got sampler={self.sampler!r}")
            if self.task in ("draft", "interp") and self.t_start is None:
                raise ValueError(
                    f"task {self.task!r} decodes from an intermediate noise "
                    "level — t_start= is required")
        if self.sp_mode not in _SP_MODES:
            raise SeqParallelConfigError(
                f"sp_mode must be one of {_SP_MODES}, got {self.sp_mode!r}")
        if self.sp_degree < 1:
            raise SeqParallelConfigError(
                f"sp_degree must be >= 1, got {self.sp_degree}")
        if self.sp_mode == "none" and self.sp_degree != 1:
            raise SeqParallelConfigError(
                f"sp_degree={self.sp_degree} needs a strategy — pass "
                "sp_mode='ulysses' (head↔sequence all-to-all; local heads "
                "must divide by sp_degree) or sp_mode='ring' (no head "
                "constraint)")
        if self.sp_mode != "none" and self.sp_degree < 2:
            raise SeqParallelConfigError(
                f"sp_mode={self.sp_mode!r} shards the sequence over "
                "sp_degree >= 2 devices — sp_degree=1 has no seq axis; "
                "drop sp_mode (the default 'none' IS the degree-1 program)")
        if self.sp_degree > 1 and self.cached and self.cache_mode == "adaptive":
            raise SeqParallelConfigError(
                "sequence parallelism cannot compose with the batch-coupled "
                "adaptive cache: the drift gate's batch-max reduction is not "
                "psum'd over the seq axis, so the two sequence shards could "
                "take DIFFERENT refresh branches and desynchronize the "
                "carry — use cache_mode='delta'/'full'/'token' with sp, or "
                "sp_degree=1 for adaptive caching")
        if self.steps < 0:
            raise ValueError(
                f"steps must be >= 0 (0 = the k-strided family, >= 1 = the "
                f"few-step family), got {self.steps}")
        if self.student and self.steps < 1:
            raise ValueError(
                "student=True serves a few-step distilled student — pass "
                "steps=<its evaluation count, e.g. 1/2/4> (student params "
                "under the stride family would silently mis-serve a "
                "teacher-schedule request)")
        if self.steps > 0:
            if self.sampler != "ddim":
                raise ValueError(
                    "steps > 0 is the few-step DDIM family — "
                    f"got sampler={self.sampler!r}")
            if self.task != "sample":
                raise ValueError(
                    "steps > 0 serves plain generation only — task "
                    f"{self.task!r} has no few-step scan variant yet")
            if self.telemetry:
                raise ValueError(
                    "telemetry decodes the CACHED STRIDE scan's step aux — "
                    "it has no few-step variant; drop telemetry or steps")
        if self.telemetry:
            if self.sampler != "ddim" or not self.cached:
                raise ValueError(
                    "telemetry=True decodes the cached DDIM scan's step aux "
                    "— pass sampler='ddim' with cache_interval > 1")
            if self.task != "sample":
                raise ValueError(
                    "telemetry=True is the plain sampling path — task "
                    f"{self.task!r} has no telemetry scan variant")
            if self.preview_every:
                raise ValueError(
                    "telemetry and previews are separate products — the "
                    "telemetry scan is last-only (drop preview_every)")
            if self.sp_mode != "none":
                raise ValueError(
                    "telemetry does not compose with sequence parallelism — "
                    "use sp_degree=1 (default) for telemetry configs")
    @property
    def cached(self) -> bool:
        return self.cache_interval > 1

    @property
    def batch_coupled(self) -> bool:
        """True when one compiled dispatch couples its rows: the adaptive
        drift gate reduces per-row drift with a batch MAX before the
        ``lax.switch`` — a hot batchmate can force a refresh that changes
        every row's arithmetic. Coupled configs must never coalesce or split
        requests (the planner gives each request its own batch; the engine
        pads with row-0 replicas, whose drift equals row 0's and so never
        moves the max) or the bitwise-vs-direct contract breaks. Token mode
        is NOT coupled: its top-k indices are per-row, so it coalesces and
        splits freely — but its bitwise-vs-direct guarantee is per dispatch
        SHAPE (exact-bucket dispatches are bitwise the own-n direct call;
        padded dispatches are bitwise a direct call at the padded shape and
        float-level vs own-n, because the reuse step's gathered
        sub-sequence trunk compiles per batch shape and short-sequence GEMM
        tiling rounds per-row differently across shapes)."""
        return self.cached and self.cache_mode == "adaptive"


class Ticket:
    """Per-request future. The engine delivers row ranges as their batches
    come off the device (a split request completes over several batches);
    ``result()`` blocks until every row has landed — or until the request
    FAILS, in which case it re-raises the failure with the engine-stage
    exception as cause. ``done`` reflects both outcomes (a resolved error
    counts as done), so a caller that saw a ``result(timeout=)`` timeout
    can keep observing the ticket: a late-landing buffer or a late failure
    both flip ``done`` and are readable via ``result()``/``exception()``."""

    def __init__(self, n: int):
        self.n = int(n)
        self.submit_time = time.perf_counter()
        self.done_time: Optional[float] = None
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._buf: Optional[np.ndarray] = None          # guarded-by: _lock
        self._remaining = int(n)                        # guarded-by: _lock
        self._error: Optional[BaseException] = None     # guarded-by: _lock
        # resolution outcome, decided ATOMICALLY under _lock: True once the
        # ticket completed or failed. _event trails it (set in _resolve,
        # outside the lock), so first-resolution-wins races on _resolved,
        # never on the event — a _fail landing in the window between a
        # completing _deliver's lock release and its _event.set() must lose.
        self._resolved = False                          # guarded-by: _lock
        self._health_cb = None  # engine attaches its health snapshot hook
        self._callbacks: list = []                      # guarded-by: _lock
        #: obs root span for this request (obs/spans.py) — set by the engine
        #: or router at submit when tracing is enabled, else None
        self.span = None
        #: per-request step-telemetry summary (obs/device.summarize) — set
        #: at finish for SamplerConfig(telemetry=True) requests, else None
        self.telemetry: Optional[dict] = None
        # streaming previews (SamplerConfig.preview_every): per-step frame
        # assembly (a split request's preview rows land batch by batch, like
        # the result) + completed-frame history. _pcond serializes history
        # and preview-callback registration so no frame is missed or
        # double-fired; history keeps frames alive for late previews() /
        # add_preview_callback consumers.
        self._pcond = threading.Condition()
        # step -> [frame buffer, rows remaining]
        self._pbuf: dict = {}                           # guarded-by: _lock
        self._pdone: set = set()    # hedge dedupe       # guarded-by: _lock
        # completed (step, frames), in order
        self._phistory: list = []                       # guarded-by: _pcond
        self._preview_cbs: list = []                    # guarded-by: _pcond

    def add_done_callback(self, fn) -> None:
        """Call ``fn(ticket)`` once, when the ticket resolves (completed OR
        failed). Fires immediately if already resolved. Callbacks run on the
        resolving thread, outside the ticket lock; exceptions are swallowed
        (a broken observer must not poison engine delivery). The fleet
        router rides this to learn a placement's outcome without a thread
        per ticket."""
        with self._lock:
            if not self._resolved:
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:  # noqa: BLE001 — observers must not poison delivery
            pass

    def _resolve(self) -> None:
        """Set the event and fire registered callbacks (resolver thread)."""
        self.done_time = time.perf_counter()
        self._event.set()
        with self._pcond:
            self._pcond.notify_all()  # previews() iterators stop at done
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    # ------------------------------------------------------------ previews

    def add_preview_callback(self, fn) -> None:
        """Call ``fn(step, frames)`` for every COMPLETED preview frame (all
        n rows landed), in completion order. Frames that completed before
        registration are replayed first — registration and delivery
        serialize on one lock, so no frame is missed or fired twice.
        Exceptions are swallowed like done-callbacks. The fleet router rides
        this to forward replica previews to its own ticket."""
        with self._pcond:
            self._preview_cbs.append(fn)
            replay = list(self._phistory)
        for step, frames in replay:
            try:
                fn(step, frames)
            except Exception:  # noqa: BLE001 — observers must not poison
                pass

    def _preview(self, step: int, lo: int, hi: int,
                 rows: np.ndarray) -> bool:
        """Engine-side: land preview rows [lo, hi) of trajectory frame
        ``step``. True when that frame just completed. Frames landing after
        the ticket resolved, or for an already-completed step (a hedged
        re-placement re-delivers the schedule), are dropped."""
        step = int(step)
        with self._lock:
            if self._resolved:
                return False
            if step in self._pdone:
                return False
            ent = self._pbuf.get(step)
            if ent is None:
                ent = self._pbuf[step] = [
                    np.empty((self.n,) + rows.shape[1:], rows.dtype),
                    self.n]
            ent[0][lo:hi] = rows
            ent[1] -= hi - lo
            if ent[1] > 0:
                return False
            frames = self._pbuf.pop(step)[0]
            self._pdone.add(step)
        with self._pcond:
            self._phistory.append((step, frames))
            cbs = list(self._preview_cbs)
            self._pcond.notify_all()
        for fn in cbs:
            try:
                fn(step, frames)
            except Exception:  # noqa: BLE001 — observers must not poison
                pass
        return True

    def previews(self, timeout: Optional[float] = None):
        """Iterate completed preview frames as ``(step, frames)`` — frames
        is the (n, H, W, C) intermediate x̂0 prediction after scan step
        ``step`` — blocking up to ``timeout`` between frames (TimeoutError
        on expiry, with the engine health snapshot). The iterator ends when
        the ticket RESOLVES and the history is drained: for a completed
        request that is after the last preview; for a failed one it simply
        stops early (the error surfaces via ``result()``/``exception()``).
        A ticket without ``preview_every`` yields nothing and returns at
        resolution."""
        idx = 0
        while True:
            with self._pcond:
                while len(self._phistory) <= idx and not self._event.is_set():
                    if not self._pcond.wait(timeout):
                        raise TimeoutError(self._timeout_msg(timeout))
                if len(self._phistory) <= idx:
                    return
                step, frames = self._phistory[idx]
                idx += 1
            yield step, frames

    def _deliver(self, lo: int, hi: int, rows: np.ndarray) -> bool:
        """Engine-side: land request rows [lo, hi). True when complete.
        Rows landing after the ticket failed are dropped (the error is the
        outcome; a half-filled buffer must never masquerade as a result)."""
        with self._lock:
            if self._resolved:
                return False
            if self._buf is None:
                self._buf = np.empty((self.n,) + rows.shape[1:], rows.dtype)
            self._buf[lo:hi] = rows
            self._remaining -= hi - lo
            done = self._remaining == 0
            if done:
                self._resolved = True  # claim the resolution under the lock
        if done:
            self._resolve()
        return done

    def _fail(self, exc: BaseException) -> bool:
        """Engine-side: resolve the ticket as failed. First resolution wins
        (a ticket that already completed, or already failed, is untouched);
        returns True when THIS call resolved it. The claim races on
        ``_resolved``, not on ``_event``: a completing ``_deliver`` marks
        ``_resolved`` before releasing the lock but sets the event only
        afterwards, so testing the event here would let a concurrent
        ``_fail`` mask a fully delivered result with an error."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self._error = exc
        self._resolve()
        return True

    @property
    def done(self) -> bool:
        """True once the ticket is RESOLVED — completed or failed."""
        return self._event.is_set()

    @property
    def failed(self) -> bool:
        return self._error is not None

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_time is None:
            return None
        return self.done_time - self.submit_time

    def _timeout_msg(self, timeout) -> str:
        base = (f"ticket for {self.n} rows not complete after {timeout}s "
                f"({self._remaining} rows outstanding)")
        if self._health_cb is not None:
            try:
                health = self._health_cb()
                stage = health.get("last_stage")
                if stage is not None:
                    base += (f"; engine last seen at stage {stage!r}, "
                             f"{health.get('stalled_for_s')}s ago")
                return f"{base}; engine health: {health}"
            except Exception:  # noqa: BLE001 — diagnostics must not mask
                return base
        return base + " — no engine attached (did Engine.run() run?)"

    def exception(self, timeout: Optional[float] = None):
        """The request's failure, or None if it completed
        (concurrent.futures semantics: blocks up to ``timeout``, raising
        TimeoutError — with the engine health snapshot — if unresolved)."""
        if not self._event.wait(timeout):
            raise TimeoutError(self._timeout_msg(timeout))
        return self._error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(self._timeout_msg(timeout))
        if self._error is not None:
            raise self._error
        return self._buf


@dataclass
class Request:
    """One queued sampling request (internal to the engine; tests build these
    directly for planner coverage). ``key`` is the request's integer seed
    for fresh starts; ``x_init`` the (n, H, W, C) start for guided requests."""

    config: SamplerConfig
    n: int
    key: Optional[object] = None
    x_init: Optional[object] = None
    #: extra per-row batch inputs some tasks ride along with x (host numpy,
    #: leading dim n; the assembly thread slices rows like x_init). The
    #: inpaint task carries {"known": (n,H,W,C), "mask": (n,H,W,1)}.
    extras: Optional[dict] = None
    ticket: Ticket = field(default_factory=lambda: Ticket(0))
    #: engine-assigned id (submit order); fault tags and quarantine records
    #: name requests by it
    rid: int = -1
    #: absolute deadline (time.perf_counter() clock); None = no deadline.
    #: Enforced at plan time and again at dispatch time — an expired request
    #: fails fast with DeadlineExceeded instead of occupying a bucket.
    deadline: Optional[float] = None
    # memo for the assembly thread: the request's full x_init drawn ONCE at
    # its own n (the draw depends on n, slicing does not), shared by every
    # batch the request's rows land in
    _x_full: Optional[object] = None


@dataclass(frozen=True)
class BatchPlan:
    """One device dispatch: ``rows`` real rows padded to ``bucket``.

    ``entries`` = (request, req_lo, req_hi, row_offset): request rows
    [req_lo, req_hi) occupy batch rows [row_offset, row_offset + hi - lo).
    """

    config: SamplerConfig
    bucket: int
    entries: tuple
    rows: int

    @property
    def padded_rows(self) -> int:
        return self.bucket - self.rows


def select_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket that fits ``n`` whole; None when ``n`` exceeds the
    largest (the planner then splits the request across batches)."""
    fits = [b for b in buckets if b >= n]
    return min(fits) if fits else None


def cover_rows(rows: int, buckets: Sequence[int]) -> list[int]:
    """Bucket multiset covering ``rows`` with minimum padding (ties → fewest
    batches). Greedily peels max-size buckets, then exact DP on the tail:
    the first reachable sum ≥ the remainder has minimal padding, and the DP
    carries the minimum batch count to each sum."""
    bs = sorted({int(b) for b in buckets})
    if not bs or bs[0] <= 0:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    out: list[int] = []
    remaining = int(rows)
    bmax = bs[-1]
    while remaining >= bmax:
        out.append(bmax)
        remaining -= bmax
    if remaining == 0:
        return out
    limit = remaining + bmax  # sum ≥ remaining is reachable by this point
    inf = limit + 1
    count = [inf] * (limit + 1)
    choice = [0] * (limit + 1)
    count[0] = 0
    for s in range(1, limit + 1):
        for b in bs:
            if b <= s and count[s - b] + 1 < count[s]:
                count[s] = count[s - b] + 1
                choice[s] = b
    for s in range(remaining, limit + 1):
        if count[s] <= limit:
            tail = []
            while s:
                tail.append(choice[s])
                s -= choice[s]
            return out + sorted(tail, reverse=True)
    raise AssertionError("unreachable: limit includes a whole bmax")


def plan_batches(requests: Sequence, buckets: Sequence[int]) -> list[BatchPlan]:
    """Coalesce a FIFO request list into bucket-padded batch plans.

    Requests group by config (first-seen order; FIFO within a group) and the
    group's total rows are covered by ``cover_rows``; rows then pack densely
    into the chosen buckets in request order, splitting requests at batch
    boundaries. Only the LAST batch of a group carries padding.

    Batch-coupled configs (``SamplerConfig.batch_coupled`` — the adaptive
    drift gate) are the exception: each request becomes its OWN single
    batch in the smallest bucket that fits it whole (never coalesced with a
    batchmate, never split — either would change the batch the gate's max
    reduction sees and break bitwise-vs-direct). A coupled request larger
    than the biggest bucket is rejected here, which surfaces as a submit
    error.
    """
    groups: dict[SamplerConfig, list] = {}
    for req in requests:
        if req.n < 1:
            raise ValueError(f"request must have n >= 1, got {req.n}")
        groups.setdefault(req.config, []).append(req)

    plans: list[BatchPlan] = []
    for config, reqs in groups.items():
        if config.batch_coupled:
            for req in reqs:
                bucket = select_bucket(req.n, buckets)
                if bucket is None:
                    raise ValueError(
                        f"adaptive-cache request of {req.n} rows exceeds the "
                        f"largest bucket {max(buckets)} — the drift gate "
                        "couples the batch, so the request cannot split; "
                        "submit at most max(buckets) rows per request")
                plans.append(BatchPlan(config=config, bucket=bucket,
                                       entries=((req, 0, req.n, 0),),
                                       rows=req.n))
            continue
        total = sum(r.n for r in reqs)
        sizes = cover_rows(total, buckets)
        it = iter(reqs)
        req, lo = next(it), 0
        for bucket in sizes:
            entries, offset = [], 0
            while offset < bucket and req is not None:
                take = min(req.n - lo, bucket - offset)
                entries.append((req, lo, lo + take, offset))
                offset += take
                lo += take
                if lo == req.n:
                    req, lo = next(it, None), 0
            plans.append(BatchPlan(config=config, bucket=bucket,
                                   entries=tuple(entries), rows=offset))
        assert req is None, "cover_rows under-covered the group"
    return plans
