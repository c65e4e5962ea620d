"""Per-request trace spans through the serving engine.

Counterpart of ``ddim_cold_tpu/obs/spans.py`` (stdlib only, as there). A
*trace* is one ticket's life: created at ``Engine.submit`` and closed at
delivery or terminal failure. What happens to the ticket on the way
(planning, assembly, dispatch, fetch, preview) lands as *spans* under that
one trace, so a chaos run renders as one tree per request; a caller that
passes its own span as ``submit(trace=...)`` parents the request under it.

Design constraints:

* **Disabled is free.** Tracing is off by default; every entry point checks
  one module bool and returns a falsy :data:`NULL` span, so the serving hot
  path pays a single attribute read and launches nothing more.
* **Deterministic ids.** trace/span ids come from ``itertools.count``: the
  same run produces the same ids, and ids are unique per process.
* **Host-only**: no torch import; spans ride the host threads.

Export: :func:`export_chrome` renders spans as Chrome trace-event JSON
(load in ``chrome://tracing`` / Perfetto; one row per trace), and
:func:`export_jsonl` as one JSON object per line.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "TraceContext", "Span", "NULL", "enable", "disable", "enabled",
    "tracing", "begin", "record", "now", "spans", "clear", "export_chrome",
    "export_jsonl",
]


@dataclass(frozen=True)
class TraceContext:
    """The propagatable part of a span: what rides a ``submit(trace=...)``
    call into the engine, so the request's spans join the caller's trace."""

    trace_id: int
    span_id: int


class Span:
    """One named, timed node of a trace. ``end()`` closes it (idempotent:
    first close wins, matching Ticket's first-resolution-wins rule)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs", "_rec")

    def __init__(self, rec, trace_id, span_id, parent_id, name, t0, attrs):
        self._rec = rec
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    @property
    def ended(self) -> bool:
        return self.t1 is not None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(self, name: str, **attrs) -> "Span":
        return self._rec.begin(name, parent=self, **attrs)

    def end(self, **attrs) -> None:
        if self.t1 is None:
            self.attrs.update(attrs)
            self.t1 = self._rec.now()

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        state = "open" if self.t1 is None else f"{self.t1 - self.t0:.4f}s"
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, {state})")


class _NullSpan:
    """The disabled-tracing span: falsy, every operation a no-op, safe to
    thread anywhere a real span goes."""

    __slots__ = ()
    trace_id = span_id = parent_id = None
    name = ""
    t0 = t1 = None
    attrs: dict = {}
    ctx = None
    ended = True

    def set(self, **attrs):
        return self

    def child(self, name, **attrs):
        return self

    def end(self, **attrs):
        pass

    def __bool__(self):
        return False

    def __repr__(self):
        return "Span(<disabled>)"


NULL = _NullSpan()


class Recorder:
    """Process-local span store. Timing uses ``time.monotonic`` anchored to
    the recorder's first span, so exported timestamps start near zero."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list = []                          # guarded-by: _lock
        self._trace_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._t0: Optional[float] = None                # guarded-by: _lock

    def now(self) -> float:
        """Monotonic seconds since the recorder's first event. The epoch is
        lazily anchored with double-checked locking, and the anchored value
        is read back ONCE under the lock, so a concurrent ``clear()`` can
        neither None it mid-call nor skew the timestamp."""
        t = time.monotonic()
        t0 = self._t0
        if t0 is None:
            with self._lock:
                if self._t0 is None:
                    self._t0 = t
                t0 = self._t0
        return t - t0

    def begin(self, name: str, parent=None, **attrs) -> Span:
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, TraceContext):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = next(self._trace_ids), None
        span = Span(self, trace_id, next(self._span_ids), parent_id, name,
                    self.now(), attrs)
        with self._lock:
            self._spans.append(span)
        return span

    def record(self, parent, name: str, t0: float, t1: float, **attrs) -> Span:
        """Retroactively add a CLOSED span — how per-batch stage timings
        (assemble/dispatch/fetch measured once per batch) become one span
        per participating request without re-running the stage."""
        span = self.begin(name, parent=parent, **attrs)
        span.t0, span.t1 = t0, t1
        return span

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._t0 = None

    # -- export -----------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON: complete ("X") events, one timeline row
        (tid) per trace so a request's whole tree reads left-to-right. Open
        spans export with dur=0 and ``"open": true`` — visible, not lost."""
        events = []
        for s in self.spans():
            t1 = s.t1 if s.t1 is not None else s.t0
            args = {"span_id": s.span_id, "parent_id": s.parent_id}
            args.update(s.attrs)
            if s.t1 is None:
                args["open"] = True
            events.append({
                "name": s.name, "cat": "serve", "ph": "X",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round((t1 - s.t0) * 1e6, 3),
                "pid": 0, "tid": s.trace_id, "args": args,
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def export_jsonl(self, path: Optional[str] = None) -> list:
        rows = [{
            "trace_id": s.trace_id, "span_id": s.span_id,
            "parent_id": s.parent_id, "name": s.name,
            "t0": round(s.t0, 6),
            "t1": None if s.t1 is None else round(s.t1, 6),
            "attrs": s.attrs,
        } for s in self.spans()]
        if path is not None:
            with open(path, "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
        return rows


_REC = Recorder()
_ENABLED = False


def recorder() -> Recorder:
    return _REC


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


class tracing:
    """``with obs.spans.tracing():`` — enable tracing for a scope, restore
    the previous state on exit (nesting-safe)."""

    def __enter__(self):
        self._prev = _ENABLED
        enable()
        return _REC

    def __exit__(self, *exc):
        if not self._prev:
            disable()
        return False


def begin(name: str, parent=None, **attrs):
    """Open a span (a new trace when ``parent`` is None). Returns
    :data:`NULL` when tracing is disabled — the one check every serving-path
    call site relies on for the zero-overhead contract."""
    if not _ENABLED:
        return NULL
    return _REC.begin(name, parent=parent, **attrs)


def record(parent, name: str, t0: float, t1: float, **attrs) -> None:
    if not _ENABLED or parent is None or parent is NULL:
        return
    _REC.record(parent, name, t0, t1, **attrs)


def now() -> float:
    """The recorder clock — the timebase ``record()``'s t0/t1 must be on."""
    return _REC.now()


def spans() -> list:
    return _REC.spans()


def clear() -> None:
    _REC.clear()


def export_chrome(path: Optional[str] = None) -> dict:
    return _REC.export_chrome(path)


def export_jsonl(path: Optional[str] = None) -> list:
    return _REC.export_jsonl(path)
