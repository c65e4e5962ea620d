"""Bounded-liveness guard for device interactions that can go silent.

Counterpart of ``ddim_cold_tpu/utils/watchdog.py``, except that
:meth:`StallWatchdog.done` wakes the watchdog thread and joins it instead of
leaving it asleep until its next poll. A wedged device call
(a hung driver call, a kernel that never ends, a fetch that never returns)
blocks its thread with no exception to catch. Call :meth:`StallWatchdog.mark`
before every potentially silent interaction; a watchdog thread calls
``on_abort`` when no mark lands within the stall budget, then either exits
the process (``os._exit(exit_code)``, for one-shot scripts whose main thread
is the wedged one) or, in soft mode, stops (the serving engine: the hook
fails the waiting tickets while the wedged call stays parked on its own
thread).

Host-only: no torch import.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    """Abort when no :meth:`mark` lands within ``stall_s``.

    ``stall_s`` ≤ 0 disables the guard. ``budget_s`` on a mark stretches
    the deadline for the single window AFTER it: known-long silent
    operations must not be taken for wedged ones.

    ``exit_code=None`` selects SOFT mode for long-running in-process hosts
    (the serving engine): on stall the watchdog calls ``on_abort`` once and
    stops, WITHOUT ``os._exit``. The hard default exits: a one-shot script's
    main thread IS the wedged one, so only process death frees anything.
    """

    def __init__(self, stall_s: float, *, exit_code: Optional[int] = 3,
                 on_abort: Optional[Callable[[str, float], None]] = None,
                 name: str = "watchdog"):
        self.stall_s = float(stall_s)
        self.exit_code = exit_code
        self.on_abort = on_abort
        self.name = name
        self._state = {"t": time.time(), "label": "start",  # guarded-by: _lock
                       "budget": None, "done": False}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def mark(self, label: str, budget_s: Optional[float] = None) -> None:
        with self._lock:
            self._state.update(t=time.time(), label=label, budget=budget_s)

    def done(self) -> None:
        """Disarm: the guarded work has finished. The watchdog thread ends
        before this returns (unless it is the caller), so what it holds,
        ``on_abort``'s owner included, does not outlive the guarded work by
        up to a poll interval, and no sleeping thread is left per use."""
        with self._lock:
            self._state["done"] = True
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join()

    def start(self) -> "StallWatchdog":
        if self.stall_s > 0:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            self._stop.wait(min(15.0, max(0.05, self.stall_s / 4)))
            with self._lock:
                if self._state["done"]:
                    return
                limit = max(self.stall_s, self._state["budget"] or 0.0)
                silent = time.time() - self._state["t"]
                label = self._state["label"]
            if silent > limit:
                print(f"[{self.name}] STALL: no progress for {silent:.0f}s "
                      f"(> {limit:.0f}s) after {label!r} — aborting",
                      file=sys.stderr, flush=True)
                if self.on_abort is not None:
                    try:
                        self.on_abort(label, silent)
                    except Exception as e:  # noqa: BLE001 — abort must abort
                        print(f"[{self.name}] on_abort failed: {e!r}",
                              file=sys.stderr, flush=True)
                if self.exit_code is None:  # soft mode: one-shot, no exit
                    self.done()
                    return
                os._exit(self.exit_code)
