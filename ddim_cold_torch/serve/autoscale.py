"""Load-driven fleet autoscaling — the control loop over Router.scale_to.

Counterpart of ``ddim_cold_tpu/serve/autoscale.py``. Supervision already
REPLACES dead replicas at a fixed target; this module moves the target
itself. Each tick
reads one :meth:`Router.health` snapshot — queue pressure (router-queued
requests plus per-replica engine queues, normalized per ready replica) and
the worst per-replica p95 ticket latency (serve/engine.py surfaces the
percentiles from the metrics registry's ``engine.latency_s`` series)
— and votes it against two thresholds:

* **overload**  — queue/replica above ``queue_high`` OR p95 above
  ``p95_high_s``;
* **underload** — queue/replica at/below ``queue_low`` AND (when a p95
  floor is configured) p95 below ``p95_low_s``.

Three mechanisms keep the loop from flapping on noisy signals, and the
tests pin each one:

* **hysteresis** — the up and down thresholds are separated bands, and a
  decision needs ``up_ticks`` / ``down_ticks`` CONSECUTIVE votes (one
  noisy p95 spike resets the down-streak, it never triggers a scale-up on
  its own ... unless it persists);
* **cooldown** — after any scale action, both directions hold for
  ``cooldown_s`` (measured on the injectable ``clock``, so the unit tests
  advance time without sleeping);
* **bounds + warm pool** — the target stays in
  ``[min_replicas + warm_pool, max_replicas]``. The warm pool is spare
  serving capacity kept WARM (each spawned replica is warmed by the
  router's spawn path, its kernel libraries loaded from ``build/``), so
  replacing a crashed replica costs a spawn, not a cold start under load.

Scale-up asks the router for one more replica; the router's supervision
tick spawns and warms it (a subprocess handle's ``warm`` checks the
zero-program contract). Scale-down retires the
least-loaded replica through the normal eviction path — queued tickets
fail over, nothing is lost to a scale decision.

Host-only (no torch import). The background thread only ever touches the
router OUTSIDE the autoscaler's own lock: the one order the two locks may
be held in is autoscale::_lock → router::_lock, and the code never takes
them the other way round.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ddim_cold_torch.obs import metrics


class Autoscaler:
    """Drive ``router.scale_to`` from load. ``tick()`` is the whole brain
    and is public: the unit tests call it directly with a fake clock;
    :meth:`start` just runs it every ``interval_s`` on a daemon thread."""

    def __init__(self, router, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 queue_high: float = 8.0, queue_low: float = 1.0,
                 p95_high_s: Optional[float] = None,
                 p95_low_s: Optional[float] = None,
                 up_ticks: int = 2, down_ticks: int = 5,
                 cooldown_s: float = 10.0, warm_pool: int = 0,
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas + warm_pool:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas + "
                f"warm_pool ({min_replicas} + {warm_pool})")
        if queue_low > queue_high:
            raise ValueError(f"queue_low ({queue_low}) must be <= "
                             f"queue_high ({queue_high}) — the hysteresis "
                             "band would be inverted")
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p95_high_s = p95_high_s
        self.p95_low_s = p95_low_s
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.warm_pool = int(warm_pool)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.metrics = metrics.scope("autoscale")
        # decision state: only the tick path touches these, and ticks are
        # serialized (one thread, or a test driving tick() directly)
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: Optional[float] = None
        self.last_decision: dict = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock

    # ------------------------------------------------------------- signals

    @property
    def floor(self) -> int:
        """Scale-down floor: the configured minimum plus the warm pool."""
        return self.min_replicas + self.warm_pool

    def read_signals(self, health: Optional[dict] = None) -> dict:
        """One load sample from a router health snapshot: total queued
        work (router queue + every replica's engine queue), its per-ready-
        replica normalization, and the worst replica p95."""
        h = health if health is not None else self.router.health()
        replicas = h.get("replicas", {})
        ready = [r for r in replicas.values() if r.get("state") == "ready"]
        router_queued = sum(h.get("pending_by_tenant", {}).values())
        engine_queued = sum(r.get("queue_depth", 0) + r.get("open_tickets", 0)
                            for r in ready)
        total = router_queued + engine_queued
        p95 = max((r.get("latency_p95_s", 0.0) or 0.0 for r in ready),
                  default=0.0)
        n_ready = max(1, len(ready))
        return {"ready": len(ready), "queued": total,
                "queued_per_replica": total / n_ready, "p95_s": p95,
                "target": self.router.target, "closed": h.get("closed")}

    # ---------------------------------------------------------------- tick

    def tick(self, health: Optional[dict] = None) -> dict:
        """One control decision. Returns (and stores on ``last_decision``)
        the signals plus the action taken: ``"up"``, ``"down"``, or
        ``None``."""
        sig = self.read_signals(health)
        self.metrics.inc("autoscale.ticks")
        action = None
        if not sig["closed"]:
            over = sig["queued_per_replica"] > self.queue_high \
                or (self.p95_high_s is not None
                    and sig["p95_s"] > self.p95_high_s)
            under = sig["queued_per_replica"] <= self.queue_low \
                and (self.p95_low_s is None or sig["p95_s"] < self.p95_low_s)
            if over:
                self._up_streak += 1
                self._down_streak = 0
            elif under:
                self._down_streak += 1
                self._up_streak = 0
            else:
                # the dead band between the thresholds: hold, and make any
                # pending streak start over (hysteresis)
                self._up_streak = 0
                self._down_streak = 0
            now = self.clock()
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
            target = sig["target"]
            if (over and self._up_streak >= self.up_ticks and not cooling
                    and target < self.max_replicas):
                self.router.scale_to(target + 1)
                self.metrics.inc("autoscale.scale_ups")
                self._last_action_t = now
                self._up_streak = 0
                action = "up"
            elif (under and self._down_streak >= self.down_ticks
                    and not cooling and target > self.floor):
                self.router.scale_to(target - 1)
                self.metrics.inc("autoscale.scale_downs")
                self._last_action_t = now
                self._down_streak = 0
                action = "down"
        self.metrics.gauge("autoscale.target", self.router.target)
        sig["action"] = action
        sig["up_streak"] = self._up_streak
        sig["down_streak"] = self._down_streak
        self.last_decision = sig
        return sig

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Run :meth:`tick` every ``interval_s`` on a daemon thread
        (idempotent). The floor is asserted immediately: a fleet configured
        with a warm pool scales up to it on the first tick rather than
        waiting for load."""
        if self.router.target < self.floor:
            self.router.scale_to(self.floor)
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="autoscaler", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a scaling decision must
                pass           # never be load-bearing for serving itself

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)
