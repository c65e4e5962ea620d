"""The port's fleet (``serve/router.py``, ``fleet.py``, ``autoscale.py``)
against the JAX package's.

Lifts ``tests/test_fleet.py`` and ``tests/test_autoscale.py`` onto the
port's ``Router`` over in-process replicas of the port's ``Engine`` (TINY:
16 px, patch 8, C=32, depth 2, k=500 = 4 steps, ONE bucket (8,)), and holds
the port's control plane to JAX's on the same inputs.

Oracles. The JAX fleet's ROWS are not one (rows are bitwise only at one
dispatch shape within one package; JAX's own fleet tests fail here on
1e-7 cross-shape bits). Its DETERMINISTIC DECISIONS are: admission and
share rejections, candidate order, autoscale votes, targets and counters,
the metric snapshots of one scripted sequence. Every routed row is held to
the port's own direct ``ddim_sample`` over an 8-row batch that holds the
request's start in its first rows: with one bucket, a row is that call's
bits whatever its batchmates.

``tests/test_fleet.py::test_sp_ticket_failover_reuses_warmed_programs``
is held in ``tests/test_torch_port_fleet_mesh.py``: the port's engine
serves ``sp_degree`` only across ranks, so its counterpart runs replicas
across ranks (``local_factory(mesh=)``) in a world of gloo ranks.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ddim_cold_torch import serve
from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.ops import flash_attention as fa
from ddim_cold_torch.ops import quant, sampling
from ddim_cold_torch.serve import fleet, replica_main
from ddim_cold_torch.serve import router as router_mod
from ddim_cold_torch.serve.autoscale import Autoscaler
from ddim_cold_torch.serve.router import Router
from ddim_cold_torch.utils import faults
from ddim_cold_torch.utils.faults import FaultSpec
from ddim_cold_tpu.serve import fleet as jax_fleet
from ddim_cold_tpu.serve import replica_main as jax_replica_main
from ddim_cold_tpu.serve import router as jax_router_mod
from ddim_cold_tpu.serve.autoscale import Autoscaler as JaxAutoscaler
from ddim_cold_tpu.serve.batching import SamplerConfig as JaxSamplerConfig
from ddim_cold_tpu.utils import faults as jax_faults

TINY = dict(img_size=(16, 16), patch_size=8, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K = 500  # 4 reverse steps
BUCKET = 8
CFG = serve.SamplerConfig(k=K)


@pytest.fixture(autouse=True)
def clean_state():
    for f in (faults, jax_faults):
        assert not f.active(), "a previous test leaked an armed fault scope"
    yield
    for f in (faults, jax_faults):
        assert not f.active(), "this test leaked an armed fault scope"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """TINY batches are thousands of microsecond ops: one intra-op thread
    computes the same bits without stalling a loaded host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    return DiffusionViT(**TINY, use_flash=True, device="cpu")


def _router(model, **kwargs):
    factory = serve.local_factory(model, buckets=(BUCKET,), device="cpu",
                                  retry_base_s=0.0)
    kwargs.setdefault("configs", [CFG])
    kwargs.setdefault("drain_timeout_s", 10.0)
    return Router(factory, **kwargs)


def _direct(model, seed, n, **kw):
    """The port's direct call over an 8-row batch holding the request's
    start in rows 0..n-1 (zero padding)."""
    x = torch.zeros((BUCKET, 16, 16, 3))
    x[:n] = sampling.fresh_start(model, torch.Generator().manual_seed(seed), n, "cpu")
    return sampling.ddim_sample(model, x_init=x, k=K, device="cpu", **kw)[:n].numpy()


def _poll(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ------------------------------------------------------------ clean routing


def test_router_rows_bitwise_and_zero_programs(model):
    """Mixed-size requests over two replicas all come back bitwise the
    direct call at bucket 8, with no program built after warmup anywhere;
    each replica's health names it."""
    router = _router(model, replicas=2)
    sizes = [(41, 5), (42, 4), (43, 3), (44, 1), (45, 8)]
    tickets = {s: router.submit(seed=s, n=n, config=CFG) for s, n in sizes}
    for s, n in sizes:
        got = tickets[s].result(timeout=60)
        assert got.shape == (n, 16, 16, 3)
        np.testing.assert_array_equal(got, _direct(model, s, n))
    h = router.drain(timeout=10)
    assert h["programs_after_warmup"] == 0
    assert h["completed"] == len(sizes) and h["failed"] == 0
    assert h["active_replicas"] == 2 and h["retired_replicas"] == 0
    for rid, rh in h["replicas"].items():
        assert rh["replica"] == rid and rh["state"] == fleet.CLOSED
        assert rh["programs_after_warmup"] == 0


def test_router_guided_request_bitwise(model):
    """x_init requests (the guided start at t_start) route like fresh ones:
    the router passes the host array through untouched."""
    cfg = serve.SamplerConfig(k=K, t_start=1000)
    router = _router(model, replicas=2, configs=[cfg])
    x0 = np.random.RandomState(7).standard_normal((3, 16, 16, 3)).astype(np.float32)
    got = router.submit(x_init=x0, config=cfg).result(timeout=60)
    x = torch.zeros((BUCKET, 16, 16, 3))
    x[:3] = torch.from_numpy(x0)
    want = sampling.ddim_sample(model, x_init=x, k=K, t_start=1000, device="cpu")[:3]
    np.testing.assert_array_equal(got, want.numpy())
    assert router.drain(timeout=10)["programs_after_warmup"] == 0


def test_replicas_share_the_module_and_build_variants_at_warmup(model):
    """In-process replicas share the caller's module, which stays in eval
    mode; each engine builds its own quant variant while it is warmed, not
    at its first ticket, and serving a warmed quant config builds nothing."""
    qcfg = serve.SamplerConfig(k=K, quant="pallas")
    router = _router(model, replicas=2, configs=[CFG, qcfg])
    engines = [rep.engine for rep in router._replicas.values()]
    assert all(e.model is model for e in engines)
    variants = [e._variants[("pallas", False, False)] for e in engines]
    assert variants[0] is not variants[1]
    rows = router.submit(seed=46, n=2, config=qcfg).result(timeout=60)
    assert rows.shape == (2, 16, 16, 3) and np.isfinite(rows).all()
    h = router.drain(timeout=10)
    assert h["programs_after_warmup"] == 0 and not model.training


def test_local_factory_loads_params_once(model):
    """``params`` goes into the shared module when the factory is made, not
    into each replica's engine."""
    other = DiffusionViT(**TINY, use_flash=True, device="cpu", seed=1)
    target = DiffusionViT(**TINY, use_flash=True, device="cpu")
    factory = serve.local_factory(target, other.state_dict(), buckets=(BUCKET,),
                                  device="cpu")
    assert all(torch.equal(target.state_dict()[k], v)
               for k, v in other.state_dict().items())
    rep = factory("r0")
    assert rep.engine.model is target and rep.replica_id == "r0"


def test_router_validation():
    with pytest.raises(ValueError, match="replicas"):
        Router(lambda rid: None, replicas=0, auto_start=False)
    with pytest.raises(ValueError, match="max_pending"):
        Router(lambda rid: None, replicas=1, max_pending=0, auto_start=False)


def test_router_submit_validation(model):
    """The JAX router's submit checks, minus ``rng=`` (a seed crosses a
    process boundary, a PRNG key does not)."""
    router = _router(model, replicas=1, auto_start=False)
    try:
        with pytest.raises(ValueError, match="seed="):
            router.submit(n=1, config=CFG)
        with pytest.raises(ValueError, match="not both"):
            router.submit(seed=0, config=CFG, k=K)
        with pytest.raises(ValueError, match="mask"):
            router.submit(seed=0, mask=np.ones((16, 16)), config=CFG)
        with pytest.raises(ValueError, match="n must be"):
            router.submit(seed=0, n=0, config=CFG)
    finally:
        router.drain(timeout=1)


# ------------------------------------------------------- hedging and chaos


def test_hedged_request_is_bitwise(model):
    """A retryable failure (an assembly transient: the engine does not retry
    assembly) hedges the request once to the other replica; the hedge
    re-issues the same seed, so the rows are the direct call's bits."""
    router = _router(model, replicas=2)
    spec = FaultSpec("serve.assemble", "transient", rate=1.0,
                     match="replica:r0|", max_fires=1)
    with faults.inject(spec) as plan:
        got = router.submit(seed=51, n=3, config=CFG).result(timeout=60)
    np.testing.assert_array_equal(got, _direct(model, 51, 3))
    assert len(plan.realized) == 1
    assert router.stats["hedges"] == 1
    assert router.drain(timeout=10)["programs_after_warmup"] == 0


def test_quarantined_request_is_never_hedged(model):
    """RequestQuarantinedError is terminal: the router fails it through,
    naming the replica, and supervision replaces the poisoned replica."""
    router = _router(model, replicas=2)
    spec = FaultSpec("serve.dispatch", "permanent", rate=1.0, match="replica:r0|")
    with faults.inject(spec):
        exc = router.submit(seed=52, n=2, config=CFG).exception(timeout=60)
        assert isinstance(exc, serve.RequestQuarantinedError)
        assert "replica 'r0'" in str(exc)
        assert router.stats["hedges"] == 0
        router.submit(seed=53, n=1, config=CFG).exception(timeout=60)
        assert _poll(lambda: router.health()["retired_replicas"] >= 1
                     and router.health()["active_replicas"] >= 2)
    h = router.drain(timeout=10)
    assert h["retired_replicas"] >= 1 and h["replicas_spawned"] >= 3


def test_fleet_chaos_contract(model):
    """tests/test_fleet.py:168-213 on the port: r0's dispatch dead
    (permanent), assembly transients at 25%, placement transients at 20%
    on r1. Every ticket resolves; survivors bitwise; failures typed and
    naming their replica; r0 drained and replaced; no program after warmup
    on any replica, the replacement included."""
    router = _router(model, replicas=2, quarantine_limit=2, max_hedges=2)
    schedule = (
        FaultSpec("serve.dispatch", "permanent", rate=1.0, match="replica:r0|"),
        FaultSpec("serve.assemble", "transient", rate=0.25, seed=11),
        FaultSpec("router.place", "transient", rate=0.2, seed=12, match="replica:r1|"),
    )
    sizes = [(61, 3), (62, 2), (63, 4), (64, 1), (65, 2), (66, 3), (67, 1)]
    with faults.inject(*schedule) as plan:
        tickets = {s: router.submit(seed=s, n=n, config=CFG) for s, n in sizes}
        outcomes = {s: tickets[s].exception(timeout=120) for s, _ in sizes}
        assert _poll(lambda: router.health()["retired_replicas"] >= 1
                     and router.health()["active_replicas"] == 2, 30)
    assert len(plan.realized) >= 3 and "serve.dispatch" in plan.by_site()
    survivors = 0
    for s, n in sizes:
        exc = outcomes[s]
        if exc is None:
            survivors += 1
            np.testing.assert_array_equal(tickets[s].result(0), _direct(model, s, n))
        else:
            assert isinstance(exc, serve.ServeError)
            assert "replica 'r" in str(exc)
    assert survivors >= 1
    h = router.drain(timeout=10)
    assert h["replicas"]["r0"]["state"] == fleet.CLOSED
    assert h["retired_replicas"] >= 1 and h["replicas_spawned"] >= 3
    assert h["active_replicas"] == 2
    assert h["programs_after_warmup"] == 0
    for rid, rh in h["replicas"].items():
        assert rh.get("programs_after_warmup", 0) == 0, rid


def test_router_place_permanent_fault_fails_typed(model):
    router = _router(model, replicas=1)
    with faults.inject(FaultSpec("router.place", "permanent", rate=1.0)):
        exc = router.submit(seed=54, n=1, config=CFG).exception(timeout=30)
    assert isinstance(exc, serve.RequestFailedError)
    assert isinstance(exc.__cause__, faults.PermanentFault)
    assert "replica 'r0'" in str(exc)
    router.drain(timeout=5)


def test_router_failover_fault_fails_through_typed(model):
    """A fault in the re-placement path itself (``router.failover``) fails
    the request through, naming the replica it was leaving."""
    router = _router(model, replicas=2)
    specs = (FaultSpec("serve.assemble", "transient", rate=1.0, match="replica:r0|",
                       max_fires=1),
             FaultSpec("router.failover", "permanent", rate=1.0))
    with faults.inject(*specs) as plan:
        exc = router.submit(seed=55, n=1, config=CFG).exception(timeout=30)
    assert isinstance(exc, serve.RequestFailedError)
    assert "hedge" in str(exc) and "'r0'" in str(exc)
    assert plan.by_site() == {"serve.assemble": 1, "router.failover": 1}
    router.drain(timeout=5)


def test_replica_spawn_fault_is_fatal_at_cold_start(model):
    with faults.inject(FaultSpec("replica.spawn", "permanent", rate=1.0)):
        with pytest.raises(faults.PermanentFault):
            _router(model, replicas=1)


# -------------------------------------------------------------- tenant QoS


def test_qos_flooding_tenant_only_exhausts_its_share(model):
    """4:1 weights over max_pending=10: the flooder caps at 8, the light
    tenant keeps its 2 and completes within its deadline; every row bitwise."""
    router = _router(model, replicas=2, tenants={"heavy": 4, "light": 1},
                     max_pending=10, auto_start=False)
    heavy, rejected = [], 0
    for i in range(14):
        try:
            heavy.append((100 + i, router.submit(seed=100 + i, n=1, config=CFG,
                                                 tenant="heavy")))
        except serve.QueueFullError as exc:
            rejected += 1
            assert "'heavy'" in str(exc) and "fair share" in str(exc)
    assert len(heavy) == 8 and rejected == 6
    light = [(200 + i, router.submit(seed=200 + i, n=1, config=CFG, tenant="light",
                                     priority=1, deadline_s=60.0)) for i in range(2)]
    router.start()
    for s, t in light + heavy:
        np.testing.assert_array_equal(t.result(timeout=60), _direct(model, s, 1))
    assert all(t.latency_s < 60.0 for _, t in light)
    h = router.drain(timeout=10)
    assert h["rejected_by_tenant"] == {"heavy": 6}
    assert h["completed"] == 10 and h["programs_after_warmup"] == 0


def test_qos_share_frees_up_as_tickets_resolve(model):
    router = _router(model, replicas=1, tenants={"a": 1, "b": 1}, max_pending=4)
    for t in [router.submit(seed=300 + i, n=1, config=CFG, tenant="a") for i in range(2)]:
        t.result(timeout=60)
    for t in [router.submit(seed=310 + i, n=1, config=CFG, tenant="a") for i in range(2)]:
        t.result(timeout=60)
    assert router.drain(timeout=10)["rejected"] == 0


def test_router_drain_rejects_and_fails_queued(model):
    router = _router(model, replicas=1, auto_start=False)
    t = router.submit(seed=70, n=1, config=CFG)
    h = router.drain(timeout=0.2)
    assert h["closed"]
    assert isinstance(t.exception(timeout=5), serve.EngineClosedError)
    with pytest.raises(serve.EngineClosedError):
        router.submit(seed=71, n=1, config=CFG)


def test_local_replica_submit_after_drain_is_typed():
    """A replica that drained between the router's snapshot and its
    placement raises the typed failover class, never a raw error."""
    rep = fleet.LocalReplica(replica_main.StubEngine("local"))
    rep.warm([CFG], buckets=(4,))
    rep.start()
    rep.drain(timeout=5)
    with pytest.raises(serve.EngineClosedError, match="retry"):
        rep.submit(seed=0, n=1)


# ------------------------------------------------- stub units (supervision)


def _stub_class(handle_base, fleet_mod):
    class StubReplica(handle_base):
        """Health-programmable replica (tests/test_fleet.py's StubReplica)."""

        def __init__(self, rid):
            self.replica_id = rid
            self.state = fleet_mod.NEW
            self.drained = False
            self.h = {"stalled": False, "closed": False, "quarantined": 0,
                      "queue_depth": 0, "open_tickets": 0,
                      "last_progress_s": 0.0, "programs_after_warmup": 0}

        def warm(self, configs, buckets=None, **kwargs):
            self.state = fleet_mod.READY
            return {"new_programs": 0}

        def start(self):
            pass

        def submit(self, *args, **kwargs):
            raise serve.QueueFullError("stub replicas hold no work")

        def health(self):
            return dict(self.h, state=self.state, replica=self.replica_id)

        def drain(self, timeout=None):
            self.drained = True
            self.state = fleet_mod.CLOSED
            return self.health()

        def close(self):
            self.state = fleet_mod.CLOSED
    return StubReplica


StubReplica = _stub_class(fleet.ReplicaHandle, fleet)
JaxStubReplica = _stub_class(jax_fleet.ReplicaHandle, jax_fleet)


def _stub_factory(reps, cls=StubReplica):
    def factory(rid):
        reps[rid] = cls(rid)
        return reps[rid]
    return factory


def test_supervision_retires_and_replaces_stalled_replica():
    reps = {}
    router = Router(_stub_factory(reps), replicas=2, configs=(), tick_s=0.01)
    reps["r0"].h["stalled"] = True
    assert _poll(lambda: router.health()["retired_replicas"] == 1
                 and router.health()["active_replicas"] == 2, 10)
    assert reps["r0"].drained and reps["r0"].state == fleet.CLOSED
    assert "r2" in reps
    h = router.drain(timeout=2)
    assert h["replicas_spawned"] == 3 and h["replicas_retired"] == 1


def test_supervision_retires_a_replica_that_left_ready():
    """A handle that closed behind the router's back (a crashed subprocess
    self-transitions) is retired and replaced."""
    reps = {}
    router = Router(_stub_factory(reps), replicas=1, configs=(), tick_s=0.01)
    reps["r0"].state = fleet.CLOSED
    assert _poll(lambda: "r1" in reps and router.health()["active_replicas"] == 1, 10)
    h = router.drain(timeout=2)
    assert h["replicas_retired"] == 1 and h["replicas_spawned"] == 2


def test_supervision_counts_spawn_failures_and_retries():
    calls = {"n": 0}

    def factory(rid):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("no capacity")
        return StubReplica(rid)

    router = Router(factory, replicas=2, configs=(), tick_s=0.01)
    router._replicas["r0"].h["quarantined"] = 99
    assert _poll(lambda: router.stats["spawn_failures"] >= 2, 10)
    assert router.health()["active_replicas"] == 1
    router.drain(timeout=2)


def test_wedge_detection_from_snapshot():
    reps = {}
    router = Router(_stub_factory(reps), replicas=1, configs=(), tick_s=0.01,
                    wedge_after_s=0.5)
    reps["r0"].h.update(open_tickets=3, last_progress_s=9.0)
    assert _poll(lambda: router.stats["replicas_retired"] >= 1, 10)
    assert reps["r0"].drained
    router.drain(timeout=2)


def test_wedge_check_needs_open_tickets():
    """An idle replica whose last beacon is old is not wedged."""
    reps = {}
    router = Router(_stub_factory(reps), replicas=1, configs=(), tick_s=0.01,
                    wedge_after_s=0.5)
    reps["r0"].h.update(open_tickets=0, last_progress_s=9.0)
    time.sleep(0.2)
    assert router.stats["replicas_retired"] == 0 and not reps["r0"].drained
    router.drain(timeout=2)


# ------------------------------------------- control-plane parity with JAX


def _both_routers(**kwargs):
    """The port's Router and JAX's over the same stub handles, control loop
    deferred (nothing is placed: admission and candidates only)."""
    reps, jreps = {}, {}
    port = Router(_stub_factory(reps), configs=(), auto_start=False, **kwargs)
    jax_r = jax_router_mod.Router(_stub_factory(jreps, JaxStubReplica), configs=(),
                                  auto_start=False, **kwargs)
    return (port, reps), (jax_r, jreps)


def _flood(router, config, sequence):
    out = []
    for i, tenant in enumerate(sequence):
        try:
            router.submit(seed=i, n=1, config=config, tenant=tenant)
            out.append("ok")
        except Exception as exc:  # noqa: BLE001 — the class is the outcome
            out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("tenants,max_pending,sequence", [
    ({"heavy": 4, "light": 1}, 10, ["heavy"] * 14 + ["light"] * 3 + ["other"] * 2),
    ({"web": 2, "batch": 1}, 24, ["batch"] * 12 + ["web"] * 18 + ["batch"]),
    ({}, 5, ["a", "b"] * 4),
    ({"x": 1}, 1, ["x", "y", "x"]),
], ids=["4to1", "web-batch", "one-pool", "tiny-share"])
def test_admission_sequence_matches_jax(tenants, max_pending, sequence):
    """The same tenant flood with auto_start=False admits and rejects the
    same requests in both routers, with the same per-tenant counters."""
    (port, _), (jax_r, _) = _both_routers(replicas=1, tenants=tenants,
                                          max_pending=max_pending)
    got = _flood(port, CFG, sequence)
    want = _flood(jax_r, JaxSamplerConfig(k=K), sequence)
    assert got == want
    assert port.stats["rejected_by_tenant"] == jax_r.stats["rejected_by_tenant"]
    assert port.health()["outstanding_by_tenant"] == jax_r.health()["outstanding_by_tenant"]
    port.drain(timeout=0.1)
    jax_r.drain(timeout=0.1)


_SNAPSHOTS = {
    "least-loaded": [dict(queue_depth=3), dict(open_tickets=1), dict(queue_depth=2,
                                                                      open_tickets=2)],
    "ties-by-id": [dict(queue_depth=1), dict(queue_depth=1), dict(queue_depth=0)],
    "unhealthy-skipped": [dict(stalled=True), dict(closed=True), dict(quarantined=2),
                          dict(queue_depth=5)],
    "not-ready-skipped": [dict(state="draining"), dict(queue_depth=9), dict()],
    "tried-skipped": [dict(), dict(queue_depth=4), dict(queue_depth=1)],
    "all-tried": [dict(queue_depth=2), dict()],
}
_TRIED = {"tried-skipped": {"r0", "r2"}, "all-tried": {"r0", "r1"}}


@pytest.mark.parametrize("case", sorted(_SNAPSHOTS))
def test_candidate_order_matches_jax(case):
    """The same health snapshots give the same candidate order: healthy
    READY replicas, least loaded first, ids breaking ties, replicas the
    request already failed on last resort only."""
    snaps = _SNAPSHOTS[case]
    (port, reps), (jax_r, jreps) = _both_routers(replicas=len(snaps))
    for stubs in (reps, jreps):
        for i, snap in enumerate(snaps):
            snap = dict(snap)
            if "state" in snap:
                stubs[f"r{i}"].state = snap.pop("state")
            stubs[f"r{i}"].h.update(snap)
    tried = _TRIED.get(case, set())
    freq = router_mod._FleetRequest(fid=0, n=1, tenant="t", priority=0, call={},
                                    deadline=None, ticket=None, tried=set(tried))
    jfreq = jax_router_mod._FleetRequest(fid=0, n=1, tenant="t", priority=0, call={},
                                         deadline=None, ticket=None, tried=set(tried))
    got = [rid for rid, _ in port._candidates(freq)]
    want = [rid for rid, _ in jax_r._candidates(jfreq)]
    assert got == want
    port.drain(timeout=0.1)
    jax_r.drain(timeout=0.1)


class FakeRouter:
    """Health-programmable router (tests/test_autoscale.py:18): the
    autoscaler only reads ``health()`` / ``target`` and calls ``scale_to``."""

    def __init__(self, target=2):
        self.target = target
        self.calls = []
        self.replicas = {f"r{i}": {"state": "ready", "queue_depth": 0,
                                   "open_tickets": 0, "latency_p95_s": 0.0}
                         for i in range(target)}
        self.pending = {}
        self.closed = False

    def set_load(self, queue_depth=0, p95_s=0.0, pending=0):
        for r in self.replicas.values():
            r["queue_depth"] = queue_depth
            r["latency_p95_s"] = p95_s
        self.pending = {"default": pending} if pending else {}

    def health(self):
        return {"replicas": {k: dict(v) for k, v in self.replicas.items()},
                "pending_by_tenant": dict(self.pending), "closed": self.closed}

    def scale_to(self, n):
        self.calls.append(n)
        self.target = n
        return n


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: (queue_depth, p95_s, pending, clock) per tick: pressure, a dead band,
#: noisy p95, a cooldown window, then idling down to the floor
_SERIES = ([(20, 0.0, 0, float(t)) for t in range(3)]
           + [(4, 0.1, 0, 3.0), (20, 0.1, 5, 4.0), (20, 0.1, 5, 5.0)]
           + [(4, 2.5 if t % 2 else 0.1, 0, 6.0 + t) for t in range(6)]
           + [(0, 0.0, 0, 12.0 + t) for t in range(10)]
           + [(0, 0.0, 0, 40.0 + t) for t in range(8)])


@pytest.mark.parametrize("kw", [
    dict(min_replicas=1, max_replicas=4, queue_high=8.0, queue_low=1.0,
         up_ticks=2, down_ticks=3, cooldown_s=5.0),
    dict(min_replicas=1, max_replicas=3, queue_high=2.0, queue_low=1.0,
         p95_high_s=1.0, p95_low_s=0.5, up_ticks=1, down_ticks=2, cooldown_s=0.0,
         warm_pool=1),
], ids=["hysteresis-cooldown", "p95-warm-pool"])
def test_autoscaler_decisions_match_jax(kw):
    """The same health series under the same injected clock gives the same
    decision, streaks and target every tick, the same scale_to calls and
    the same autoscale.* counters in both packages."""
    runs = []
    for cls in (Autoscaler, JaxAutoscaler):
        r, clock = FakeRouter(target=2), FakeClock()
        a = cls(r, clock=clock, **kw)
        trail = []
        for depth, p95, pending, t in _SERIES:
            clock.t = t
            r.set_load(queue_depth=depth, p95_s=p95, pending=pending)
            d = a.tick()
            trail.append((d["action"], d["up_streak"], d["down_streak"],
                          d["target"], r.target, d["queued"], d["p95_s"]))
        runs.append((trail, r.calls, {n: a.metrics.value(n) for n in (
            "autoscale.ticks", "autoscale.scale_ups", "autoscale.scale_downs",
            "autoscale.target")}))
    assert runs[0] == runs[1]
    assert runs[0][1], "the series must move the target"


def _scripted_fleet(router_cls, fleet_mod, main_mod, scaler_cls, config, **warm):
    """One scripted sequence over LocalReplica(StubEngine) handles: spawn
    two, flood a tenant past its share, serve, scale to one, let the
    autoscaler tick, drain. Returns the router's, the replicas' (summed) and
    the autoscaler's metric snapshots."""
    reps = []

    def factory(rid):
        rep = fleet_mod.LocalReplica(main_mod.StubEngine(rid))
        reps.append(rep)
        return rep

    router = router_cls(factory, replicas=2, configs=(config,), buckets=(4,),
                        tenants={"a": 3, "b": 1}, max_pending=8, auto_start=False,
                        drain_timeout_s=5.0, warm_kwargs=warm)
    tickets = []
    for i, tenant in enumerate(["a"] * 8 + ["b"] * 3):
        try:
            tickets.append(router.submit(seed=i, n=2, config=config, tenant=tenant))
        except Exception:  # noqa: BLE001 — the share's rejections are counted
            pass
    router.start()
    for t in tickets:
        t.result(timeout=30)
    clock = FakeClock()
    scaler = scaler_cls(router, min_replicas=1, max_replicas=2, down_ticks=2,
                        cooldown_s=0.0, clock=clock)
    decisions = [scaler.tick()["action"] for _ in range(3)]
    router.drain(timeout=5)
    fleet_snap: dict = {}
    for rep in reps:
        for key, n in rep.metrics.snapshot().get(
                "fleet.replica_transitions/by_key", {}).items():
            fleet_snap[key] = fleet_snap.get(key, 0) + n
    return (router.metrics.snapshot(), fleet_snap, scaler.metrics.snapshot(), decisions)


def test_metric_snapshots_match_jax():
    """The router.*, fleet.* and autoscale.* snapshots of one scripted
    sequence are JAX's, name for name and value for value."""
    port = _scripted_fleet(Router, fleet, replica_main, Autoscaler, CFG)
    want = _scripted_fleet(jax_router_mod.Router, jax_fleet, jax_replica_main,
                           JaxAutoscaler, JaxSamplerConfig(k=K), persistent_cache=False)
    assert port == want
    router_snap, fleet_snap, scale_snap, decisions = port
    assert router_snap["router.rejected"] == 3 and router_snap["router.completed"] == 8
    assert fleet_snap == {"new": 2, "ready": 2, "draining": 2, "closed": 2}
    assert scale_snap["autoscale.scale_downs"] == 1 and decisions == [None, "down", None]


# -------------------------------------------------- autoscaler (lifted units)


def _scaler(router, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("cooldown_s", 0.0)
    return Autoscaler(router, **kw)


def test_scale_up_needs_consecutive_overload_ticks():
    r = FakeRouter(target=2)
    a = _scaler(r, max_replicas=4, queue_high=2.0, up_ticks=3)
    r.set_load(queue_depth=5)
    assert [a.tick()["action"] for _ in range(3)] == [None, None, "up"]
    assert r.calls == [3]


def test_scale_down_needs_consecutive_underload_ticks():
    r = FakeRouter(target=3)
    a = _scaler(r, max_replicas=4, queue_low=1.0, down_ticks=3)
    r.set_load(queue_depth=0)
    assert [a.tick()["action"] for _ in range(3)] == [None, None, "down"]
    assert r.calls == [2]


def test_dead_band_resets_streaks():
    r = FakeRouter(target=2)
    a = _scaler(r, max_replicas=4, queue_low=1.0, queue_high=8.0, up_ticks=2)
    for _ in range(4):
        r.set_load(queue_depth=20)
        assert a.tick()["action"] is None
        r.set_load(queue_depth=4)
        assert a.tick()["action"] is None
    assert r.calls == []


def test_noisy_p95_does_not_flap_and_sustained_p95_scales():
    r = FakeRouter(target=2)
    a = _scaler(r, max_replicas=4, queue_low=1.0, queue_high=8.0,
                p95_high_s=1.0, up_ticks=2, down_ticks=2)
    for i in range(12):
        r.set_load(queue_depth=4, p95_s=2.5 if i % 2 else 0.1)
        a.tick()
    assert r.calls == []
    r = FakeRouter(target=2)
    a = _scaler(r, max_replicas=4, queue_high=100.0, p95_high_s=1.0, up_ticks=2)
    r.set_load(queue_depth=0, p95_s=2.5)
    assert [a.tick()["action"] for _ in range(2)] == [None, "up"]


def test_cooldown_blocks_consecutive_actions():
    clock = FakeClock()
    r = FakeRouter(target=1)
    a = _scaler(r, max_replicas=5, queue_high=1.0, up_ticks=1, cooldown_s=100.0,
                clock=clock)
    r.set_load(queue_depth=10)
    assert a.tick()["action"] == "up"
    for clock.t in (1.0, 10.0, 99.0):
        assert a.tick()["action"] is None
    clock.t = 150.0
    assert a.tick()["action"] == "up"
    assert r.calls == [2, 3]


def test_bounds_and_warm_pool_floor():
    r = FakeRouter(target=2)
    a = _scaler(r, max_replicas=2, queue_high=1.0, up_ticks=1)
    r.set_load(queue_depth=50)
    assert all(a.tick()["action"] is None for _ in range(5))
    r = FakeRouter(target=3)
    a = _scaler(r, min_replicas=1, max_replicas=4, warm_pool=1, down_ticks=1,
                queue_low=1.0)
    assert a.floor == 2
    r.set_load(queue_depth=0)
    assert a.tick()["action"] == "down"
    assert all(a.tick()["action"] is None for _ in range(5))
    assert r.calls == [2]


def test_autoscaler_validation_and_closed_router():
    r = FakeRouter()
    with pytest.raises(ValueError, match="min_replicas"):
        Autoscaler(r, min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        Autoscaler(r, min_replicas=2, max_replicas=2, warm_pool=1)
    with pytest.raises(ValueError, match="queue_low"):
        Autoscaler(r, queue_low=5.0, queue_high=1.0)
    r.closed = True
    a = _scaler(r, queue_high=1.0, up_ticks=1)
    r.set_load(queue_depth=50)
    assert a.tick()["action"] is None and r.calls == []


def test_read_signals_normalizes_per_ready_replica():
    r = FakeRouter(target=2)
    r.replicas["r0"].update(queue_depth=3, open_tickets=1, latency_p95_s=0.2)
    r.replicas["r1"].update(queue_depth=5, latency_p95_s=0.8)
    r.replicas["r2"] = {"state": "closed", "queue_depth": 99, "latency_p95_s": 9.9}
    r.pending = {"default": 7}
    sig = _scaler(r).read_signals()
    assert sig["ready"] == 2 and sig["queued"] == 3 + 1 + 5 + 7
    assert sig["queued_per_replica"] == pytest.approx(8.0)
    assert sig["p95_s"] == pytest.approx(0.8)


def test_start_asserts_warm_pool_floor_then_stops():
    r = FakeRouter(target=1)
    a = _scaler(r, min_replicas=1, max_replicas=4, warm_pool=2, interval_s=0.01)
    a.start()
    try:
        assert r.calls[:1] == [3]
    finally:
        a.stop()


def test_router_scale_to_down_retires_least_loaded():
    reps = {}
    router = Router(_stub_factory(reps), replicas=3, configs=(), auto_start=False)
    reps["r1"].h["queue_depth"] = 9
    assert router.scale_to(1) == 1 and router.target == 1
    h = router.health()
    assert h["active_replicas"] == 1 and h["retired_replicas"] == 2
    assert not reps["r1"].drained and reps["r0"].drained and reps["r2"].drained


def test_router_scale_to_excess_counts_ready_replicas_only():
    reps = {}
    router = Router(_stub_factory(reps), replicas=3, configs=(), auto_start=False)
    reps["r0"].state = fleet.CLOSED
    assert router.scale_to(2) == 2
    ready = [r for r in reps.values() if r.state == fleet.READY]
    assert len(ready) == 2 and not any(r.drained for r in ready)


def test_router_scale_to_clamps_and_ignores_when_closed():
    reps = {}
    router = Router(_stub_factory(reps), replicas=2, configs=(), auto_start=False)
    assert router.scale_to(0) == 1
    router.drain(timeout=1)
    before = router.target
    assert router.scale_to(5) == before


def test_autoscaler_scales_real_router_under_queue_pressure():
    """tick() → scale_to → supervision spawning on a real Router over stub
    replicas, converging on the new target."""
    reps = {}
    router = Router(_stub_factory(reps), replicas=2, configs=(), tick_s=0.01)
    a = Autoscaler(router, min_replicas=1, max_replicas=3, queue_high=2.0,
                   up_ticks=2, cooldown_s=0.0, clock=FakeClock())
    for rep in reps.values():
        rep.h["queue_depth"] = 10
    assert [a.tick()["action"] for _ in range(2)] == [None, "up"]
    assert _poll(lambda: router.health()["active_replicas"] == 3, 10)
    for rep in reps.values():
        rep.h["queue_depth"] = 0
    assert a.tick()["action"] is None
    h = router.drain(timeout=2)
    assert h["replicas_spawned"] == 3 and h["retired_replicas"] == 0


# ------------------------------------------------ launch counts under threads


@pytest.mark.parametrize("module", [fa, quant], ids=["flash_attention", "quant"])
def test_launch_counts_exact_from_eight_threads(module, monkeypatch):
    """Two in-process replicas launch kernels from two threads at once;
    ``count_launch`` serializes the Counter's read-modify-write, so eight
    threads of 5,000 increments each count exactly 40,000. The switch
    interval is cut to force interleavings."""
    import sys

    monkeypatch.setattr(module, "LAUNCHES", type(module.LAUNCHES)())
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)

        def work():
            barrier.wait()
            for _ in range(5000):
                module.count_launch("k")

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert module.LAUNCHES["k"] == 40000
