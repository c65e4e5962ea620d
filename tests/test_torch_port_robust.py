"""The port's serving robustness layer against the JAX engine's.

Replays ``tests/test_serve.py``'s chaos, deadline, queue, drain, stall and
warmup cases and ``tests/test_obs.py``'s engine cases against the port's
``Engine`` on the CPU (TINY: 16 px, patch 4, C=32, depth 2, k=500 = 4
steps, buckets (4, 8)).

The JAX engine is held as the oracle of the fault SCHEDULE only: on the
same requests and specs, the port realizes the same plan at the sites
whose call order is deterministic (dispatch, fetch, preview: the
dispatching thread fires them), and fails and quarantines the same
requests. Its rows are not compared: rows are bitwise only at one
dispatch shape within one package. Every row that completes is bitwise the
port's own direct ``ddim_sample`` on the batch it was dispatched in (the
plan recorded at fetch, rebuilt from each request's own start).
"""

import gc
import os
import random
import re
import subprocess
import sys
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.obs import metrics, spans
from ddim_cold_torch.ops import sampling
from ddim_cold_torch.serve.batching import plan_batches
from ddim_cold_torch.utils import faults
from ddim_cold_tpu import serve as jax_serve
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.utils import faults as jax_faults

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K = 500  # 4 reverse steps
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_state():
    for f in (faults, jax_faults):
        assert not f.active(), "a previous test leaked an armed fault scope"
    yield
    for f in (faults, jax_faults):
        assert not f.active(), "this test leaked an armed fault scope"
    assert not spans.enabled(), "this test leaked an enabled tracing state"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """TINY batches are thousands of microsecond ops: with a team of intra-op
    threads per op, a loaded host (the suite's six workers) stalls every op
    at its barrier. One thread computes the same bits."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    return PortViT(**TINY, use_flash=True, device="cpu")


def _engine(model, buckets=(4, 8), **kw):
    kw.setdefault("retry_base_s", 0.0)
    eng = serve.Engine(model, buckets=buckets, device="cpu", **kw)
    cfg = serve.SamplerConfig(k=K)
    assert serve.warmup(eng, [cfg])["new_programs"] == len(eng.buckets)
    return eng, cfg


@pytest.fixture(scope="module")
def warmed(model):
    return _engine(model)


@pytest.fixture(scope="module")
def jax_engine():
    """The schedule oracle: the JAX engine at the same geometry and
    buckets, retries without backoff."""
    jm = DiffusionViT(**TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                     jnp.zeros((2,), jnp.int32))["params"]
    eng = jax_serve.Engine(jm, params, buckets=(4, 8), retry_base_s=0.0)
    cfg = jax_serve.SamplerConfig(k=K)
    jax_serve.warmup(eng, [cfg], persistent_cache=False)
    return eng, cfg


def _starts(model, reqs):
    return {s: sampling.fresh_start(model, torch.Generator().manual_seed(s), n, "cpu")
            for s, n in reqs}


def _direct_batch(model, plan, starts):
    """The port's direct sampler on the batch ``plan`` dispatched: each
    entry's rows of its request's own start at its offset, zero padding (a
    preview config's result is its trajectory's last frame)."""
    x = torch.zeros((plan.bucket, 16, 16, 3))
    for req, lo, hi, off in plan.entries:
        x[off:off + hi - lo] = starts[int(req.key)][lo:hi]
    seq = plan.config.preview_every > 0
    out = sampling.ddim_sample(model, x_init=x, k=K, return_sequence=seq, device="cpu")
    return (out[-1] if seq else out).numpy()


def _check_survivors(model, reqs, tickets, plans):
    """Every completed row equals the direct call on its dispatched batch;
    returns the seeds that completed."""
    starts = _starts(model, reqs)
    done = set()
    for plan in plans:
        live = [e for e in plan.entries if not e[0].ticket.failed]
        if not live:
            continue
        want = _direct_batch(model, plan, starts)
        for req, lo, hi, off in live:
            got = req.ticket.result(timeout=5)[lo:hi]
            np.testing.assert_array_equal(got, want[off:off + hi - lo])
            done.add(int(req.key))
    assert done == {s for s, _ in reqs if not tickets[s].failed}
    return done


def _norm(tag, base):
    return re.sub(r"req:(\d+)\|", lambda m: f"req:{int(m.group(1)) - base}|", tag)


def _serve(eng, cfg, fault_mod, specs, reqs, record=False):
    """Submit ``reqs`` under ``specs(base_rid)`` and drain. Returns the
    realized plan (rids relative to the first request), each request's
    outcome, the quarantined request indices, the report, the tickets and
    (``record``) the plans that reached the fetch."""
    base = eng._next_rid
    finished = []
    if record:
        eng._finish = lambda plan, out, f=type(eng)._finish: (
            finished.append(plan), f(eng, plan, out))
    try:
        with fault_mod.inject(*specs(base)) as plan:
            tickets = {s: eng.submit(seed=s, n=n, config=cfg) for s, n in reqs}
            report = eng.run()
            realized = [(r["site"], r["call"], _norm(r["tag"], base), r["kind"])
                        for r in plan.realized]
    finally:
        eng.__dict__.pop("_finish", None)
    outcomes = []
    for s, _ in reqs:
        exc = tickets[s].exception(timeout=30)  # raises on a hung ticket
        outcomes.append(None if exc is None else type(exc).__name__)
    quarantined = sorted(r - base for r in eng.quarantined if r >= base)
    return realized, outcomes, quarantined, report, tickets, finished


# ------------------------------------------------------------ disarmed path


@pytest.mark.parametrize("depth,window", [(2, 2), (1, 1), (3, 4)])
def test_disarmed_rows_bitwise_and_no_program_added(model, depth, window):
    """With faults disarmed and tracing off, every row is bitwise the
    direct call on its bucket batch (the plans of ``plan_batches``), for
    any prefetch depth and in-flight window, and serving adds no program."""
    eng, cfg = _engine(model, prefetch_depth=depth, inflight=window)
    reqs = list(zip(range(200, 210), [3, 5, 2, 8, 1, 4, 6, 2, 7, 3]))
    tickets = {s: eng.submit(seed=s, n=n, config=cfg) for s, n in reqs}
    report = eng.run()
    assert (report["batches"], report["rows"], report["programs"]) == (6, 41, 0)
    assert (report["retries"], report["quarantined"], report["stalled"]) == (0, 0, False)
    assert eng.stats["programs"] == 2 and eng.stats["dispatches"] == 6
    pending = [serve.Request(config=cfg, n=n, key=s, ticket=tickets[s]) for s, n in reqs]
    _check_survivors(model, reqs, tickets, plan_batches(pending, eng.buckets))
    assert not spans.spans()


# --------------------------------------------------- chaos, held to the JAX engine


CHAOS = {
    "transient-dispatch": (
        lambda F, b: (F.FaultSpec("serve.dispatch", "transient", rate=0.35, seed=11),),
        list(zip(range(200, 210), [3, 5, 2, 8, 1, 4, 6, 2, 7, 3]))),
    "every-site": (
        lambda F, b: (F.FaultSpec("serve.assemble", "permanent", rate=0.25, seed=2),
                      F.FaultSpec("serve.dispatch", "transient", rate=0.3, seed=3),
                      F.FaultSpec("serve.fetch", "permanent", rate=0.25, seed=4)),
        list(zip(range(300, 312), [2, 3, 1, 4, 2, 5, 3, 2, 1, 6, 2, 3]))),
    "bisection": (
        lambda F, b: (F.FaultSpec("serve.dispatch", "permanent", match=f"req:{b + 2}|"),),
        list(zip(range(410, 415), [2, 1, 2, 1, 2]))),
    "preview": (
        lambda F, b: (F.FaultSpec("serve.preview", "permanent", rate=0.5, seed=7),
                      F.FaultSpec("serve.fetch", "transient", at=(1,))),
        list(zip(range(600, 612), [2, 3, 1, 2, 4, 1, 3, 5, 2, 1, 6, 2]))),
    # chip_smoke.py's serve-chaos schedule, on the same plans
    "chip-serve-chaos": (
        lambda F, b: (F.FaultSpec("serve.dispatch", "transient", rate=0.3, seed=11),
                      F.FaultSpec("serve.dispatch", "permanent", match=f"req:{b + 4}|"),
                      F.FaultSpec("serve.assemble", "permanent", match=f"req:{b + 9}|",
                                  max_fires=1),
                      F.FaultSpec("serve.fetch", "permanent", max_fires=1, seed=4)),
        list(zip(range(300, 310), [3, 5, 2, 8, 1, 4, 6, 2, 7, 3]))),
}


@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_schedule_and_outcomes_match_jax(model, warmed, jax_engine, case):
    """The same specs on the same requests: the port realizes the JAX
    engine's plan at the deterministic sites (dispatch, fetch; assembly
    runs ahead on a thread, so only its tags and kinds are compared),
    fails and quarantines the same requests with the same error types,
    retries as often; every failure is typed with the injected fault as
    its cause, every survivor is bitwise at its dispatch shape, no program
    is built and nothing hangs."""
    specs, reqs = CHAOS[case]
    eng, cfg = warmed
    jeng, jcfg = jax_engine
    if case == "preview":
        cfg = serve.SamplerConfig(k=K, preview_every=1)
        jcfg = jax_serve.SamplerConfig(k=K, preview_every=1)
        serve.warmup(eng, [cfg])
        jax_serve.warmup(jeng, [jcfg], persistent_cache=False)
    programs = eng.stats["programs"]
    want = _serve(jeng, jcfg, jax_faults, lambda b: specs(jax_faults, b), reqs)
    got = _serve(eng, cfg, faults, lambda b: specs(faults, b), reqs, record=True)
    realized, outcomes, quarantined, report, tickets, finished = got

    def ordered(r):
        return [x for x in r if x[0] != "serve.assemble"]

    def assembled(r):
        return sorted((t, k) for s, _, t, k in r if s == "serve.assemble")

    assert ordered(realized) == ordered(want[0]) and realized
    assert assembled(realized) == assembled(want[0])
    assert outcomes == want[1]
    assert quarantined == want[2]
    for key in ("batches", "rows", "retries", "quarantined", "failed_tickets"):
        assert report[key] == want[3][key], key
    for s, _ in reqs:
        exc = tickets[s].exception(timeout=5)
        if exc is not None:
            assert isinstance(exc, serve.RequestFailedError)
            assert isinstance(exc.__cause__, faults.FaultError)
    _check_survivors(model, reqs, tickets, finished)
    transient = sum(1 for r in realized
                    if r[3] == "transient" and r[0] == "serve.dispatch")
    if case != "every-site":
        assert report["retries"] == transient
    assert eng.stats["programs"] == programs
    if case == "preview":
        assert {r[0] for r in realized} == {"serve.preview", "serve.fetch"}
        assert 0 < outcomes.count(None) < len(reqs)
    if case == "chip-serve-chaos":
        assert outcomes[4] == "RequestQuarantinedError"
        assert isinstance(tickets[304].exception().__cause__, faults.PermanentFault)
    # the scope closed: the engine serves clean
    t = eng.submit(seed=399, n=3, config=cfg)
    eng.run()
    x = torch.cat([_starts(model, [(399, 3)])[399], torch.zeros((1, 16, 16, 3))])
    np.testing.assert_array_equal(
        t.result(timeout=5),
        sampling.ddim_sample(model, x_init=x, k=K, device="cpu").numpy()[:3])


def test_fetch_corrupt_is_detectable(model, warmed):
    eng, cfg = warmed
    with faults.inject(faults.FaultSpec("serve.fetch", "corrupt", seed=5,
                                        max_fires=1)) as plan:
        t = eng.submit(seed=420, n=4, config=cfg)
        eng.run()
        out = t.result(timeout=5)
    assert plan.realized[0]["detail"]["index"] >= 0
    clean = _direct_batch(model, serve.BatchPlan(
        cfg, 4, ((serve.Request(cfg, 4, key=420), 0, 4, 0),), 4),
        _starts(model, [(420, 4)]))
    assert int(np.isnan(out).sum()) == int((out != clean).sum()) == 1


def test_deadline_enforced_at_plan_and_dispatch(warmed):
    eng, cfg = warmed
    t0 = eng.submit(seed=430, n=2, config=cfg, deadline_s=0.0)
    time.sleep(0.01)
    eng.run()
    assert isinstance(t0.exception(timeout=5), serve.DeadlineExceeded)
    skipped0 = eng.stats["skipped_batches"]
    expired0 = eng.metrics.by_key("engine.deadline_expired")
    t1 = eng.submit(seed=431, n=4, config=cfg, deadline_s=0.3)
    with faults.inject(faults.FaultSpec("serve.assemble", "latency",
                                        latency_s=0.6, max_fires=1)):
        eng.run()
    assert isinstance(t1.exception(timeout=5), serve.DeadlineExceeded)
    assert eng.stats["skipped_batches"] == skipped0 + 1
    expired = eng.metrics.by_key("engine.deadline_expired")
    assert expired.get("dispatch", 0) == expired0.get("dispatch", 0) + 1
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(seed=0, n=1, config=cfg, deadline_s=-1)


def test_bounded_queue_rejects_and_drain_fails_queued(model):
    eng = serve.Engine(model, buckets=(4,), max_queue=2, device="cpu")
    cfg = serve.SamplerConfig(k=K)
    a = eng.submit(seed=0, n=1, config=cfg)
    b = eng.submit(seed=1, n=1, config=cfg)
    with pytest.raises(serve.QueueFullError, match="max_queue=2"):
        eng.submit(seed=2, n=1, config=cfg)
    assert eng.stats["rejected"] == 1 and eng.health()["queue_depth"] == 2
    health = eng.drain(timeout=1)
    assert health["closed"] and health["idle"] and health["queue_depth"] == 0
    for t in (a, b):
        assert isinstance(t.exception(timeout=5), serve.EngineClosedError)
    with pytest.raises(serve.EngineClosedError):
        eng.submit(seed=3, n=1, config=cfg)
    with pytest.raises(ValueError, match="max_queue"):
        serve.Engine(model, buckets=(4,), max_queue=0, device="cpu")


def test_drain_timeout_skips_sweep_when_not_idle(model):
    eng, cfg = _engine(model, buckets=(4,))
    a = eng.submit(seed=460, n=2, config=cfg)
    with faults.inject(faults.FaultSpec("serve.dispatch", "latency",
                                        latency_s=0.4, max_fires=1)):
        worker = threading.Thread(target=eng.run, daemon=True)
        worker.start()
        deadline = time.time() + 5
        while (eng.queue_depth() > 0 or not eng.health()["running"]) \
                and time.time() < deadline:
            time.sleep(0.005)
        b = eng.submit(seed=461, n=1, config=cfg)
        report = eng.drain(timeout=0.05)
        assert report["idle"] is False
        assert not a.done and not b.done
        worker.join(timeout=10)
        assert not worker.is_alive()
    plan = serve.BatchPlan(cfg, 4, ((serve.Request(cfg, 2, key=460), 0, 2, 0),), 2)
    np.testing.assert_array_equal(
        a.result(timeout=5), _direct_batch(model, plan, _starts(model, [(460, 2)]))[:2])
    assert isinstance(b.exception(timeout=5), serve.EngineClosedError)
    assert eng.drain(timeout=5)["idle"] is True


def test_health_keys_match_jax_and_timeout_message(model, jax_engine):
    """health() has the JAX engine's keys (``programs`` for ``compiles``)
    and the supervision fields; a timed-out waiter sees the last stage."""
    eng, cfg = _engine(model, buckets=(4,), max_queue=5, replica_id="rX")
    want = set(jax_engine[0].health()) - {"compiles"} | {"programs"}
    h = eng.health()
    assert set(h) == want
    assert h["replica"] == "rX" and h["max_queue"] == 5 and h["programs"] == 1
    t = eng.submit(seed=470, n=1, config=cfg)
    eng.run()
    t.result(timeout=30)
    h2 = eng.health()
    assert h2["uptime_s"] > h["uptime_s"] and h2["last_progress_s"] < h2["uptime_s"]
    assert h2["last_stage"].startswith("fetch") and h2["stalled_for_s"] >= 0.0
    t2 = eng.submit(seed=471, n=1, config=cfg)
    with pytest.raises(TimeoutError, match="last seen at stage"):
        t2.result(timeout=0.01)
    eng.drain(timeout=5)


def test_stall_fails_tickets_not_the_process(model):
    """A dispatch silent past the stall budget trips the soft watchdog: the
    open ticket fails with EngineStalledError, run() returns flagged, and
    the next drain serves again."""
    eng, cfg = _engine(model, buckets=(4,), stall_s=0.2)
    t = eng.submit(seed=440, n=4, config=cfg)
    with faults.inject(faults.FaultSpec("serve.dispatch", "latency",
                                        latency_s=0.6, max_fires=1)):
        report = eng.run()
    assert report["stalled"]
    assert isinstance(t.exception(timeout=5), serve.EngineStalledError)
    assert eng.stats["stalls"] == 1 and eng.health()["stalled"]
    eng.stall_s = 30.0  # each run arms a fresh watchdog; a loaded host is slow
    t2 = eng.submit(seed=441, n=2, config=cfg)
    assert not eng.run()["stalled"]
    plan = serve.BatchPlan(cfg, 4, ((serve.Request(cfg, 2, key=441), 0, 2, 0),), 2)
    np.testing.assert_array_equal(
        t2.result(timeout=5), _direct_batch(model, plan, _starts(model, [(441, 2)]))[:2])


@pytest.mark.parametrize("stall_s", [0.0, 30.0])
def test_failures_do_not_pin_the_engine(model, stall_s):
    """A failure a ticket stores keeps its cause and a note of the frames it
    passed through, but no traceback: the engine frames' locals hold the
    batch (its ticket, its inputs and outputs) and the engine, so a kept
    failure would otherwise pin them in a cycle until the garbage
    collector runs. Quarantine, an assembly and a fetch failure each; with
    the watchdog armed, its thread (a 7.5 s poll here) has ended too."""
    eng, cfg = _engine(model, buckets=(4,), stall_s=stall_s)
    tickets = [eng.submit(seed=s, n=n, config=cfg) for s, n in ((450, 2), (451, 2), (452, 1))]
    with faults.inject(faults.FaultSpec("serve.dispatch", "permanent", match="req:1|"),
                       faults.FaultSpec("serve.fetch", "permanent", max_fires=1),
                       faults.FaultSpec("serve.assemble", "permanent", match="req:2|")):
        eng.run()
    errors = [t.exception(timeout=5) for t in tickets]
    assert [type(e).__name__ for e in errors] == [
        "RequestFailedError", "RequestQuarantinedError", "RequestFailedError"]
    for e in errors:
        assert isinstance(e.__cause__, faults.PermanentFault)
        assert e.__cause__.__traceback__ is None
        assert "Traceback (frames released)" in "\n".join(e.__cause__.__notes__)
    ref = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng, tickets
        assert ref() is None, "a stored failure keeps the engine alive"
    finally:
        if collecting:
            gc.enable()


def test_warmup_tolerate_errors(model):
    cfg = serve.SamplerConfig(k=K)
    eng = serve.Engine(model, buckets=(4, 8), device="cpu")
    with faults.inject(faults.FaultSpec("serve.compile", "permanent", max_fires=1)):
        with pytest.raises(faults.PermanentFault):
            serve.warmup(eng, [cfg])
        report = serve.warmup(eng, [cfg], tolerate_errors=True)
    assert report["errors"] == {} and report["programs"] == 2
    eng2 = serve.Engine(model, buckets=(4, 8), device="cpu")
    with faults.inject(faults.FaultSpec("serve.compile", "permanent", max_fires=1)):
        report = serve.warmup(eng2, [cfg], tolerate_errors=True)
    assert list(report["errors"]) == [(cfg, 4)] and report["new_programs"] == 1
    assert eng2.metrics.value("warmup.new_programs") == 1
    assert eng2.metrics.value("warmup.programs") == 1


# --------------------------------------------------------- spans and stats


def test_spans_share_a_trace_and_close_under_chaos(model, warmed, tmp_path):
    """Traced chaos with bisection: each request's span closes (completed
    with its latency, or with the error), its stages are children of it in
    its trace, and the exports round-trip. Untraced, the same seeds serve
    the same bits and record nothing."""
    eng, cfg = warmed
    reqs = list(zip(range(500, 504), [3, 2, 4, 1]))
    plain = {s: eng.submit(seed=s, n=n, config=cfg) for s, n in reqs}
    eng.run()
    assert spans.spans() == []
    base = eng._next_rid
    with spans.tracing():
        with faults.inject(
                faults.FaultSpec("serve.dispatch", "permanent", match=f"req:{base + 1}|"),
                faults.FaultSpec("serve.dispatch", "transient", at=(0,))):
            tickets = {s: eng.submit(seed=s, n=n, config=cfg) for s, n in reqs}
            eng.run()
        roots = [s for s in spans.spans() if s.name == "engine.request"]
        assert len(roots) == 4 and all(s.ended for s in roots)
        assert [("error" in s.attrs) for s in roots] == [False, True, False, False]
        by_trace = {s.trace_id: s for s in roots}
        assert len(by_trace) == 4
        stages = [s for s in spans.spans() if s.name != "engine.request"]
        assert {s.name for s in stages} >= {"plan", "assemble", "dispatch", "fetch"}
        assert all(s.parent_id == by_trace[s.trace_id].span_id for s in stages)
        doc = spans.export_chrome(str(tmp_path / "t.json"))
        rows = spans.export_jsonl(str(tmp_path / "t.jsonl"))
        assert len(doc["traceEvents"]) == len(rows) == len(spans.spans())
    spans.clear()
    for s, _ in reqs:
        if not tickets[s].failed:
            np.testing.assert_array_equal(tickets[s].result(timeout=5),
                                          plain[s].result(timeout=5))
    assert isinstance(tickets[501].exception(), serve.RequestQuarantinedError)


def test_stats_is_a_registry_view(model):
    eng, cfg = _engine(model, buckets=(4,))
    for seed in (191, 192):
        eng.submit(seed=seed, n=2, config=cfg)
    eng.run()
    s, m = eng.stats, eng.metrics
    assert s["programs"] == m.value("engine.programs") == 1
    assert s["dispatches"] == m.value("engine.dispatches") == 1
    assert s["rows"] == m.value("engine.rows") == 4
    assert s["latencies_s"] == m.samples("engine.latency_s") and len(s["latencies_s"]) == 2
    assert s["param_bytes"] == m.raw("engine.param_bytes") > 0
    assert s["param_bytes_quant"] is m.raw("engine.param_bytes_quant") is None
    assert metrics.snapshot()[m.sid] == m.snapshot()
    port_keys = {"programs", "dispatches", "rows", "padded_rows", "failed_tickets",
                 "max_queue_depth", "preview_frames", "param_bytes",
                 "param_bytes_quant", "latencies_s", "retries", "failed_batches",
                 "quarantined", "deadline_expired", "rejected", "skipped_batches",
                 "stalls"}
    assert set(s) == port_keys
    with pytest.raises(ValueError, match="unregistered"):
        m.inc("engine.not_a_metric")


def test_replica_id_in_failure_messages_and_fault_tags(model):
    eng, cfg = _engine(model, buckets=(4,), replica_id="r9")
    with faults.inject(faults.FaultSpec("serve.dispatch", "permanent",
                                        match="replica:r9|")) as plan:
        t = eng.submit(seed=480, n=1, config=cfg)
        eng.run()
        exc = t.exception(timeout=5)
    assert isinstance(exc, serve.RequestQuarantinedError)
    assert "replica 'r9'" in str(exc)
    assert plan.realized and all(r["tag"].startswith("replica:r9|")
                                 for r in plan.realized)
    t2 = eng.submit(seed=481, n=1, config=cfg)
    eng.drain(timeout=1)
    assert "replica 'r9'" in str(t2.exception(timeout=5))


def test_engine_knobs_take_jax_defaults():
    import inspect

    port = inspect.signature(serve.Engine).parameters
    jax_sig = inspect.signature(jax_serve.Engine).parameters
    for name in ("prefetch_depth", "inflight", "max_queue", "max_retries",
                 "retry_base_s", "retry_cap_s", "stall_s", "replica_id"):
        assert port[name].default == jax_sig[name].default, name
    assert port["device"].default is None


def test_env_armed_faults_in_subprocess():
    """``DDIM_COLD_FAULTS`` arms the process lazily at the first fire: a
    served request's only dispatch fails permanently and is quarantined."""
    code = f"""
import sys; sys.path.insert(0, {ROOT!r})
from ddim_cold_torch import serve
from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.utils import faults
m = DiffusionViT(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
                 num_heads=4, device="cpu")
eng = serve.Engine(m, buckets=(4,), device="cpu")
t = eng.submit(seed=0, n=1, k=500)
eng.run()
print(type(t.exception(timeout=30)).__name__, faults.snapshot()["injected"])
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, DDIM_COLD_FAULTS="serve.dispatch:permanent:at=0"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["RequestQuarantinedError", "1"]


def test_submit_drain_race_no_lost_tickets(model):
    """Submitters, a run loop and a drain race (tests/test_thread_stress.py):
    every admitted ticket resolves exactly once, completed or
    EngineClosedError, and none hangs."""
    eng, cfg = _engine(model, buckets=(4,))
    tickets: list = []
    tlock = threading.Lock()
    rejected = [0]
    drained = threading.Event()

    def submitter(seed):
        rng = random.Random(seed)
        for i in range(4):
            if i:
                time.sleep(rng.random() * 0.02)
            try:
                t = eng.submit(seed=seed * 100 + i, n=1, config=cfg)
            except serve.EngineClosedError:
                rejected[0] += 1
                continue
            with tlock:
                tickets.append(t)

    def runner():
        while True:
            eng.run()
            if drained.is_set():
                return
            time.sleep(0.001)

    def drainer():
        time.sleep(0.03)
        assert eng.drain(timeout=60.0)["idle"]
        drained.set()

    threads = [threading.Thread(target=fn) for fn in
               [lambda s=s: submitter(s) for s in range(5)] + [runner, drainer]]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    eng.run()
    assert tickets
    completed = 0
    for t in tickets:
        err = t.exception(timeout=60.0)
        if err is None:
            assert t.result(0).shape == (1, 16, 16, 3)
            completed += 1
        else:
            assert isinstance(err, serve.EngineClosedError), err
    assert len(tickets) + rejected[0] == 5 * 4
