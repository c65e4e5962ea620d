"""The port's host-only robustness modules against the JAX package's.

``obs/metrics.py``, ``obs/spans.py``, ``utils/faults.py``,
``utils/watchdog.py``, ``utils/platform.watchdog_stall_s``,
``utils/profiling.span_trace``, ``data/loader.background_map`` and the error
taxonomy of ``serve/errors.py``: driven by the same specs, emits and call
sequences as their JAX counterparts, they realize the same fault plans,
snapshots and exports; the watchdog replays ``tests/test_watchdog.py`` and
the thread races of ``tests/test_thread_stress.py`` hold against the port's
``Ticket`` and registry. No model, no device.
"""

import dataclasses
import os
import random
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from ddim_cold_torch.data import loader as port_loader
from ddim_cold_torch.obs import metrics as port_metrics
from ddim_cold_torch.obs import spans as port_spans
from ddim_cold_torch.serve import errors as port_errors
from ddim_cold_torch.serve.batching import Ticket
from ddim_cold_torch.utils import faults as port_faults
from ddim_cold_torch.utils import platform as port_platform
from ddim_cold_torch.utils import profiling as port_profiling
from ddim_cold_torch.utils.watchdog import StallWatchdog
from ddim_cold_tpu.obs import metrics as jax_metrics
from ddim_cold_tpu.obs import spans as jax_spans
from ddim_cold_tpu.serve import errors as jax_errors
from ddim_cold_tpu.utils import faults as jax_faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_state():
    """Faults and tracing are process-global: every test starts and ends
    with nothing armed and tracing off, in both packages."""
    for f in (port_faults, jax_faults):
        assert not f.active(), "a previous test leaked an armed fault scope"
    yield
    for f in (port_faults, jax_faults):
        assert not f.active(), "this test leaked an armed fault scope"
    for s in (port_spans, jax_spans):
        assert not s.enabled(), "this test leaked an enabled tracing state"


# ------------------------------------------------------------------ faults


def _fire_sequence(faults, specs, calls):
    """Fire ``calls`` — (site, tag, payload) — under ``specs``; return the
    realized plan, the snapshot, what each call raised and returned."""
    outcomes = []
    with faults.inject(*[faults.FaultSpec(**s) for s in specs]) as plan:
        for site, tag, payload in calls:
            try:
                out = faults.fire(site, tag=tag, payload=payload)
                outcomes.append(("ok", None if out is None else out.tobytes()))
            except faults.FaultError as e:
                outcomes.append((type(e).__name__, str(e)))
        snap = faults.snapshot()
        realized = [dict(r) for r in plan.realized]
        replay = [dataclasses.asdict(s) for s in plan.replay()]
    return realized, snap, outcomes, replay


def _calls(n=40):
    rs = np.random.RandomState(3)
    sites = ("serve.assemble", "serve.dispatch", "serve.fetch", "serve.preview")
    out = []
    for i in range(n):
        site = sites[rs.randint(len(sites))]
        tag = f"bucket:{4 << rs.randint(2)}|req:{i % 7}|"
        payload = rs.randn(6).astype(np.float32) if site == "serve.fetch" else None
        out.append((site, tag, payload))
    return out


FAULT_CASES = {
    "transient-rate": [dict(site="serve.dispatch", kind="transient", rate=0.35, seed=11)],
    "every-site": [dict(site="serve.assemble", kind="permanent", rate=0.25, seed=2),
                   dict(site="serve.dispatch", kind="transient", rate=0.3, seed=3),
                   dict(site="serve.fetch", kind="permanent", rate=0.25, seed=4)],
    "match-and-cap": [dict(site="serve.dispatch", kind="permanent", match="req:3|"),
                      dict(site="serve.fetch", kind="transient", max_fires=2, seed=9)],
    "at-and-corrupt": [dict(site="serve.preview", kind="transient", at=(0, 2)),
                       dict(site="serve.fetch", kind="corrupt", rate=0.5, seed=5)],
    "latency": [dict(site="serve.assemble", kind="latency", latency_s=0.0, rate=0.5,
                     seed=1)],
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_faults_realize_jax_plan(case):
    """Same specs, same call sequence: the same realized plan (site, call,
    tag, kind, spec, corrupt index), snapshot, raises, corrupted payloads
    and replay specs in both packages."""
    specs, calls = FAULT_CASES[case], _calls()
    want = _fire_sequence(jax_faults, specs, calls)
    got = _fire_sequence(port_faults, specs, calls)
    assert got[0] == want[0] and got[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]


def test_fault_tables_and_validation_match_jax():
    assert port_faults.SITES == jax_faults.SITES
    assert port_faults.KINDS == jax_faults.KINDS
    assert port_faults.ENV_VAR == jax_faults.ENV_VAR == "DDIM_COLD_FAULTS"
    assert set(port_faults.KIND_EXCEPTIONS) == set(jax_faults.KIND_EXCEPTIONS)
    for kw, match in ((dict(site="serve.nope"), "unknown fault site"),
                      (dict(site="serve.dispatch", kind="explode"), "kind"),
                      (dict(site="serve.dispatch", rate=1.5), "rate")):
        with pytest.raises(ValueError, match=match):
            jax_faults.FaultSpec(**kw)
        with pytest.raises(ValueError, match=match):
            port_faults.FaultSpec(**kw)
    buf = np.arange(6.0)
    assert port_faults.fire("serve.dispatch", tag="bucket:8|", payload=buf) is buf
    assert port_faults.current_plan() is None
    assert port_faults.snapshot() == {"armed": 0, "injected": 0, "by_site": {}}


def test_fault_scopes_stack_and_reset():
    outer = port_faults.FaultSpec("serve.dispatch", "transient", at=(1,))
    inner = port_faults.FaultSpec("serve.fetch", "transient", at=(0,))
    with port_faults.inject(outer) as plan:
        port_faults.fire("serve.dispatch")
        with port_faults.inject(inner):
            assert port_faults.current_plan() is plan
            with pytest.raises(port_faults.TransientFault):
                port_faults.fire("serve.fetch")
        with pytest.raises(port_faults.TransientFault):
            port_faults.fire("serve.dispatch")
        assert plan.by_site() == {"serve.fetch": 1, "serve.dispatch": 1}
    assert port_faults.current_plan() is None


@pytest.mark.parametrize("text", [
    "serve.dispatch:transient:rate=0.2,seed=7;serve.fetch:latency:latency_s=0.5;"
    "ckpt.save:permanent:match=window:mid-swap|,max_fires=1;data.next:corrupt:at=0+3",
    "serve.fetch:hang:hang_s=3.0,max_fires=1",
    " serve.assemble:permanent ; ",
    "serve.dispatch",
    "serve.dispatch:transient:boom=1",
])
def test_parse_specs_grammar_matches_jax(text):
    try:
        want = [dataclasses.asdict(s) for s in jax_faults.parse_specs(text)]
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            port_faults.parse_specs(text)
        return
    assert [dataclasses.asdict(s) for s in port_faults.parse_specs(text)] == want


def test_faults_injected_metric():
    def injected():
        return sum(series.get("faults.injected/by_key", {}).get("serve.preview", 0)
                   for sid, series in port_metrics.snapshot().items()
                   if sid.startswith("faults#"))

    before = injected()
    with port_faults.inject(port_faults.FaultSpec("serve.preview", "latency",
                                                  latency_s=0.0)):
        port_faults.fire("serve.preview", tag="t")
    assert injected() == before + 1


def test_error_taxonomy_matches_jax():
    """The port's error classes carry JAX's names and bases, and the
    retryable set is derived from the fault registry's transient table."""
    names = ("ServeError", "QueueFullError", "DeadlineExceeded",
             "RequestFailedError", "RequestQuarantinedError",
             "EngineClosedError", "EngineStalledError")
    for name in names:
        port_cls, jax_cls = getattr(port_errors, name), getattr(jax_errors, name)
        assert ([b.__name__ for b in port_cls.__mro__]
                == [b.__name__ for b in jax_cls.__mro__])
    assert port_errors.RETRYABLE_EXCEPTIONS == (port_faults.TransientFault,
                                                ConnectionError)
    assert not issubclass(port_faults.PermanentFault,
                          port_errors.RETRYABLE_EXCEPTIONS)


# ----------------------------------------------------------------- metrics


def _emit(reg):
    a, b = reg.scope("engine"), reg.scope("engine")
    for i in range(5):
        a.inc("engine.dispatches")
        a.inc("engine.rows", 3)
        a.inc("engine.failed_batches", key="dispatch" if i % 2 else "plan")
        a.observe("engine.latency_s", 0.01 * i)
    a.gauge("engine.max_queue_depth", 4)
    a.gauge("engine.max_queue_depth", 2)
    b.inc("engine.retries", 2)
    b.inc("engine.deadline_expired", key="plan")
    return a, b


def test_metrics_snapshots_match_jax():
    """The same emits on fresh registries of both packages give equal
    snapshots, scope ids and read surfaces."""
    pa, pb = _emit(port_metrics.Registry())
    ja, jb = _emit(jax_metrics.Registry())
    assert (pa.sid, pb.sid) == (ja.sid, jb.sid) == ("engine#0", "engine#1")
    assert pa._reg.snapshot() == ja._reg.snapshot()
    for name in ("engine.dispatches", "engine.rows", "engine.max_queue_depth"):
        assert pa.value(name) == ja.value(name)
    assert pa.by_key("engine.failed_batches") == ja.by_key("engine.failed_batches")
    assert pa.samples("engine.latency_s") == ja.samples("engine.latency_s")
    assert pa.raw("engine.param_bytes") is None
    with pytest.raises(ValueError, match="unregistered"):
        pa.inc("engine.not_a_metric")
    with pytest.raises(ValueError, match="gauge"):
        pa.inc("engine.param_bytes")
    pa._reg.reset()
    assert pa._reg.snapshot() == {}
    assert pa._reg.scope("engine").sid == "engine#2"


def test_metrics_catalog_renames_compiles_to_programs():
    port = {name: kind for name, kind, _ in port_metrics.METRICS}
    jax_cat = {name: kind for name, kind, _ in jax_metrics.METRICS}
    rename = {"engine.compiles": "engine.programs",
              "warmup.new_compiles": "warmup.new_programs"}
    ported = ("engine", "warmup", "faults", "router", "fleet", "remote", "autoscale",
              "attrib", "trend")
    for name, kind in jax_cat.items():
        name = rename.get(name, name)
        if name.split(".")[0] in ported and name in port:
            assert port[name] == kind
    expected = {rename.get(n, n) for n in jax_cat if n.split(".")[0] in ported}
    # the JAX engine's program aliasing (warmup dedup) has no port analogue
    assert set(port) == expected - {"engine.program_aliases", "warmup.deduped"}
    # the fleet's, attribution's and trend's rows are JAX's: names, kinds
    # and help texts
    jax_rows = {row[0]: row for row in jax_metrics.METRICS}
    fleet_rows = [row for row in port_metrics.METRICS
                  if row[0].split(".")[0] in ("router", "fleet", "remote", "autoscale")]
    assert len(fleet_rows) == 21
    assert all(row == jax_rows[row[0]] for row in fleet_rows)
    obs_rows = [row for row in port_metrics.METRICS
                if row[0].split(".")[0] in ("attrib", "trend")]
    assert len(obs_rows) == 5
    assert all(row == jax_rows[row[0]] for row in obs_rows)


# ------------------------------------------------------------------- spans


def _trace(spans_mod):
    rec = spans_mod.Recorder()
    root = rec.begin("engine.request", rid=0, n=3)
    child = root.child("assemble", bucket=8)
    child.end()
    rec.record(root, "dispatch", 0.1, 0.2, bucket=8)
    other = rec.begin("engine.request", rid=1, n=1)
    other.set(extra=1)
    root.end(rows=3)
    rec.begin("open", parent=other.ctx)
    return rec


def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in ("ts", "dur", "t0", "t1")}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def test_span_exports_match_jax(tmp_path):
    """Same span operations, same chrome and jsonl structure (timestamps
    aside); the files round-trip."""
    port_rec, jax_rec = _trace(port_spans), _trace(jax_spans)
    chrome = port_rec.export_chrome(str(tmp_path / "t.json"))
    assert _strip_times(chrome) == _strip_times(jax_rec.export_chrome())
    rows = port_rec.export_jsonl(str(tmp_path / "t.jsonl"))
    assert _strip_times(rows) == _strip_times(jax_rec.export_jsonl())
    assert [r["t1"] is None for r in rows] == [False, False, False, True, True]
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == len(rows)
    for ev in chrome["traceEvents"]:
        assert ev["ph"] == "X" and ev["ts"] >= 0 and ev["dur"] >= 0


def test_begin_returns_null_when_disabled():
    s = port_spans.begin("anything", rid=1)
    assert s is port_spans.NULL and not s
    s.set(a=1).child("x").end()
    port_spans.record(s, "stage", 0.0, 1.0)
    n = len(port_spans.spans())
    with port_spans.tracing():
        assert port_spans.begin("x")
    assert len(port_spans.spans()) == n + 1
    port_spans.clear()


def test_span_trace_dir_is_span_keyed(tmp_path):
    with port_spans.tracing():
        sp = port_spans.begin("bench.obs")
        with port_profiling.span_trace(str(tmp_path), sp):
            torch.zeros((2, 2)).sum()
        sp.end()
    sub = tmp_path / f"trace_{sp.ctx.trace_id}_{sp.ctx.span_id}"
    assert (sub / "trace.json").exists()
    with port_profiling.span_trace(str(tmp_path / "plain"), None):
        pass
    assert (tmp_path / "plain" / "trace.json").exists()
    port_spans.clear()


# ---------------------------------------------------------------- watchdog


def _run_script(body, timeout=30):
    code = ("import sys, time\nsys.path.insert(0, %r)\n" % ROOT
            + "from ddim_cold_torch.utils.watchdog import StallWatchdog\n" + body)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                          capture_output=True, text=True)
    return proc, time.time() - t0


def test_watchdog_hard_mode_aborts_marks_budget_and_disarm(tmp_path):
    """tests/test_watchdog.py's subprocess cases in one process each: a
    stall exits 3 after on_abort; marks keep it alive, a budget stretches
    one window, done() and stall_s <= 0 disarm."""
    marker = tmp_path / "partial.txt"
    proc, dt = _run_script(f"""
def on_abort(label, silent):
    open({str(marker)!r}, "w").write(f"{{label}}|{{silent:.1f}}")
wd = StallWatchdog(0.4, on_abort=on_abort, name="t").start()
wd.mark("the-silent-op")
time.sleep(30)
""")
    assert proc.returncode == 3 and dt < 10
    assert marker.read_text().startswith("the-silent-op|")
    assert "STALL" in proc.stderr
    proc, _ = _run_script("""
wd = StallWatchdog(0.5, name="t").start()
for i in range(4):
    wd.mark(f"step {i}")
    time.sleep(0.2)
wd.mark("long op", budget_s=5.0)
time.sleep(0.9)
wd.mark("fast op")
wd.done()
time.sleep(0.7)
StallWatchdog(0.0, name="off").start()
time.sleep(0.2)
print("survived")
""")
    assert proc.returncode == 0, proc.stderr
    assert "survived" in proc.stdout


def test_watchdog_done_ends_its_thread():
    """done() wakes the watchdog thread and joins it: at a 900 s budget (a
    15 s poll) neither the thread nor ``on_abort``'s owner outlives it."""
    class Owner:
        def on_abort(self, label, silent):
            pass

    owner = Owner()
    ref = weakref.ref(owner)
    wd = StallWatchdog(900.0, exit_code=None, on_abort=owner.on_abort, name="t").start()
    thread = wd._thread
    t0 = time.time()
    wd.done()
    assert time.time() - t0 < 5 and not thread.is_alive()
    del owner, wd
    assert ref() is None


def test_watchdog_soft_mode_calls_abort_without_exit():
    calls = []
    wd = StallWatchdog(0.2, exit_code=None,
                       on_abort=lambda label, silent: calls.append(label),
                       name="soft").start()
    wd.mark("wedged-op")
    deadline = time.time() + 10
    while not calls and time.time() < deadline:
        time.sleep(0.05)
    assert calls == ["wedged-op"]
    time.sleep(0.3)
    assert calls == ["wedged-op"]
    assert wd._state["done"]


def test_watchdog_stall_s_resolution(monkeypatch):
    """An env value wins (0 disarms, empty means unset); else 0 on the CPU
    and the accelerator default on CUDA (the device need not exist)."""
    env = "DDIM_COLD_TEST_STALL_S"
    monkeypatch.delenv(env, raising=False)
    assert port_platform.watchdog_stall_s(env, 900.0, "cpu") == 0.0
    assert port_platform.watchdog_stall_s(env, 900.0, "cuda") == 900.0
    assert port_platform.watchdog_stall_s(env, 900.0, torch.device("cuda", 1)) == 900.0
    monkeypatch.setenv(env, "")
    assert port_platform.watchdog_stall_s(env, 900.0, "cuda") == 900.0
    monkeypatch.setenv(env, "0")
    assert port_platform.watchdog_stall_s(env, 900.0, "cuda") == 0.0
    monkeypatch.setenv(env, "2.5")
    assert port_platform.watchdog_stall_s(env, 900.0, "cpu") == 2.5


# ---------------------------------------------------------- background_map


def test_background_map_yields_in_order_and_surfaces_errors():
    assert list(port_loader.background_map(range(6), lambda i: i * i, 2)) == [
        0, 1, 4, 9, 16, 25]

    def boom(i):
        if i == 3:
            raise KeyError("item 3")
        return i

    got = []
    with pytest.raises(KeyError, match="item 3"):
        for v in port_loader.background_map(range(6), boom, 2):
            got.append(v)
    assert got == [0, 1, 2]


def test_background_map_close_stops_the_producer():
    produced = []

    def slow(i):
        produced.append(i)
        return i

    before = threading.active_count()
    gen = port_loader.background_map(iter(range(10_000)), slow, 2)
    assert next(gen) == 0
    gen.close()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) <= n + 1 and n < 10
    assert threading.active_count() <= before


# ------------------------------------------------------------ thread races


@pytest.fixture
def fine_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _spawn(fns, seed):
    """Run ``fns`` concurrently behind a barrier with a seeded stagger;
    re-raise the first worker exception (tests/test_thread_stress.py)."""
    rng = random.Random(seed)
    staggers = [rng.random() * 1e-4 for _ in fns]
    barrier = threading.Barrier(len(fns))
    errors = []

    def runner(fn, stagger):
        barrier.wait()
        time.sleep(stagger)
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — reported to the test
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(fn, st))
               for fn, st in zip(fns, staggers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_ticket_resolution_race_first_wins(fine_switching):
    rows = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for round_ in range(60):
        t = Ticket(4)
        wins: list = []
        cb_counts = [0, 0]

        def register(i, t=t, cb_counts=cb_counts):
            def cb(_tk, i=i):
                cb_counts[i] += 1
            t.add_done_callback(cb)

        def deliver(lo, t=t, wins=wins):
            if t._deliver(lo, lo + 1, rows[lo:lo + 1]):
                wins.append("deliver")

        def fail(i, t=t, wins=wins):
            if t._fail(RuntimeError(f"cancel-{i}")):
                wins.append("fail")

        _spawn([lambda lo=lo: deliver(lo) for lo in range(4)]
               + [lambda i=i: fail(i) for i in range(2)]
               + [lambda i=i: register(i) for i in range(2)], seed=round_)
        assert wins in (["deliver"], ["fail"]), wins
        err = t.exception(timeout=5.0)
        if wins == ["deliver"]:
            assert err is None and np.array_equal(t.result(0), rows)
        else:
            assert isinstance(err, RuntimeError)
        assert cb_counts == [1, 1]


def test_preview_delivery_vs_registration(fine_switching):
    steps = 12
    frame = np.ones((2, 3), np.float32)
    for round_ in range(20):
        t = Ticket(2)
        seen = [dict() for _ in range(3)]

        def register(d, t=t):
            def cb(step, frames, d=d):
                d[step] = d.get(step, 0) + 1
            t.add_preview_callback(cb)

        def produce(t=t):
            for step in range(steps):
                t._preview(step, 0, 2, frame)

        _spawn([lambda d=d: register(d) for d in seen] + [produce] * 3,
               seed=1000 + round_)
        history = [s for s, _f in t._phistory]
        assert sorted(history) == list(range(steps))
        for d in seen:
            assert d == {s: 1 for s in range(steps)}, d


def test_metrics_emit_vs_render_atomic_views(fine_switching):
    reg = port_metrics.Registry()
    sc = reg.scope("engine")
    n_per, emitters = 150, 6
    stop = threading.Event()
    torn: list = []

    def emit():
        for j in range(n_per):
            sc.inc("engine.rows", 1)
            sc.inc("engine.failed_batches", 1, key="dispatch" if j % 2 else "plan")
            sc.observe("engine.latency_s", 0.001 * j)

    def render():
        while not stop.is_set():
            snap = reg.snapshot().get(sc.sid, {})
            total = snap.get("engine.failed_batches")
            by_key = snap.get("engine.failed_batches/by_key")
            if total is not None and (by_key is None or total != sum(by_key.values())):
                torn.append((total, by_key))

    renderers = [threading.Thread(target=render) for _ in range(2)]
    for r in renderers:
        r.start()
    try:
        _spawn([emit] * emitters, seed=7)
    finally:
        stop.set()
        for r in renderers:
            r.join(timeout=30)
    assert torn == []
    expect = emitters * n_per
    assert sc.value("engine.rows") == sc.value("engine.failed_batches") == expect
    assert sc.by_key("engine.failed_batches") == {
        "dispatch": emitters * (n_per // 2), "plan": emitters * (n_per - n_per // 2)}
    assert sc.count("engine.latency_s") == expect
