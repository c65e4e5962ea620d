"""Profiler-trace attribution: device time → named scopes → roofline/MFU.

Counterpart of ``ddim_cold_tpu/obs/attrib.py``, reading the traces the
port's profiler writes: Kineto's Chrome traces (``utils/profiling.trace``,
``start_trace``/``stop_trace``, ``span_trace``). xprof-shaped input, such as
the JAX package's checked-in fixture, is still read as the JAX module reads
it.

* :func:`load_trace` — Chrome trace-event JSON: the ``trace.json`` the
  port's writers leave in a directory, any ``*trace.json(.gz)`` file, a
  ``jax.profiler`` output directory, or an already-loaded dict.
* :func:`attribute` — splits each device's busy and idle time, joins every
  device op to the chain of registered scopes it ran under, and joins the
  scopes against ``utils/flops.py`` flop/byte estimates (achieved TFLOP/s,
  per-scope MFU, compute-vs-memory roofline class); it ranks fusion
  candidates — adjacent hot scopes separated by sub-``gap_us`` gaps.
* :func:`synthetic_demo_trace` / :func:`demo_scope_costs` — a
  deterministic Kineto-dialect trace of the JAX module's demo timeline.

How a Kineto trace differs from an xprof one, and what this module does:

* Device ops are the events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``. ``gpu_user_annotation`` ranges lie on the same lanes and
  would count twice, so they are not device work.
* A device is found from its ops (``args.device``, else the event's pid),
  never from process names: Kineto may name a GPU pid after the Python
  process and say "GPU n" only in ``process_labels``. Each tid under it is
  one CUDA stream holding different work (the engine assembles batches on
  a side stream), so busy time is the union over every stream of a device.
* A kernel event carries its (mangled) name and a ``correlation`` id, never
  the scope. The scope chain is found by the JAX module's text search of
  the event first (which keeps xprof input readable), then by a join: the
  correlation id → the host event that launched it (a ``cuda_runtime`` or
  ``cuda_driver`` event with that ``correlation``, else the ``ac2g`` flow
  start with that id) → the ``user_annotation`` ranges of registered scopes
  on that host thread that contain the launch, outer to inner. Launches
  come from the engine thread, its assembly thread and the autograd
  thread, so the stack is per (pid, tid). A device op whose launch is not
  in the trace stays unattributed: nothing is guessed from time overlap,
  since kernels run behind their launches, nor from a kernel's ``External
  id``, which names the outermost recorded operator around its launch (the
  flash ``autograd.Function``, say), not the innermost scope.

Host-only (graftcheck A004's rule): no torch import; traces are parsed
after the fact, often on a machine that never saw the device.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Optional

from ddim_cold_torch.utils import flops as flops_util

#: every scope ``profiling.scope`` plants (the JAX package's vocabulary,
#: kept whole): attribution's registry: device time matching none of these
#: is "unattributed", and the ≥90% coverage floor is measured against this
#: list. The port plants all but ``flash_attention/fused_proj`` (its fused
#: kernel writes the compute dtype itself, so that scope would hold no
#: device work); the three ``sp/`` scopes are planted in ``parallel/``
#: (the ring's exchange, Ulysses' two all-to-alls).
#: tests/test_torch_port_hygiene.py pins each planted one to a literal
#: call site.
REGISTERED_SCOPES = (
    "sampler/model",
    "sampler/cached_step",
    "flash_attention/fwd",
    "flash_attention/dq",
    "flash_attention/dkv",
    "flash_attention/fused_qkv",
    "flash_attention/fused_proj",
    "dequant_matmul/pallas",
    "mlp/pallas",
    "sp/ring_exchange",
    "sp/all_to_all_gather",
    "sp/all_to_all_scatter",
)

#: the acceptance floor of a serving capture: fraction of device-busy time
#: that must attribute to REGISTERED_SCOPES.
COVERAGE_FLOOR = 0.9

#: launch-gap ceiling (µs) for two adjacent scoped ops to count as a fusion
#: candidate pair.
DEFAULT_GAP_US = 50.0

DEMO_DEVICE_KIND = "NVIDIA H100 80GB HBM3"

#: Kineto's categories of device work, and of the host calls that launch it
DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class AttribError(ValueError):
    """A trace that cannot be parsed (missing file, bad JSON, no events)."""


_SCOPE = None


def _mscope():
    # lazy: scope ids are deterministic in construction order, so importing
    # this module must not consume one before the serving layers build theirs
    global _SCOPE
    if _SCOPE is None:
        from ddim_cold_torch.obs import metrics
        _SCOPE = metrics.scope("attrib")
    return _SCOPE


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _read_json(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", errors="replace") as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise AttribError(f"{path}: not a readable trace-event JSON ({e})")
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise AttribError(f"{path}: no traceEvents key — not a Chrome "
                          "trace-event dump")
    return obj


def _trace_files(root: str) -> list:
    """Trace-event JSON files under ``root``: the newest
    ``plugins/profile/<run>/`` run of a ``jax.profiler`` directory, else
    ``root`` itself; in either, every ``*trace.json(.gz)`` (the port's
    ``trace.json``, Kineto's ``<worker>.pt.trace.json``, xprof's per-host
    ``<host>.trace.json.gz``), else a ``perfetto_trace.json(.gz)``."""
    prof_root = os.path.join(root, "plugins", "profile")
    runs = sorted(
        d for d in (os.path.join(prof_root, n)
                    for n in (os.listdir(prof_root)
                              if os.path.isdir(prof_root) else []))
        if os.path.isdir(d))
    search = [runs[-1]] if runs else [root]
    for d in search:
        names = sorted(os.listdir(d))
        hits = [os.path.join(d, n) for n in names
                if n.endswith(("trace.json", "trace.json.gz"))
                and not n.startswith("perfetto_")]
        if not hits:
            hits = [os.path.join(d, n) for n in names
                    if n in ("perfetto_trace.json", "perfetto_trace.json.gz")]
        if hits:
            return hits
    return []


def load_trace(path) -> dict:
    """→ ``{"traceEvents": [...]}`` from a dict (passthrough), a ``.json`` /
    ``.json.gz`` file, or a directory (several dumps merge into one event
    list). Raises :exc:`AttribError` when nothing parseable is found."""
    if isinstance(path, dict):
        if "traceEvents" not in path:
            raise AttribError("trace dict has no traceEvents key")
        return path
    if os.path.isdir(path):
        files = _trace_files(path)
        if not files:
            raise AttribError(f"{path}: no trace-event JSON found (expected "
                              "trace.json, as utils/profiling.trace writes)")
        merged: list = []
        for f in files:
            merged.extend(_read_json(f).get("traceEvents") or [])
        return {"traceEvents": merged}
    return _read_json(path)


# ---------------------------------------------------------------------------
# lanes + scope matching
# ---------------------------------------------------------------------------

def _metadata_names(events) -> tuple:
    procs: dict = {}
    threads: dict = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        args = ev.get("args") or {}
        if ev.get("name") == "process_name":
            procs[ev.get("pid")] = str(args.get("name", ""))
        elif ev.get("name") == "thread_name":
            threads[(ev.get("pid"), ev.get("tid"))] = str(args.get("name", ""))
    return procs, threads


def _is_device_process(name: str) -> bool:
    # xprof device planes are "/device:TPU:0 ..." (host planes "/host:CPU");
    # GPU exports sometimes drop the /device: prefix
    return ("/device:" in name and "/device:CPU" not in name) or \
        name.startswith(("TPU", "GPU"))


def scope_chain(event) -> tuple:
    """The ordered REGISTERED_SCOPES appearing in the event's text — its
    name, then each string arg (xprof stamps ``named_scope`` paths there,
    nested outer→inner, so positional order in the text IS the hierarchy).
    Empty tuple = no scope in the text."""
    texts = [str(event.get("name", ""))]
    args = event.get("args") or {}
    for v in args.values():
        if isinstance(v, str):
            texts.append(v)
    for text in texts:
        found = [(text.index(s), s) for s in REGISTERED_SCOPES if s in text]
        if found:
            return tuple(s for _, s in sorted(found))
    return ()


def _merged_busy(intervals) -> tuple:
    """(union-seconds, merged [(start, end)]) over µs intervals."""
    if not intervals:
        return 0.0, []
    ivs = sorted(intervals)
    merged = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) * 1e-6, merged


def _device_op_lanes(events) -> dict:
    """xprof input: {(pid, tid): [complete events]} — per device process,
    the ONE lane that looks like the op timeline: most scope-matching
    events, ties broken by event count. xprof emits several lanes per
    device (XLA Modules, Steps, framework ops); summing them would
    double-count busy time."""
    procs, _ = _metadata_names(events)
    by_lane: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("dur") is None:
            continue
        if not _is_device_process(procs.get(ev.get("pid"), "")):
            continue
        by_lane.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    chosen: dict = {}
    best: dict = {}
    for (pid, tid), evs in by_lane.items():
        score = (sum(1 for e in evs if scope_chain(e)), len(evs))
        if pid not in best or score > best[pid]:
            best[pid] = score
            chosen[pid] = ((pid, tid), evs)
    return dict(chosen.values())


def _is_device_op(ev) -> bool:
    return (ev.get("ph") == "X" and ev.get("dur") is not None
            and str(ev.get("cat", "")).lower() in DEVICE_OP_CATS)


def _kineto_devices(events) -> tuple:
    """Kineto input: ({device: [device ops of every stream]}, number of
    (device, stream) lanes). A device is its ops' ``args.device``, else
    their pid; a stream is ``args.stream``, else their tid."""
    devices: dict = {}
    lanes = set()
    for ev in events:
        if not _is_device_op(ev):
            continue
        args = ev.get("args") or {}
        dev = args.get("device", ev.get("pid"))
        devices.setdefault(dev, []).append(ev)
        lanes.add((dev, args.get("stream", ev.get("tid"))))
    return devices, len(lanes)


def _launch_chains(events, ops) -> dict:
    """{correlation id: scope chain} for the device ``ops``: each op's host
    launch (a ``cuda_runtime``/``cuda_driver`` event with its
    ``correlation``, else the ``ac2g`` flow start with that id), then the
    registered ``user_annotation`` ranges on the launching (pid, tid) that
    contain the launch, outer to inner. One sweep per host thread."""
    wanted = {(ev.get("args") or {}).get("correlation") for ev in ops}
    wanted.discard(None)
    launch: dict = {}
    flow: dict = {}
    anns: dict = {}
    for ev in events:
        ph, cat = ev.get("ph"), str(ev.get("cat", "")).lower()
        if ph == "X" and cat == "user_annotation" and ev.get("name") in REGISTERED_SCOPES:
            anns.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif ph == "X" and cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr in wanted:
                launch[corr] = (ev.get("pid"), ev.get("tid"), ev["ts"])
        elif ph == "s" and cat == "ac2g" and ev.get("id") in wanted:
            flow[ev["id"]] = (ev.get("pid"), ev.get("tid"), ev["ts"])
    per_thread: dict = {}
    for corr in wanted:
        loc = launch.get(corr) or flow.get(corr)
        if loc is not None:
            per_thread.setdefault(loc[:2], []).append((loc[2], corr))
    chains: dict = {}
    for thread, launches in per_thread.items():
        ranges = sorted(anns.get(thread, ()), key=lambda r: (r[0], -r[1]))
        stack: list = []
        i = 0
        for t, corr in sorted(launches):
            while i < len(ranges) and ranges[i][0] <= t:
                while stack and stack[-1][1] < ranges[i][0]:
                    stack.pop()
                stack.append(ranges[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            chain: list = []
            for lo, hi, name in stack:
                if lo <= t <= hi and name not in chain:
                    chain.append(name)
            chains[corr] = tuple(chain)
    return chains


def _timelines(events) -> tuple:
    """→ ([per device: [(ts, dur, chain)]], lanes). Kineto input when the
    trace holds any Kineto device op, else the JAX module's xprof lanes."""
    devices, n_lanes = _kineto_devices(events)
    if not devices:
        lanes = _device_op_lanes(events)
        return ([[(ev["ts"], ev["dur"], scope_chain(ev)) for ev in evs]
                 for evs in lanes.values()], len(lanes))
    joined = _launch_chains(events, [ev for evs in devices.values() for ev in evs])
    out = []
    for evs in devices.values():
        ops = []
        for ev in evs:
            chain = scope_chain(ev) or joined.get(
                (ev.get("args") or {}).get("correlation"), ())
            ops.append((ev["ts"], ev["dur"], chain))
        out.append(ops)
    return out, n_lanes


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def attribute(trace, *, device_kind: Optional[str] = None, scope_costs=None,
              gap_us: float = DEFAULT_GAP_US) -> dict:
    """Attribute a loaded trace (or path — see :func:`load_trace`) to the
    registered scope hierarchy.

    ``scope_costs`` maps scope → ``{"flops", "bytes"}`` for the WHOLE
    captured window (``flops_util.vit_scope_costs`` × images × model calls),
    optionally with ``"int8_fraction"``: the share of the scope's FLOPs
    that run at the card's int8 rate (w8a8), which sets the peak its MFU
    divides by (``flops_util.mixed_peak_tflops``). With costs and a
    recognized ``device_kind``, each scope gains achieved TFLOP/s, MFU and
    a roofline class. Per-scope time is reported both exclusive
    (``self_s``: the scope was the innermost match) and inclusive
    (``total_s``: the scope was anywhere on the chain) — MFU divides the
    inclusive time, matching the inclusive cost model.
    """
    trace = load_trace(trace)
    events = trace.get("traceEvents") or []
    timelines, n_lanes = _timelines(events)
    peak = flops_util.peak_tflops(device_kind) if device_kind else None
    ridge = (flops_util.ridge_flops_per_byte(device_kind)
             if device_kind else None)

    busy_s = idle_s = window_s = attributed_s = 0.0
    scopes: dict = {}
    children: dict = {}
    pair_gaps: dict = {}
    for ops in timelines:
        ivs = [(ts, ts + dur) for ts, dur, _ in ops]
        lane_busy, merged = _merged_busy(ivs)
        busy_s += lane_busy
        lo = min(s for s, _ in merged)
        hi = max(e for _, e in merged)
        window_s += (hi - lo) * 1e-6
        idle_s += (hi - lo) * 1e-6 - lane_busy
        scoped = []
        for ts, dur_us, chain in ops:
            if not chain:
                continue
            scoped.append((ts, ts + dur_us, chain))
            dur = dur_us * 1e-6
            leaf = chain[-1]
            node = scopes.setdefault(leaf, {"events": 0, "self_s": 0.0,
                                            "total_s": 0.0})
            node["events"] += 1
            node["self_s"] += dur
            for i, s in enumerate(chain):
                scopes.setdefault(s, {"events": 0, "self_s": 0.0,
                                      "total_s": 0.0})["total_s"] += dur
                if i:
                    children.setdefault(chain[i - 1], set()).add(s)
        attributed_s += _merged_busy([(s, e) for s, e, _ in scoped])[0]
        # fusion candidates: consecutive scoped ops on the device separated
        # by a gap small enough that one fused kernel would absorb it
        scoped.sort()
        for (s0, e0, c0), (s1, e1, c1) in zip(scoped, scoped[1:]):
            gap = s1 - e0
            if 0 <= gap <= gap_us:
                key = (c0[-1], c1[-1])
                agg = pair_gaps.setdefault(key, {"count": 0, "gap_us": 0.0,
                                                 "busy_us": 0.0})
                agg["count"] += 1
                agg["gap_us"] += gap
                agg["busy_us"] += (e0 - s0) + (e1 - s1)

    coverage = attributed_s / busy_s if busy_s else None
    for name, node in scopes.items():
        node["share_of_busy"] = (round(node["self_s"] / busy_s, 4)
                                 if busy_s else None)
        cost = (scope_costs or {}).get(name)
        node.update(flops=None, bytes=None, achieved_tflops=None, mfu=None,
                    flops_per_byte=None, roofline=None)
        if cost and node["total_s"]:
            fl = float(cost.get("flops") or 0.0)
            by = float(cost.get("bytes") or 0.0)
            node["flops"] = fl
            node["bytes"] = by
            node["achieved_tflops"] = round(fl / node["total_s"] / 1e12, 4)
            scope_peak = peak
            if peak and cost.get("int8_fraction"):
                scope_peak = flops_util.mixed_peak_tflops(
                    device_kind, cost["int8_fraction"])
            if scope_peak:
                node["mfu"] = round(fl / (node["total_s"] * scope_peak * 1e12), 4)
            if by:
                node["flops_per_byte"] = round(fl / by, 2)
                if ridge is not None:
                    node["roofline"] = ("compute-bound" if fl / by >= ridge
                                        else "hbm-bound")
        node["self_s"] = round(node["self_s"], 6)
        node["total_s"] = round(node["total_s"], 6)

    fusion = sorted(
        ({"pair": list(pair), "count": agg["count"],
          "total_gap_us": round(agg["gap_us"], 1),
          "mean_gap_us": round(agg["gap_us"] / agg["count"], 2),
          "combined_busy_us": round(agg["busy_us"], 1)}
         for pair, agg in pair_gaps.items()),
        key=lambda c: (-c["total_gap_us"], -c["combined_busy_us"]))

    report = {
        "device_kind": device_kind,
        "device_lanes": n_lanes,
        "peak_bf16_tflops": peak,
        "hbm_gb_s": flops_util.hbm_gb_s(device_kind) if device_kind else None,
        "ridge_flops_per_byte": (round(ridge, 1) if ridge is not None
                                 else None),
        "window_s": round(window_s, 6),
        "device_busy_s": round(busy_s, 6),
        "idle_s": round(idle_s, 6),
        "busy_fraction": round(busy_s / window_s, 4) if window_s else None,
        "coverage": round(coverage, 4) if coverage is not None else None,
        "scopes": scopes,
        "tree": {p: sorted(kids) for p, kids in children.items()},
        "fusion_candidates": fusion,
    }
    m = _mscope()
    m.inc("attrib.traces")
    m.gauge("attrib.coverage_pct",
            round(100 * coverage, 2) if coverage is not None else None)
    m.gauge("attrib.device_busy_s", report["device_busy_s"])
    return report


def ranked_scopes(report: dict) -> list:
    """[(name, node)] slowest-first by exclusive time — the report table's
    row order (the top row is where the next optimization round digs)."""
    return sorted(report.get("scopes", {}).items(),
                  key=lambda kv: -kv[1]["self_s"])


# ---------------------------------------------------------------------------
# synthetic fixture (demo)
# ---------------------------------------------------------------------------

#: one sampler step of the demo timeline: (µs duration, kernel name, scope
#: chain outer→inner — () = deliberately unattributed overhead). The JAX
#: module's demo step: the same durations, gaps and scopes. The durations
#: are synthetic, chosen so the per-step attributed share is 935/990 ≈ 94.4%;
#: they are no measurement of any device.
_DEMO_STEP = (
    (30, "void at::native::vectorized_elementwise_kernel<copy>", ()),
    (180, "sm90_xmma_gemm_bf16bf16_bf16f32_qkv", ("sampler/model",)),
    (260, "flash_fwd_bf16_wgmma", ("sampler/model", "flash_attention/fwd")),
    (90, "dequant_mm_bf16_wgmma", ("sampler/model", "dequant_matmul/pallas")),
    (310, "sm90_xmma_gemm_bf16bf16_bf16f32_mlp", ("sampler/model",)),
    (40, "void at::native::where_kernel", ("sampler/cached_step",)),
    (55, "ncclDevKernel_AllToAll", ("sp/all_to_all_gather",)),
    (25, "void at::native::vectorized_elementwise_kernel<copy>", ()),
)
_DEMO_STEPS = 4
_DEMO_GAP_US = 5
#: the demo's one memcpy, on a second stream: it starts this many µs after
#: step 0's last kernel ends (inside the 205 µs the device then idles), so
#: it adds exactly its own duration to the device's busy time
_DEMO_MEMCPY = (50, 100)
#: how far the demo's host launches run ahead of their kernels (µs)
_DEMO_LEAD_US = 500
_DEMO_HOST_PID, _DEMO_GPU_PID, _DEMO_STREAM, _DEMO_COPY_STREAM = 4242, 0, 7, 13


def synthetic_demo_trace() -> dict:
    """A deterministic Kineto Chrome trace of the JAX module's demo:
    ``_DEMO_STEPS`` sampler steps of ``_DEMO_STEP`` kernels on one stream
    of GPU 0 at fixed 5 µs gaps, each kernel with a correlation id; on the
    host thread a ``cudaLaunchKernel`` per kernel, ``_DEMO_LEAD_US`` ahead,
    inside the ``user_annotation`` ranges of its scope chain, and the
    ``gpu_user_annotation`` mirror of each range on the stream (not device
    work); plus one device-to-host memcpy on a second stream."""
    meta = (
        ("process_name", _DEMO_HOST_PID, None, {"name": "python3"}),
        ("thread_name", _DEMO_HOST_PID, _DEMO_HOST_PID, {"name": "thread 4242 (python3)"}),
        ("process_name", _DEMO_GPU_PID, None, {"name": "python3"}),
        ("process_labels", _DEMO_GPU_PID, None, {"labels": "GPU 0"}),
        ("thread_name", _DEMO_GPU_PID, _DEMO_STREAM, {"name": f"stream {_DEMO_STREAM}"}),
        ("thread_name", _DEMO_GPU_PID, _DEMO_COPY_STREAM,
         {"name": f"stream {_DEMO_COPY_STREAM}"}),
    )
    events = []
    for name, pid, tid, args in meta:
        ev = {"ph": "M", "name": name, "pid": pid, "args": args}
        if tid is not None:
            ev["tid"] = tid
        events.append(ev)

    corr = 100
    ts = 1000

    def launch(api, host_ts, cat, dev_name, dev_ts, dur, stream, chain=()):
        nonlocal corr
        corr += 1
        for depth, scope in enumerate(chain):  # outer ranges start earlier
            pad = len(chain) - depth
            events.append({"ph": "X", "cat": "user_annotation", "name": scope,
                           "pid": _DEMO_HOST_PID, "tid": _DEMO_HOST_PID,
                           "ts": host_ts - pad, "dur": 2 + 2 * pad})
            events.append({"ph": "X", "cat": "gpu_user_annotation", "name": scope,
                           "pid": _DEMO_GPU_PID, "tid": stream, "ts": dev_ts,
                           "dur": dur, "args": {"device": 0, "stream": stream}})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": api,
                       "pid": _DEMO_HOST_PID, "tid": _DEMO_HOST_PID,
                       "ts": host_ts, "dur": 2, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": cat, "name": dev_name,
                       "pid": _DEMO_GPU_PID, "tid": stream, "ts": dev_ts,
                       "dur": dur, "args": {"device": 0, "stream": stream,
                                            "correlation": corr}})

    for step in range(_DEMO_STEPS):
        for dur, name, chain in _DEMO_STEP:
            launch("cudaLaunchKernel", ts - _DEMO_LEAD_US, "kernel", name, ts,
                   dur, _DEMO_STREAM, chain)
            ts += dur + _DEMO_GAP_US
        if step == 0:
            after, dur = _DEMO_MEMCPY
            start = ts - _DEMO_GAP_US + after
            launch("cudaMemcpyAsync", start - _DEMO_LEAD_US, "gpu_memcpy",
                   "Memcpy DtoH (Device -> Pinned)", start, dur, _DEMO_COPY_STREAM)
        ts += 200  # inter-step idle gap (device waits on the host)
    return {"displayTimeUnit": "ms", "traceEvents": events}


def demo_scope_costs() -> dict:
    """Window costs paired with :func:`synthetic_demo_trace` (device kind
    ``DEMO_DEVICE_KIND``): the JAX module's synthetic demo costs, which on
    the H100's ridge (≈295 FLOP/B) leave one compute-bound scope (flash
    fwd, 300 FLOP/B) and the rest memory-bound — both roofline branches
    exercised. No number here is a measurement."""
    return {
        "sampler/model": {"flops": 3.3e10, "bytes": 2.2e8},
        "flash_attention/fwd": {"flops": 1.2e10, "bytes": 4.0e7},  # ≥ ridge
        "dequant_matmul/pallas": {"flops": 4.0e9, "bytes": 5.0e7},
        "sampler/cached_step": {"flops": 1.0e8, "bytes": 1.0e7},
        "sp/all_to_all_gather": {"flops": 0.0, "bytes": 2.0e7},
    }


def demo_report(gap_us: float = DEFAULT_GAP_US) -> dict:
    """The demo trace attributed end to end."""
    return attribute(synthetic_demo_trace(), device_kind=DEMO_DEVICE_KIND,
                     scope_costs=demo_scope_costs(), gap_us=gap_us)
