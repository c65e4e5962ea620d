"""The port's observability layer against the JAX package's, on the CPU.

* ``utils/flops``: every analytic function equals JAX's on a grid of
  configs (integers exactly, floats to rel 1e-12; the peak-dependent ones
  with one shared table patched into both modules); ``vit_scope_costs``
  equals JAX's for every key but ``flash_attention/fused_proj``; the H100
  lookups; the 200p4 figures the chip's attribution is read against.
* ``obs/attrib``: JAX's checked-in fixture and JAX's crafted xprof cases
  attribute report for report as JAX's ``attribute`` does; the port's
  Kineto demo gives JAX's demo scopes, tree, window and fusion pairs, its
  memcpy stream adding exactly its own time to busy; crafted Kineto cases
  (overlapping streams, a ``gpu_user_annotation``, nested annotations on a
  second host thread, every launch route, a kernel with no launch).
* a real CPU capture of the TINY engine: one ``sampler/model`` or
  ``sampler/cached_step`` range per forward of DDIM, inpaint, cold,
  few-step and a delta-cached config, and one ``flash_attention/fwd`` per
  layer-forward.
* ``utils/record`` and ``obs/trend``: the port's functions equal JAX's on
  the committed ``BENCH_r*.json`` / ``MULTICHIP_r*.json`` series run with
  JAX's checks, and on JAX's synthetic series cases.
* ``nan_checks``: a NaN weight makes JAX's TINY forward raise
  ``FloatingPointError`` under ``jax_debug_nans``, and the port's under
  ``profiling.enable_nan_checks``; both are off afterwards.
"""

import copy
import gzip
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.obs import attrib as pa
from ddim_cold_torch.obs import trend as pt
from ddim_cold_torch.ops import schedule, step_cache
from ddim_cold_torch.utils import flops as pf
from ddim_cold_torch.utils import profiling
from ddim_cold_torch.utils import record as prec
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT as JaxViT
from ddim_cold_tpu.obs import attrib as ja
from ddim_cold_tpu.obs import trend as jt
from ddim_cold_tpu.utils import flops as jf
from ddim_cold_tpu.utils import record as jrec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "attrib_trace.json")
H100 = "NVIDIA H100 80GB HBM3"
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4)


# ---------------------------------------------------------------- flops

GRID = [dict(img_size=img, patch_size=p, embed_dim=d, depth=depth, num_heads=h,
             mlp_ratio=r)
        for img, p, d, depth, h, r in itertools.product(
            ((16, 16), (64, 64), (200, 200), (64, 96)), (4, 8), (32, 256),
            (1, 6), (4,), (1.0, 4.0))]


def test_analytic_flops_equal_jax_on_a_grid():
    for kw in GRID:
        assert pf.vit_forward_flops(**kw) == jf.vit_forward_flops(**kw)
        assert pf.train_step_flops(16, **kw) == jf.train_step_flops(16, **kw)
        assert pf.vit_trunk_gemm_fraction(**kw) == pytest.approx(
            jf.vit_trunk_gemm_fraction(**kw), rel=1e-12)


def test_peak_functions_equal_jax_on_one_table(monkeypatch):
    """mixed_peak_tflops, ridge_flops_per_byte, mfu and the prefix lookup
    are JAX's functions: with one table patched into both modules they
    agree everywhere (the tables themselves differ by design)."""
    table = {"A": 100.0, "A long": 300.0, "B": 50.0}
    int8 = {"A": 400.0, "A long": 600.0}
    bw = {"A": 1000.0, "A long": 2000.0, "B": 500.0}
    for mod in (pf, jf):
        monkeypatch.setattr(mod, "PEAK_BF16_TFLOPS", table)
        monkeypatch.setattr(mod, "PEAK_INT8_TOPS", int8)
        monkeypatch.setattr(mod, "HBM_GB_S", bw)
    for kind, frac in itertools.product(("A", "A long x", "B", "C", "cpu"),
                                        (0.0, 0.25, 1.0, 1.5)):
        assert pf.mixed_peak_tflops(kind, frac) == jf.mixed_peak_tflops(kind, frac)
        assert pf.ridge_flops_per_byte(kind, frac) == jf.ridge_flops_per_byte(kind, frac)
        for secs in (0.0, 0.01):
            assert pf.mfu(1e12, secs, kind, 2, frac) == jf.mfu(1e12, secs, kind, 2, frac)
        assert pf._prefix_lookup(table, kind) == jf._prefix_lookup(table, kind)


def test_scope_costs_equal_jax_but_fused_proj():
    for kw in GRID[:8]:
        for flash, quant, fused in itertools.product((False, True), repeat=3):
            want = jf.vit_scope_costs(**kw, flash=flash, quant=quant, fused=fused)
            want.pop("flash_attention/fused_proj", None)
            assert pf.vit_scope_costs(**kw, flash=flash, quant=quant,
                                      fused=fused) == want


def test_h100_tables():
    rows = {"NVIDIA H100 80GB HBM3": (989.4, 1978.9, 3350.0, 80 << 30),
            "NVIDIA H100 PCIe": (756.5, 1513.0, 2000.0, 80 << 30),
            "NVIDIA H100 NVL": (835.5, 1671.0, 3900.0, 94 * 10**9)}
    for kind, (bf16, i8, bw, mem) in rows.items():
        assert (pf.peak_tflops(kind), pf.peak_int8_tops(kind), pf.hbm_gb_s(kind),
                pf.hbm_bytes(kind), pf.smem_bytes(kind)) == (bf16, i8, bw, mem, 232_448)
    # no bare prefix hands the SXM numbers to another part; unknowns are None
    for kind in ("NVIDIA H100", "NVIDIA H200", "cpu", "TPU v5 lite"):
        assert pf.peak_tflops(kind) is None and pf.hbm_gb_s(kind) is None
        assert pf.ridge_flops_per_byte(kind) is None
        assert pf.mfu(1e12, 1.0, kind) is None
    assert pf.ridge_flops_per_byte(H100) == pytest.approx(989.4e12 / 3350e9)


def test_200p4_figures():
    """The main path's shape: one image's forward 50.35 GFLOP, 38.43 of them
    attention; an 8-row k=20 batch (100 forwards) 40.3 TFLOP."""
    kw = dict(img_size=(200, 200), patch_size=4, embed_dim=256, depth=6,
              num_heads=4, mlp_ratio=1.0)
    fwd = pf.vit_forward_flops(**kw)
    costs = pf.vit_scope_costs(**kw, flash=True)
    assert round(fwd / 1e9, 2) == 50.35
    assert round(costs["flash_attention/fwd"]["flops"] / 1e9, 2) == 38.43
    assert costs["sampler/model"]["flops"] == fwd
    forwards = len(range(1999, 0, -20))
    assert forwards == 100 and round(forwards * 8 * fwd / 1e12, 1) == 40.3


# ------------------------------------------------ attribution: JAX input


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _crafted(events):
    meta = [{"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "/device:TPU:0"}},
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "XLA Ops"}}]
    return {"traceEvents": meta + events}


def _xprof_cases():
    """JAX's crafted timelines of tests/test_attrib.py."""
    overlap = _crafted([
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 100,
         "name": "jit(f)/sampler/model/dot"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 50, "dur": 100,
         "name": "jit(f)/sampler/model/dot2"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 200, "dur": 50, "name": "copy.1"},
    ])
    lanes = _fixture()
    lanes["traceEvents"].append({"ph": "M", "pid": 1, "tid": 7, "name": "thread_name",
                                 "args": {"name": "XLA Modules"}})
    lanes["traceEvents"].append({"ph": "X", "pid": 1, "tid": 7, "ts": 1000,
                                 "dur": 4000, "name": "jit(ddim_sample)"})
    stripped = _fixture()
    for ev in stripped["traceEvents"]:
        if ev.get("ph") == "X":
            ev.pop("args", None)
    return {"overlap": overlap, "lanes": lanes, "stripped": stripped}


def test_jax_fixture_attributes_as_jax_does():
    fx = _fixture()
    assert pa.attribute(fx) == ja.attribute(fx)
    assert pa.attribute(fx, scope_costs=ja.demo_scope_costs()) == ja.attribute(
        fx, scope_costs=ja.demo_scope_costs())
    for gap in (1.0, 5.0, ja.DEFAULT_GAP_US):  # the fusion gap gate
        assert pa.attribute(fx, gap_us=gap) == ja.attribute(fx, gap_us=gap)
    assert pa.attribute(fx, gap_us=1.0)["fusion_candidates"] == []


@pytest.mark.parametrize("case", ["overlap", "lanes", "stripped"])
def test_jax_crafted_cases_attribute_as_jax_does(case):
    trace = _xprof_cases()[case]
    got, want = pa.attribute(trace), ja.attribute(trace)
    assert got == want
    if case == "overlap":
        assert got["device_busy_s"] == pytest.approx(200e-6)
        assert got["coverage"] == pytest.approx(0.75)
    if case == "lanes":
        assert got["device_lanes"] == 1


def test_scope_chain_and_loading_equal_jax(tmp_path):
    for ev in _fixture()["traceEvents"]:
        assert pa.scope_chain(ev) == ja.scope_chain(ev)
    # JAX's profiler directory: plugins/profile/<run>/<host>.trace.json.gz
    run = tmp_path / "jax" / "plugins" / "profile" / "2026_02_02"
    run.mkdir(parents=True)
    with gzip.open(run / "h.trace.json.gz", "wt") as f:
        json.dump(_fixture(), f)
    assert pa.load_trace(str(tmp_path / "jax")) == ja.load_trace(str(tmp_path / "jax"))
    # the port's own writers' file name, which JAX's loader does not match
    (tmp_path / "port").mkdir()
    (tmp_path / "port" / "trace.json").write_text(json.dumps(pa.synthetic_demo_trace()))
    assert pa.load_trace(str(tmp_path / "port"))["traceEvents"] == \
        pa.synthetic_demo_trace()["traceEvents"]
    for bad in (tmp_path / "port" / "absent.json", tmp_path / "jax" / "plugins"):
        with pytest.raises(pa.AttribError):
            pa.load_trace(str(bad))


def test_ranked_scopes_equal_jax():
    fx = _fixture()
    assert pa.ranked_scopes(pa.attribute(fx)) == ja.ranked_scopes(ja.attribute(fx))


# ---------------------------------------------- attribution: Kineto input


def test_kineto_demo_matches_jax_demo():
    """The same timeline in Kineto's dialect: JAX's scopes (self, total,
    events), tree, window and fusion pairs; the memcpy on the second stream
    adds exactly its 100 µs to busy (it lies in an idle gap of the first),
    and is unattributed."""
    got, want = pa.demo_report(), ja.demo_report()
    for name, node in want["scopes"].items():
        assert {k: got["scopes"][name][k] for k in ("events", "self_s", "total_s")} == \
            {k: node[k] for k in ("events", "self_s", "total_s")}
    assert got["scopes"].keys() == want["scopes"].keys()
    assert got["tree"] == want["tree"]
    assert got["window_s"] == want["window_s"]
    copy_s = pa._DEMO_MEMCPY[1] * 1e-6
    assert got["device_busy_s"] == pytest.approx(want["device_busy_s"] + copy_s, abs=1e-12)
    assert got["idle_s"] == pytest.approx(want["idle_s"] - copy_s, abs=1e-12)
    attributed = want["coverage"] * want["device_busy_s"]
    assert got["coverage"] == pytest.approx(attributed / got["device_busy_s"], abs=1e-4)
    assert got["coverage"] >= pa.COVERAGE_FLOOR
    assert got["fusion_candidates"] == want["fusion_candidates"]
    assert got["device_lanes"] == 2  # the kernel stream and the copy stream
    # both roofline branches on the H100's ridge, the MFU from its bf16 peak
    flash, model = got["scopes"]["flash_attention/fwd"], got["scopes"]["sampler/model"]
    assert flash["roofline"] == "compute-bound" and model["roofline"] == "hbm-bound"
    assert model["mfu"] == pytest.approx(
        3.3e10 / (model["total_s"] * 989.4e12), abs=1e-4)
    assert got["peak_bf16_tflops"] == 989.4


HOST, GPU = 50, 0


def _meta():
    return [{"ph": "M", "name": "process_name", "pid": HOST, "args": {"name": "python3"}},
            {"ph": "M", "name": "process_name", "pid": GPU, "args": {"name": "python3"}},
            {"ph": "M", "name": "process_labels", "pid": GPU, "args": {"labels": "GPU 0"}}]


def _kernel(ts, dur, corr=None, stream=7, name="k", cat="kernel", ext=None):
    args = {"device": 0, "stream": stream}
    if corr is not None:
        args["correlation"] = corr
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU, "tid": stream,
            "ts": ts, "dur": dur, "args": args}


def _ann(name, ts, dur, tid=1, cat="user_annotation", ext=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": HOST, "tid": tid, "ts": ts,
          "dur": dur}
    if ext is not None:
        ev["args"] = {"External id": ext}
    return ev


def _launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": HOST, "tid": tid, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def test_kineto_streams_union_and_annotations_are_not_busy():
    trace = {"traceEvents": _meta() + [
        _kernel(1000, 100, stream=7), _kernel(1050, 100, stream=13, cat="gpu_memcpy"),
        _kernel(1300, 50, stream=7, cat="gpu_memset"),
        # a gpu_user_annotation spans the whole window on the stream: not work
        _kernel(1000, 350, stream=7, cat="gpu_user_annotation", name="sampler/model"),
    ]}
    rep = pa.attribute(trace)
    assert rep["device_lanes"] == 2
    assert rep["window_s"] == pytest.approx(350e-6)
    assert rep["device_busy_s"] == pytest.approx(200e-6)  # [1000, 1150] ∪ [1300, 1350]
    assert rep["idle_s"] == pytest.approx(150e-6)
    assert rep["busy_fraction"] == pytest.approx(200 / 350, abs=1e-4)
    assert rep["coverage"] == 0.0 and rep["scopes"] == {}


def test_kineto_launch_in_nested_annotations_on_a_second_thread():
    """Kernel 1 was launched on host thread 2 inside sampler/model ⊃
    flash_attention/fwd; thread 1's sampler/cached_step range covers the
    same time and must not join. Kernel 2 (launched by a driver call inside
    sampler/model only) shows the chain is read at its own launch; kernel 3
    joins through its ac2g flow; kernels 4 and 5 have no launch event
    anywhere and stay unattributed, kernel 4 though its External id names a
    host range (that id is the outermost recorded operator's, not a
    launch)."""
    events = _meta() + [
        _ann("sampler/cached_step", 0, 500, tid=1),
        _ann("sampler/model", 10, 200, tid=2),
        _ann("flash_attention/fwd", 20, 30, tid=2),
        _ann("ProfilerStep#1", 0, 500, tid=2),  # not a registered scope
        _launch(30, corr=1, tid=2),
        _launch(100, corr=2, tid=2, cat="cuda_driver", name="cuLaunchKernel"),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 3, "pid": HOST, "tid": 1,
         "ts": 60},
        _ann("mlp/pallas", 300, 20, tid=3, ext=77),
        _kernel(1000, 100, corr=1), _kernel(1100, 50, corr=2),
        _kernel(1200, 40, corr=3), _kernel(1300, 30, corr=4, ext=77),
        _kernel(1400, 20, corr=5, ext=99),
    ]
    rep = pa.attribute({"traceEvents": events})
    sc = rep["scopes"]
    assert sc["flash_attention/fwd"]["events"] == 1
    assert sc["flash_attention/fwd"]["self_s"] == pytest.approx(100e-6)
    assert sc["sampler/model"]["events"] == 1  # kernel 2's leaf
    assert sc["sampler/model"]["total_s"] == pytest.approx(150e-6)
    assert sc["sampler/cached_step"]["events"] == 1  # kernel 3, via its flow
    assert "mlp/pallas" not in sc
    assert rep["tree"] == {"sampler/model": ["flash_attention/fwd"]}
    assert rep["device_busy_s"] == pytest.approx(240e-6)
    assert rep["coverage"] == pytest.approx(190 / 240, abs=1e-4)  # not kernels 4, 5


def test_kineto_attribution_is_text_first_and_counts_metrics():
    """A device op whose own text names a scope keeps it (the xprof rule),
    and each attribution emits the catalog's attrib series."""
    trace = {"traceEvents": _meta() + [
        _ann("sampler/model", 0, 100), _launch(10, corr=1),
        _kernel(1000, 10, corr=1, name="void k<sampler/cached_step>")]}
    m = pa._mscope()
    before = m.value("attrib.traces")
    rep = pa.attribute(trace)
    assert list(rep["scopes"]) == ["sampler/cached_step"]
    assert m.value("attrib.traces") == before + 1
    assert m.raw("attrib.coverage_pct") == 100.0
    assert m.raw("attrib.device_busy_s") == pytest.approx(10e-6)


def test_int8_fraction_sets_a_scope_peak():
    trace = {"traceEvents": _meta() + [_ann("mlp/pallas", 0, 10), _launch(1, corr=1),
                                       _kernel(1000, 100, corr=1)]}
    costs = {"mlp/pallas": {"flops": 1e10, "bytes": 1e6, "int8_fraction": 1.0}}
    rep = pa.attribute(trace, device_kind=H100, scope_costs=costs)
    node = rep["scopes"]["mlp/pallas"]
    assert node["achieved_tflops"] == pytest.approx(100.0)
    assert node["mfu"] == pytest.approx(100.0 / 1978.9, abs=1e-4)


# ---------------------------------------------- a real CPU capture


@pytest.fixture(scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_cpu_capture_of_the_engine_counts_one_range_per_forward(tmp_path, one_thread):
    """Each config's drain, traced on the CPU: its sampler ranges equal its
    forwards (DDIM and inpaint at k=500 run 4, cold at 3 levels 3, few-step
    2; the delta-cached DDIM's 4 all under sampler/cached_step), and
    flash_attention/fwd one range per layer-forward (depth × forwards; the
    cached config's from its branch table). The scopes change no bits: a
    traced row equals the untraced one."""
    model = PortViT(**TINY, use_flash=True, device="cpu")
    C = serve.SamplerConfig
    mask = np.ones((16, 16), np.float32)
    mask[:, 8:] = 0.0
    known = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    cases = {
        "ddim": (C(k=500), dict(seed=1, n=2), 4, "sampler/model"),
        "inpaint": (C(task="inpaint", k=500), dict(seed=2, x_init=known, mask=mask), 4,
                    "sampler/model"),
        "cold": (C(sampler="cold", levels=3), dict(seed=3, n=2),
                 len(schedule.cold_time_sequence(3)), "sampler/model"),
        "fewstep": (C(steps=2), dict(seed=4, n=2), 2, "sampler/model"),
        "delta": (C(k=500, cache_interval=2), dict(seed=5, n=2), 4, "sampler/cached_step"),
    }
    eng = serve.Engine(model, buckets=(2,), device="cpu")
    serve.warmup(eng, [cfg for cfg, *_ in cases.values()])
    for label, (cfg, kw, forwards, scope) in cases.items():
        eng.submit(config=cfg, **kw)
        eng.run()
        ticket = eng.submit(config=cfg, **kw)
        with profiling.trace(str(tmp_path / label)):
            eng.run()
        untraced = eng.submit(config=cfg, **kw)
        eng.run()
        np.testing.assert_array_equal(ticket.result(), untraced.result())
        counts: dict = {}
        for ev in pa.load_trace(str(tmp_path / label))["traceEvents"]:
            if ev.get("cat") == "user_annotation":
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        sampler = {k: v for k, v in counts.items() if k.startswith("sampler/")}
        assert sampler == {scope: forwards}, label
        layer_forwards = model.depth * forwards
        if cfg.cache_interval > 1:  # the cached steps run the blocks of their branch
            spec = step_cache.cache_spec(model.depth, forwards, cfg.cache_interval,
                                         cfg.cache_mode)
            layer_forwards = sum(step_cache.blocks_run(spec, b) for b in spec.branches)
            assert layer_forwards < model.depth * forwards
        assert counts.get("flash_attention/fwd") == layer_forwards, label
    assert not torch.autograd._profiler_enabled()


# --------------------------------------------------- record and trend


def test_record_helpers_equal_jax(tmp_path):
    recs = [{"chip": "TPU v5 lite"}, {"chip": "cpu (fallback)"}, {"chip": H100},
            {"chip": ""}, {}, None, [1], {"chip": "CPU"}]
    for r in recs:
        assert prec.is_device_record(r) == jrec.is_tpu_record(r)
    for name in ("BENCH_r01.json", "BENCH_r05.json", "MULTICHIP_r02.json"):
        path = os.path.join(REPO, name)
        assert prec.last_json_record(path) == jrec.last_json_record(path)
    lines = tmp_path / "r.jsonl"
    lines.write_text('junk\n{"a": 1}\n[2]\n')
    assert prec.last_json_record(str(lines)) == jrec.last_json_record(str(lines))
    assert prec.last_json_record(str(tmp_path / "absent")) is None


def test_run_metadata_stamps_torch_not_jax(monkeypatch):
    monkeypatch.setenv("DDIM_COLD_RUN_TS", "1754400000")
    monkeypatch.setenv("DDIM_COLD_ROUND", "6")
    meta, want = prec.run_metadata(chip=H100), jrec.run_metadata(chip=H100)
    same = ("git_sha", "device_kind", "timestamp", "round")
    assert {k: meta[k] for k in same} == {k: want[k] for k in same}
    assert meta["torch"] == torch.__version__.split("+")[0] or \
        meta["torch"].startswith(torch.__version__.split("+")[0])
    assert meta["cuda"] == torch.version.cuda  # None on a CPU build
    assert "jax" not in meta and "jaxlib" not in meta
    monkeypatch.delenv("DDIM_COLD_RUN_TS")
    monkeypatch.delenv("SOURCE_DATE_EPOCH", raising=False)
    assert prec.run_metadata()["timestamp"] is None


def test_gate_equals_jax_on_the_committed_series():
    """JAX's checks over the repo's committed BENCH/MULTICHIP series: the
    port's gate returns JAX's report, and its own default checks are none."""
    want = jt.gate(REPO)
    assert pt.gate(REPO, bench_checks=jt.BENCH_CHECKS,
                   multichip_checks=jt.MULTICHIP_CHECKS) == want
    assert want["exit_code"] == 0 and want["checks"]
    own = pt.gate(REPO)
    assert own["checks"] == [] and own["exit_code"] == 0
    assert (own["bench_points"], own["multichip_points"]) == (
        want["bench_points"], want["multichip_points"])
    assert pt.main(["--root", REPO], bench_checks=jt.BENCH_CHECKS,
                   multichip_checks=jt.MULTICHIP_CHECKS) == 0


def _bench(tmp_path, rnd, value, ts=None, chip="TPU v5 lite", wrap=True):
    rec = {"value": value, "mfu": round(value / 80000, 4), "chip": chip}
    if ts is not None:
        rec["run_meta"] = {"timestamp": ts}
    obj = {"cmd": "bench", "rc": 0, "tail": json.dumps(rec) + "\n",
           "parsed": rec} if wrap else rec
    (tmp_path / f"BENCH_r{rnd:02d}.json").write_text(json.dumps(obj))


def _same_check(tmp_path, metric="value", direction="higher"):
    pattern = str(tmp_path / "BENCH_r*.json")
    got = pt.check(pt.load_series(pattern), metric, direction)
    want = jt.check(jt.load_series(pattern), metric, direction)
    assert got == want
    return got


def test_trend_synthetic_cases_equal_jax(tmp_path):
    # first run, then in band, missing metric, an injected regression
    _bench(tmp_path, 1, 4000)
    assert _same_check(tmp_path)["status"] == "first_run"
    _bench(tmp_path, 2, 3900)
    assert _same_check(tmp_path)["status"] == "ok"
    assert _same_check(tmp_path, "submetrics.absent.value")["status"] == "missing"
    _bench(tmp_path, 3, 2000)
    assert _same_check(tmp_path)["status"] == "regression"
    assert _same_check(tmp_path, "mfu", "lower")["status"] == "ok"
    checks = (("value", "higher"), ("mfu", "higher"))
    assert pt.gate(str(tmp_path), bench_checks=checks) == jt.gate(
        str(tmp_path), bench_checks=checks, multichip_checks=())
    # a truncated wrapper is a skipped point; a CPU fallback is not a point
    (tmp_path / "BENCH_r04.json").write_text(json.dumps(
        {"cmd": "bench", "rc": 124, "tail": '"value": 3980}'}))
    _bench(tmp_path, 5, 100, chip="cpu (fallback)")
    assert _same_check(tmp_path)["points"] == 3
    pts = pt.load_series(str(tmp_path / "BENCH_r*.json"))
    assert pts[3].record is None and "truncated" in pts[3].note
    # stamps order the series when every point has one
    for i in range(1, 6):
        (tmp_path / f"BENCH_r{i:02d}.json").unlink()
    _bench(tmp_path, 1, 4000, ts=200.0)
    _bench(tmp_path, 2, 3000, ts=100.0)
    assert [p.record["value"] for p in pt.load_series(str(tmp_path / "BENCH_r*.json"))] \
        == [3000, 4000]
    assert _same_check(tmp_path)["status"] == "ok"


def test_trend_helpers_equal_jax(tmp_path):
    for series in ([], [100.0], [100.0, 120.0, 100.0], [100.0, 101.0, 100.5],
                   [5.0, 0.0, 3.0, 4.0]):
        assert pt.noise_band(series) == jt.noise_band(series)
    for seq, n in ((list(range(25)), 10), (list(range(25)), 100), (list(range(25)), 1),
                   ([], 5), (list(range(7)), 0)):
        assert pt.thin(seq, n) == jt.thin(seq, n)
    rows = [{"fid": 400.0}, {"fid": 120.0}, {"fid": 118.0}, {"fid": 250.0}, {"x": 1}]
    for lower in (True, False):
        assert pt.annotate_deltas(rows, "fid", lower) == jt.annotate_deltas(rows, "fid", lower)
    wrappers = [{"cmd": "x", "rc": 0, "tail": "noise", "parsed": {"v": 1}},
                {"cmd": "x", "rc": 0, "tail": 'log\n{"v": 2}\n'},
                {"cmd": "x", "rc": 0, "tail": 'truncated..."mfu": 0.05}'}, {"v": 3}]
    for w in wrappers:
        assert pt.unwrap(copy.deepcopy(w)) == jt.unwrap(copy.deepcopy(w))
    for rec, dotted in (({"a": {"b": 2}}, "a.b"), ({"a": 1}, "a.b"), ({}, "x")):
        got, want = pt.metric_value(rec, dotted), jt.metric_value(rec, dotted)
        assert got == want or (got is pt._MISSING and want is jt._MISSING)
    garbage = tmp_path / "BENCH_r01.json"
    garbage.write_text("definitely { not json")
    with pytest.raises(pt.TrendError):
        pt.load_record(str(garbage))
    with pytest.raises(pt.TrendError):
        pt.load_record(str(tmp_path / "absent.json"))


def test_trend_gate_emits_its_metrics(tmp_path):
    _bench(tmp_path, 1, 4000)
    _bench(tmp_path, 2, 1000)
    m = pt._mscope()
    before = m.by_key("trend.checks").get("regression", 0)
    report = pt.gate(str(tmp_path), bench_checks=(("value", "higher"),))
    assert report["exit_code"] == 1
    assert m.raw("trend.points") == 2
    assert m.by_key("trend.checks")["regression"] == before + 1


# ---------------------------------------------------------- nan checks


def test_nan_checks_raise_like_jax_debug_nans():
    """A NaN in one Mlp weight: JAX's TINY forward raises FloatingPointError
    under jax_debug_nans, the port's under enable_nan_checks, naming the
    module it reached; neither check outlives its block."""
    from torch.nn.modules import module as nn_module

    jm = JaxViT(**TINY)
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3, 4], np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jnp.asarray(t))["params"])
    params = jax.tree_util.tree_map(np.array, params)
    block = next(k for k in params if k.startswith("blocks") or k.startswith("Block"))
    mlp = next(k for k in params[block] if "mlp" in k.lower())
    fc1 = next(k for k in params[block][mlp] if "fc1" in k.lower() or "0" in k)
    params[block][mlp][fc1]["kernel"][5, 3] = np.nan
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    assert not jax.config.jax_debug_nans

    pm = PortViT(**TINY, device="cpu")
    pm.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]), strict=True)
    assert torch.isnan(pm.blocks[0].mlp.fc1.weight).any()
    with torch.no_grad():
        assert torch.isnan(pm(torch.from_numpy(x), torch.from_numpy(t).long())).any()
        profiling.enable_nan_checks(True, pm)
        try:
            with pytest.raises(FloatingPointError, match=r"'blocks\.0\.mlp'"):
                pm(torch.from_numpy(x), torch.from_numpy(t).long())
        finally:
            profiling.enable_nan_checks(False)
    assert not nn_module._global_forward_hooks and not torch.is_anomaly_enabled()


def test_nan_checks_pass_a_finite_forward_and_catch_a_backward_nan():
    """No false positive, the same bits; anomaly mode raises at a backward
    function whose gradient is NaN (the flash autograd.Function's too)."""
    from ddim_cold_torch.ops import flash_attention as fa

    pm = PortViT(**TINY, use_flash=True, attn_drop_rate=0.0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32))
    t = torch.tensor([3, 4])
    with torch.no_grad():
        plain = pm(x, t)
    profiling.enable_nan_checks(True, pm)
    try:
        with torch.no_grad():
            assert torch.equal(pm(x, t), plain)
        qkv = torch.randn(1, 8, 3, 2, 32, requires_grad=True)
        out = fa.flash_attention_qkv(qkv, 0.1)
        with pytest.raises(RuntimeError, match="nan"):
            (out * float("nan")).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
