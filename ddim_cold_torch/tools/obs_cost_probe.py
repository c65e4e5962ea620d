"""What the observability layer costs the card's host.

At the north-star shapes (``oxford_flower_200_p4``, bf16, flash attention;
a served 8-row DDIM k=20 batch, and a B=16 training step), in turns
(A, B, B, A, repeated), one JSON line per case:

1. ``scope-gate`` — an unprofiled drain with the scopes as shipped (a
   ``record_function`` range only while a profiler collects, one check
   otherwise) against the same drain with ``profiling.scope`` replaced by a
   no-op: what the scopes cost the served path;
2. ``scope-profiled`` — a drain traced by ``profiling.trace`` with the
   scopes against one without them: what the ~700 ranges of a batch add to
   a profiled batch's wall and to the device's idle share (the union of its
   kernels, copies and sets over their window);
3. ``nan-checks`` — one training step plain, with the forward hook of
   ``profiling.enable_nan_checks`` alone, with autograd's anomaly mode
   alone, and with both;
4. ``range`` — host µs a call of a one-kernel op (``x.add_(1)``) alone,
   inside a ``record_function`` range and inside PyTorch's C++ range
   (``torch._C._profiler._RecordFunctionFast``, which Kineto records as a
   ``cpu_op``, not a ``user_annotation``), each with no profiler and under
   a CPU+CUDA profiler.

Walls are host clocks around work that ends in ``torch.cuda.synchronize()``;
each line gives the median and the min–max. Run on a CUDA machine from the
repository root::

    python3 -m ddim_cold_torch.tools.obs_cost_probe
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from ddim_cold_torch import serve
from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT
from ddim_cold_torch.obs import attrib
from ddim_cold_torch.ops import degrade
from ddim_cold_torch.train.step import create_train_state, make_train_step
from ddim_cold_torch.utils import profiling

MODEL = "oxford_flower_200_p4"
#: turns of each pair (A, B, B, A counts as two of each)
TURNS = 4


@contextlib.contextmanager
def _no_scopes():
    """``profiling.scope`` replaced by a no-op (every site looks it up on
    the module at call time)."""
    real = profiling.scope
    profiling.scope = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        profiling.scope = real


def _summary(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "n": len(xs)}


def _idle_share(prof) -> float:
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in attrib.REGISTERED_SCOPES)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return 1.0 - busy / (spans[-1][1] - spans[0][0])


def _turns(a, b) -> tuple:
    """Run ``a`` and ``b`` in turns A, B, B, A, … ; their results."""
    got_a, got_b = [], []
    for i in range(TURNS):
        first, second = (a, b) if i % 2 == 0 else (b, a)
        for fn in (first, second):
            (got_a if fn is a else got_b).append(fn())
    return got_a, got_b


def serve_costs(emit) -> None:
    model = DiffusionViT(**MODEL_CONFIGS[MODEL], dtype=torch.bfloat16, use_flash=True,
                         seed=0)
    eng = serve.Engine(model, buckets=(8,))
    config = serve.SamplerConfig(k=20)
    serve.warmup(eng, [config])
    seed = iter(range(1000, 2000))

    def drain() -> float:
        ticket = eng.submit(seed=next(seed), n=8, config=config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ticket.result(timeout=600)
        return wall

    def bare() -> float:
        with _no_scopes():
            return drain()

    drain()
    with_scopes, without = _turns(drain, bare)
    emit({"case": "scope-gate", "wall_s_scopes": _summary(with_scopes),
          "wall_s_no_scopes": _summary(without),
          "ratio_of_medians": statistics.median(with_scopes) / statistics.median(without)})

    def traced(scopes: bool):
        def run():
            with tempfile.TemporaryDirectory(dir="build") as d:
                ctx = contextlib.nullcontext() if scopes else _no_scopes()
                with ctx, profiling.trace(d) as prof:
                    wall = drain()
                return wall, _idle_share(prof)
        return run

    with_scopes, without = _turns(traced(True), traced(False))
    emit({"case": "scope-profiled",
          "wall_s_scopes": _summary([w for w, _ in with_scopes]),
          "wall_s_no_scopes": _summary([w for w, _ in without]),
          "idle_share_scopes": _summary([i for _, i in with_scopes]),
          "idle_share_no_scopes": _summary([i for _, i in without])})
    eng.drain(60)


def nan_check_costs(emit) -> None:
    model = DiffusionViT(**MODEL_CONFIGS[MODEL], dtype=torch.bfloat16, use_flash=True,
                         attn_drop_rate=0.0, seed=0)
    state = create_train_state(model, 0.005 * 16 / 512, 512)
    step = make_train_step(model, prepare=degrade.make_cold_prepare(200, max_step=7,
                                                                    chain=True))
    rs = np.random.default_rng(4)
    batch = (torch.from_numpy(rs.integers(0, 256, (16, 200, 200, 3), dtype=np.uint8)).cuda(),
             torch.from_numpy(rs.integers(1, 8, (16,), dtype=np.int32)).cuda())
    gen = torch.Generator(device="cuda").manual_seed(0)
    loss_rec = torch.tensor(5.0, device="cuda")

    @contextlib.contextmanager
    def mode(name):
        if name == "plain":
            yield
            return
        if name == "anomaly":
            with torch.autograd.detect_anomaly(check_nan=True):
                yield
            return
        profiling.enable_nan_checks(True, model)
        if name == "hook":
            torch.autograd.set_detect_anomaly(False)
        try:
            yield
        finally:
            profiling.enable_nan_checks(False)

    def timed(name):
        def run() -> float:
            nonlocal state, loss_rec
            with mode(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _, loss_rec = step(state, batch, gen, loss_rec)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3
        return run

    for name in ("plain", "hook", "anomaly", "both"):
        timed(name)()  # each mode's first step outside the timing
    for name in ("hook", "anomaly", "both"):
        plain, checked = _turns(timed("plain"), timed(name))
        emit({"case": "nan-checks", "mode": name, "ms_plain": _summary(plain),
              f"ms_{name}": _summary(checked),
              "ratio_of_medians": statistics.median(checked) / statistics.median(plain)})


def range_costs(emit) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1024, device="cuda")
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)

    def bare():
        x.add_(1)

    def ranged():
        with record_function("sampler/model"):
            x.add_(1)

    def fast_ranged():
        with fast("sampler/model"):
            x.add_(1)

    def us(fn, n: int = 3000) -> float:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    cases = {"op": bare, "op_in_record_function": ranged}
    if fast is not None:
        cases["op_in_fast_range"] = fast_ranged
    got = {f"{name}_us": us(fn) for name, fn in cases.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got.update({f"{name}_profiled_us": us(fn) for name, fn in cases.items()})
    emit({"case": "range", **got})


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()

    def emit(rec) -> None:
        print(json.dumps({"probe": "obs_cost", "device": smi, **rec}), flush=True)

    range_costs(emit)
    serve_costs(emit)
    nan_check_costs(emit)


if __name__ == "__main__":
    main()
