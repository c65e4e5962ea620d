#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check every kernel.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. device  — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for the float32 comparisons;
2. build   — compile ``ddim_cold_torch/csrc/flash_fwd.cu`` with ``nvcc`` and
   load it;
3. kernel  — each kernel against its plain PyTorch version at the main
   path's shapes (and the 200px/p8 head dim), in bfloat16 and float32, with
   CUDA-event median times of the kernel, the plain version and the one
   PyTorch call that computes the same function (timed only, never used by
   the port), beside the card's least possible time for the same work;
4. forward — the full-width, full-depth ``oxford_flower_200_p4`` model (random
   weights from a fixed seed), flash kernel against the dense path;
5. serve   — the main path: a bucketed ``Engine`` over the bf16 flash model,
   warmed, answering three requests with DDIM k=20 (100 forwards each); the
   kernel launch counters are zeroed just before and read just after;
6. profile — one more drain (a single 8-row batch) under ``torch.profiler``:
   device time by kernel kind and the device's idle share;
7. the ``kernels`` summary line, then the card's ``nvidia-smi`` line, then
   ``{"ok": true, "device": ...}`` as the last line.

Any failed check raises and the script exits non-zero. It exits non-zero
without printing a result when the port's package is not beside it (the
import fails) and when CUDA is unavailable.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
MODEL = "oxford_flower_200_p4"
BUCKETS = (4, 8)
K = 20                      # DDIM stride: np.arange(1999, 0, -20) = 100 forwards
REQUESTS = ((0, 1), (1, 3), (2, 5))   # (seed, n)
#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s and
#: FLOP/s per operand type of the kernel's work
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: kernel vs plain: O element-wise within ``flash_attention.o_error_limit``
#: (float32 1e-5; bfloat16 one bf16 ulp of each element plus 2^-5·mean|O|);
#: lse is f32 arithmetic on either input type, so 1e-5 for both
LSE_TOL = 1e-5
#: a kernel whose bfloat16 O were this much too large must fail the limit
SCALE_FAULT = 0.02
#: flash vs dense forward of the whole model: float32 carries the kernel's
#: ~1e-6 differences through 6 blocks; bfloat16 rounds at different points
FWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound(B, N, H, D, dtype_name):
    """Least time for one flash forward: 4·B·H·N²·D FLOP over the type's
    peak vs q, k, v read once plus O and lse written once over HBM."""
    elem = 4 if dtype_name == "float32" else 2
    ops = 4.0 * B * H * N * N * D
    nbytes = 4.0 * B * N * H * D * elem + 4.0 * B * H * N
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch, fa):
    """Flash kernel vs plain, per geometry and dtype; returns the per-case
    records keyed (geometry, dtype)."""
    import torch.nn.functional as F

    records = {}
    # the main path dispatches batches of 8 and 4 (bf16); the 200px/p8
    # geometry holds the D=32 instantiation; f32 holds the exact arithmetic
    for geom, (B, N, H, D), dtypes in (
            ("200_p4", (8, 2501, 4, 64), (torch.float32, torch.bfloat16)),
            ("200_p4_b4", (4, 2501, 4, 64), (torch.bfloat16,)),
            ("200_p8", (8, 626, 12, 32), (torch.float32, torch.bfloat16))):
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)  # strided views, as the model passes them
            scale = D**-0.5
            o, lse = fa.flash_forward(q, k, v, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_forward_reference(q, k, v, scale)
            diff = (o.float() - o_ref.float()).abs()
            limit = fa.o_error_limit(o_ref)
            err_o, err_lse = diff.max().item(), (lse - lse_ref).abs().max().item()
            # the limit is tight enough to catch O scaled 2% wrong
            scaled = (o.float() * (1 + SCALE_FAULT) - o_ref.float()).abs()
            catches_scale = bool((scaled > limit).any())
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec = {
                "phase": "kernel", "kernel": "flash_fwd", "geometry": geom,
                "B": B, "N": N, "H": H, "D": D, "dtype": name,
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "mean_abs_o": o_ref.float().abs().mean().item(),
                # what the limit's 2^-5·mean|O| term must cover
                "max_excess_over_ulp_o": (diff - 2.0**-7 * o_ref.float().abs()).max().item(),
                "max_err_over_limit_o": (diff / limit).max().item(),
                "max_limit_o": limit.max().item(), "tol_lse": LSE_TOL,
                "catches_2pct_scale": catches_scale,
                "ms": time_ms(torch, lambda: fa.flash_forward(q, k, v, scale)),
                "plain_ms": time_ms(torch, lambda: fa.flash_forward_reference(
                    q, k, v, scale), reps=20),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale)),
            }
            rec["bound_ms"], rec["bound_by"] = flash_bound(B, N, H, D, name)
            emit(rec)
            check(o.shape == (B, N, H, D) and o.dtype == dtype and o.is_contiguous(),
                  f"flash_fwd output layout {geom} {name}")
            check(bool(torch.isfinite(o.float()).all()), f"flash_fwd finite {geom} {name}")
            check(bool((diff <= limit).all()),
                  f"flash_fwd O error {err_o} over its limit {geom} {name}")
            check(err_lse <= LSE_TOL, f"flash_fwd lse error {err_lse} {geom} {name}")
            check(catches_scale, f"O limit misses a {SCALE_FAULT:.0%} scale fault "
                  f"{geom} {name}")
            records[(geom, name)] = rec
            del qkv, q, k, v, o, lse, o_ref, lse_ref, diff, limit, scaled
            torch.cuda.empty_cache()
    return records


def phase_forward(torch, DiffusionViT, MODEL_CONFIGS):
    """Full-width, full-depth model: flash vs dense on the same weights."""
    cfg = MODEL_CONFIGS[MODEL]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, W = cfg["img_size"]
    x = torch.randn((2, H, W, 3), generator=gen, device="cuda")
    t = torch.randint(0, 2000, (2,), generator=gen, device="cuda")
    models = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        flash = DiffusionViT(**cfg, dtype=dtype, use_flash=True, seed=SEED)
        dense = DiffusionViT(**cfg, dtype=dtype, use_flash=False, seed=SEED)
        a, b = flash(x, t), dense(x, t)
        err = (a - b).abs().max().item()
        emit({"phase": "forward", "model": MODEL, "dtype": name, "batch": 2,
              "max_abs_err_flash_vs_dense": err, "tol": FWD_TOL[name],
              "out_abs_max": b.abs().max().item()})
        check(a.shape == (2, H, W, 3) and bool(torch.isfinite(a).all()),
              f"forward output {name}")
        check(err <= FWD_TOL[name], f"flash vs dense forward {name}: {err}")
        models[name] = flash
    return models["bfloat16"]


def phase_serve(torch, model, fa, serve):
    eng = serve.Engine(model, buckets=BUCKETS)
    config = serve.SamplerConfig(k=K)
    t0 = time.perf_counter()
    warm = serve.warmup(eng, [config])
    warm_s = time.perf_counter() - t0
    programs = eng.stats["programs"]

    fa.LAUNCHES["flash_fwd"] = 0          # main path starts here
    tickets = [(n, eng.submit(seed=s, n=n, config=config)) for s, n in REQUESTS]
    report = eng.run()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_fwd"]   # ... and ends here

    steps = len(range(model.total_steps - 1, 0, -K))
    expected = model.depth * steps * report["batches"]
    emit({"phase": "serve", "model": MODEL, "dtype": "bfloat16",
          "buckets": list(BUCKETS), "k": K, "requests": [n for _, n in REQUESTS],
          "warmup_s": warm_s, "warmed_programs": warm["programs"],
          "batches": report["batches"], "rows": report["rows"],
          "padded_rows": report["padded_rows"], "wall_s": report["wall_s"],
          "img_per_sec": report["img_per_sec"],
          "p50_latency_s": report["latency"]["p50_s"],
          "programs_after_warmup": report["programs"],
          "flash_fwd_launches": launches, "expected_launches": expected})
    for n, ticket in tickets:
        img = ticket.result(timeout=600)
        check(img.shape == (n, 200, 200, 3), f"served shape {img.shape}")
        check(bool(((img >= 0.0) & (img <= 1.0)).all()), "served values in [0, 1]")
    check(report["failed_tickets"] == 0, "no failed tickets")
    check(report["programs"] == 0 and eng.stats["programs"] == programs,
          "no program added after warmup")
    check(launches == expected,
          f"flash_fwd launched {launches} times, expected {expected}")
    return eng, config, launches


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def phase_profile(torch, eng, config):
    """Where a served batch's time goes: one more drain of a single 8-row
    batch under torch.profiler; device kernel time by kind and the device's
    idle share over the drain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ticket = eng.submit(seed=3, n=8, config=config)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticket.result(timeout=600)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kinds = {"flash_fwd": [], "gemm": [], "other": []}
    by_name: dict = {}
    for e in kernels:
        name = e.name.lower()
        kind = ("flash_fwd" if "flash_fwd" in name else
                "gemm" if any(s in name for s in ("gemm", "xmma", "cutlass",
                                                  "nvjet")) else
                "other")
        kinds[kind].append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name[:80], [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    spans = [iv for ivs in kinds.values() for iv in ivs]
    window_us = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)) if spans else 0.0
    busy_us = _union_us(spans)
    steps = len(range(eng.model.total_steps - 1, 0, -K))
    rec = {"phase": "profile", "batches": report["batches"], "rows": report["rows"],
           "wall_s": wall, "device_kernels": len(kernels),
           "device_window_s": window_us / 1e6, "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / window_us if window_us else None}
    for kind, ivs in kinds.items():
        rec[f"{kind}_s"] = sum(hi - lo for lo, hi in ivs) / 1e6
        rec[f"{kind}_launches"] = len(ivs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    rec["top_kernels"] = [{"name": n, "s": us / 1e6, "launches": c}
                          for n, (us, c) in top]
    emit(rec)
    check(rec["flash_fwd_launches"] == eng.model.depth * steps * report["batches"],
          f"profiled flash_fwd launches {rec['flash_fwd_launches']}")


def main() -> int:
    import torch

    from ddim_cold_torch import serve
    from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT
    from ddim_cold_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = fa.load_kernel()
    emit({"phase": "build", "library": lib._name,
          "seconds": time.perf_counter() - t0})

    records = phase_kernels(torch, fa)
    model = phase_forward(torch, DiffusionViT, MODEL_CONFIGS)
    eng, config, launches = phase_serve(torch, model, fa, serve)
    phase_profile(torch, eng, config)

    main_case = records[("200_p4", "bfloat16")]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ddim_cold_torch/csrc/flash_fwd.cu",
        "replaces": "ddim_cold_tpu/ops/flash_attention.py:79",
        "launches": launches, "max_abs_err": main_case["max_abs_err_o"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
