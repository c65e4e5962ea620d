#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check every kernel.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. device  — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for the float32 comparisons;
2. build   — compile every ``ddim_cold_torch/csrc/*.cu`` with ``nvcc`` (one
   ``nvcc`` per source, all started together; each includes its
   ``csrc/*.cuh`` headers) and load them;
2b. sass   — ``cuobjdump -sass`` of all five libraries: every bfloat16
   kernel function runs its products on the tensor cores (HGMMA; the w8a8
   ones also the int8 IGMMA) and spills nothing, no float32 one does;
   registers, stack and spills from ``cuobjdump -res-usage``;
3. kernel  — the flash forward kernel against its plain PyTorch version at
   the main paths' shapes (the token cache's 626 tokens and the 200px/p8
   head dim too), in bfloat16 and
   float32, with CUDA-event median times of the kernel, the plain version
   and the one PyTorch call that computes the same function (timed only,
   never used by the port; every timed call queued behind a device spin, so
   the times are the device's), beside the card's least possible time for
   the same work;
4. kernel  — the two flash backward kernels (``flash_bwd_dq``,
   ``flash_bwd_dkv``) likewise, dq/dk/dv held element-wise to
   ``flash_attention.grad_error_limit``; the library time is one
   ``autograd.grad`` through ``F.scaled_dot_product_attention``; then the
   bfloat16 pair at large logits (inputs ×8): finite, dv within the limit,
   dq and dk within it plus ``flash_attention.ds_flip_bound`` (what flipped
   bf16 roundings of dS can move them), a 2% fault in either caught, and
   the smallest uniform scale fault of 0.1%–2% that the gate catches;
   then the same pair against the JAX package's own backward at the
   fault's case, (2, 129, 2, 32) seed 6 ×8 (``tools/data/bwd_large_logits.npz``:
   the inputs, which must be what the CUDA generator draws, and JAX's O,
   lse, dq, dk, dv): kernel and plain version over the limit of JAX's
   result, the kernel within the same gate;
5. forward — the full-width, full-depth ``oxford_flower_200_p4`` model (random
   weights from a fixed seed), flash kernel against the dense path;
6. serve   — the serving path: a bucketed ``Engine`` over the bf16 flash
   model, warmed, answering three requests with DDIM k=20 (100 forwards
   each); the kernel launch counters are zeroed just before and read just
   after;
7. profile — one more drain (a single 8-row batch) under ``torch.profiler``:
   device time by kernel kind and the device's idle share;
8. train-check — one optimizer step of the full-width model with every drop
   rate 0, the flash path (the kernels) against the dense path on the same
   weights and batch, float32 and bfloat16: loss, gradient norm and the
   parameter update within the stated tolerances;
9. train   — the training path: the bf16 flash model at the 200px YAML's
   hyper-parameters (drop 0.1, drop path 0.1, attention dropout 0), cold
   batches of 16 corrupted on the card by ``make_cold_prepare``, 3 warm-up
   and 20 timed steps; the launch counters are zeroed just before the timed
   steps and must read depth × steps for each of the three kernels. Then 2
   steps with attention dropout 0.1 (the JAX default, the YAML path): the
   dense rule holds and no flash kernel launches;
10. train-profile — three more training steps under ``torch.profiler``:
   device time of the three kernels and of the rest, and the idle share;
11. kernel — the quantized trunk's kernels (``dequant_mm``, ``mlp_fused``,
   ``fused_trunk``) against their plain versions at the 200px/p4 serve
   shape (B=8) and at 200px/p8, in float32 and bfloat16, w8a16 and w8a8
   (and the float Mlp; dequant_mm at the qkv shape N = 3C and at N = C,
   the shape of proj, fc1 and fc2): element-wise within
   ``quant.mm_error_limit`` /
   ``quant.trunk_error_limit``, a 2% fault caught, CUDA-event medians of
   kernel, plain version and library yardstick, and the bound;
12. quant-forward — the full-width model in float32 and bfloat16: each
   quantized or fused forward against the float one, and fused against
   unfused w8a16, within the stated tolerances;
13. serve-quant — one warmed engine over the bf16 model serves one 8-row
   request under each of ``quant="pallas"``, ``quant="pallas", fused=True``,
   ``quant="w8a8", fused=True`` and ``fused=True``; the launch counters are
   zeroed just before each drain and must read exactly depth × steps per
   kernel of the config (dequant_mm 4× that); then one more
   ``quant="pallas"`` batch and one more fused w8a16 batch under
   ``torch.profiler``, each with its launch counts checked;
14. serve-edit — one engine (buckets 4, 8) over the bf16 model and a
   seed-1 student weight set, warmed with eight configs: cold (7 levels),
   superres (cold, 3 levels, ``quant="pallas"``, a 25×25 input), inpaint
   (k=20, the left half known) float and ``quant="pallas", fused=True``,
   draft (t_start 1800, k=20, previews every 10 steps), interp (t_start
   1800, k=20), few-step (4 steps) and its student. One 8-row request each,
   with the launch counters zeroed just before each drain: depth × forwards
   per kernel, exactly (the forwards computed from the schedules: 7, 3,
   100, 100, 90, 90, 4, 4); wall and img/s per config; then every result
   bit for bit equal to the direct ``workloads.*`` / ``sampling.*`` call at
   the same 8-row shape (the draft's previews to its trajectory), known
   inpaint pixels exact, the superres result consistent with its input
   after ``superres_project``;
15. serve-cache — the step cache, served: one engine (buckets 4, 8) over
   the bf16 model, warmed with the uncached DDIM config and nine cached
   ones (k=20 unless said): delta, full, adaptive (interval 4, τ 0.05,
   telemetry), token (⌈(N+1)/4⌉ = 626 live tokens) at interval 2; delta
   on ``quant="pallas", fused=True`` and on ``quant="pallas"``; inpaint,
   cold (7 levels) and few-step (4 steps) at interval 2. One 8-row
   request each, three times: exact launches per kernel (and the adaptive
   gate's host reads) from the branch table, or from the telemetry's
   branches for adaptive, ``memory_allocated`` flat over the second
   batch, the third profiled (device kernels, busy time, idle share);
   each config and its uncached twin drained in turns for the speed-up;
   then every row
   bit for bit its direct call, a 3-row adaptive request in bucket 4
   (row-0 replica padding) its direct call on the padded batch with the
   unpadded call's gate, and the collapses τ = 0, ``cache_tokens`` = N+1
   and ``cache_interval=1`` (the uncached batch), τ = ∞ (the delta batch),
   telemetry off (telemetry on); the speed-up over the uncached batch
   beside ``flops_saved_fraction`` and |cached − uncached|;
16. fid — FID and the four quality guards on the card: the seeded proxy
   extractor at 200 px against its CPU float32 output on 2 images (rtol
   2e-3, atol 2e-4) with its device time for 32 images and its peak
   memory; then at k=20 over 32 samples in 8-row batches
   ``cached_sampler_guard`` at ``cache_interval=1`` (exactly 0), full i2
   and inpaint delta i2, ``quantized_sampler_guard`` with
   ``quant="pallas"`` and with ``quant="w8a8"`` on the float fused model,
   and ``superres_consistency_guard`` on a served superres batch after
   ``superres_project`` (bit-exact); exact launches per guard, distances
   recorded with no limit;
17. distill — progressive distillation of the same model, 4 → 2 → 1,
   ``ddim`` and ``cold``, at batch 16: exact launches over the run and
   over 10 timed updates (depth × 3 flash_fwd and depth × each backward
   kernel an update), ms/step, peak memory, every loss finite; a restart
   resuming ``live/`` at its iteration; ``distilled_sampler_guard`` of the
   k=1 student; the k=1 student served, bit for bit its direct call;
18. the ``kernels`` summary line (all six kernels, each with its design:
   "wgmma", the bfloat16 route on the tensor cores), then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": ...}`` as the last
   line.

A failed check is reported on stderr when it happens; the run goes on, so
that one call reports every failure, and exits non-zero at the end without
the "ok" line. An exception stops it at once. It exits non-zero without
printing a result when the port's package is not beside it (the import
fails) and when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
MODEL = "oxford_flower_200_p4"
SOURCES = ("flash_fwd", "flash_bwd", "dequant_mm", "mlp_fused", "fused_trunk")
BUCKETS = (4, 8)
K = 20                      # DDIM stride: np.arange(1999, 0, -20) = 100 forwards
REQUESTS = ((0, 1), (1, 3), (2, 5))   # (seed, n)
#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s and
#: FLOP/s per operand type of the kernel's work
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
#: kernel vs plain: O element-wise within ``flash_attention.o_error_limit``
#: (float32 1e-5; bfloat16 one bf16 ulp of each element plus 2^-5·mean|O|);
#: lse is f32 arithmetic on either input type, so 1e-5 for both
LSE_TOL = 1e-5
#: a kernel whose bfloat16 O were this much too large must fail the limit
SCALE_FAULT = 0.02
#: flash vs dense forward of the whole model: float32 carries the kernel's
#: ~1e-6 differences through 6 blocks; bfloat16 rounds at different points
FWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the training phases: the 20220822_200px.yaml hyper-parameters (AMP, batch
#: 8 → 16, base_lr 0.005, 8 epochs, cold chain targets over 7 levels)
TRAIN_WARM, TRAIN_STEPS, DENSE_STEPS, PROFILE_STEPS = 3, 20, 2, 3
#: cosine length: the YAML's 8 epochs at 64 batches an epoch (a 1,024-image
#: train folder at batch 16; the schedule only sets the lr of these steps)
TRAIN_TOTAL_STEPS = 8 * 64
CHECK_BATCH = 4
#: flash vs dense, one step at every drop rate 0 (train-check). loss and
#: ‖g‖: relative; float32 carries the kernels' ~1e-6 differences, bfloat16
#: rounds at different points in the two attention paths. The update: the
#: first Adam step moves each parameter by lr·g/(|g|+ε) + lr·wd·p, so two
#: runs can differ by at most 2·lr (a sign flip) at any element; "upd_rel"
#: bounds the relative L2 distance of the two updates, which only elements
#: whose gradient is within the two paths' difference of zero can move
TRAIN_CHECK_TOL = {
    "float32": {"loss": 1e-5, "grad_norm": 1e-4, "upd_rel": 1e-2},
    "bfloat16": {"loss": 1e-2, "grad_norm": 5e-2, "upd_rel": 0.5},
}
MAX_UPDATE_GAP_LR = 2.1  # max |Δp| between the paths, in units of lr
#: the libraries whose bfloat16 kernels run on the tensor cores, and how
#: many bfloat16 and float32 kernel functions each holds (D = 32 and 64;
#: flash_bwd: dq and dk/dv of each; fused_trunk: w8a16 and w8a8 of each;
#: dequant_mm: bfloat16 with an f32 or a bf16 out, and the f32 one;
#: mlp_fused: float, w8a16 and w8a8 weights in each dtype)
WGMMA_LIBS = {"flash_fwd": (2, 2), "flash_bwd": (4, 4), "fused_trunk": (4, 4),
              "dequant_mm": (2, 1), "mlp_fused": (3, 3)}
#: device spin ahead of each timed call, in clock cycles (about 1 ms)
SPIN_CYCLES = 2_000_000
#: bfloat16 kernel functions whose products are all int8 x int8 (IGMMA and
#: no HGMMA): the w8a8 Mlp multiplies int8 x codes and int8 hidden codes
INT8_ONLY = ("mlp_fused_w8a8_bf16",)
#: the uniform scale faults the large-logit gate is probed with: 0.1% to 2%
GATE_FAULTS = tuple(round(0.001 * i, 4) for i in range(1, 21))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: every failed check; the run goes on so that one call reports them all,
#: and exits non-zero, without the "ok" line, at the end
FAILURES: list = []


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(what)
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after ``warm`` calls.

    Each timed call is queued behind about a millisecond of device spin
    (``torch.cuda._sleep``), so the host has enqueued the call's launches
    before the device reaches the start event: the events time the device's
    work, not the Python wrapper's launch overhead, which for a kernel of
    tens of microseconds is as long as the kernel (the serve phases measure
    the host's share end to end)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sass_functions(text: str) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing: how many bf16
    (HGMMA) and int8 (IGMMA ... S8) warpgroup matrix multiplies it holds."""
    funcs = {}
    for block in re.split(r"^\s*Function : ", text, flags=re.M)[1:]:
        name, _, body = block.partition("\n")
        funcs[name.strip()] = {"hgmma": len(re.findall(r"\bHGMMA\.", body)),
                               "igmma_s8": len(re.findall(r"\bIGMMA\.\S*S8", body))}
    return funcs


def _res_usage(text: str) -> dict:
    """Per kernel function of ``cuobjdump -res-usage``: registers, stack,
    static shared and local (spill) bytes."""
    return {m[0]: {"reg": int(m[1]), "stack": int(m[2]), "shared": int(m[3]),
                   "local": int(m[4])}
            for m in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) "
                                r"SHARED:(\d+) LOCAL:(\d+)", text)}


def phase_sass(libs: dict, nvcc: str) -> None:
    """The bfloat16 kernels of every library run their products through
    wgmma (HGMMA in the SASS, and the int8 IGMMA in w8a8) and spill no
    register to local memory; the float32 ones, the exact oracle route,
    hold no wgmma. Kernel functions are told apart by name: the bfloat16
    ones carry ``_bf16``, the w8a8 ones ``_w8a8_``; the w8a8 Mlp
    (``INT8_ONLY``) has no bf16 product, so it holds IGMMA and no HGMMA."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    rec = {"phase": "sass", "tool": tool, "libraries": {}}
    for name, (n_bf16, n_f32) in WGMMA_LIBS.items():
        path = libs[name]._name
        run = lambda flag: subprocess.run([tool, flag, path], capture_output=True,
                                          text=True, check=True, timeout=300).stdout
        funcs, usage = _sass_functions(run("-sass")), _res_usage(run("-res-usage"))
        rec["libraries"][name] = {fn: {**counts, **usage.get(fn, {})}
                                  for fn, counts in funcs.items()}
        bf16 = [fn for fn in funcs if "_bf16" in fn]
        check(len(bf16) == n_bf16 and len(funcs) - len(bf16) == n_f32,
              f"sass {name}: {len(bf16)} bf16 and {len(funcs) - len(bf16)} other "
              f"kernel functions, expected {n_bf16} and {n_f32}")
        for fn, c in funcs.items():
            if fn in bf16:
                int8_only = any(k in fn for k in INT8_ONLY)
                check((c["hgmma"] > 0) != int8_only,
                      f"sass {name}: HGMMA count {c['hgmma']} in {fn}")
                check(("_w8a8_" in fn) == (c["igmma_s8"] > 0),
                      f"sass {name}: int8 IGMMA count {c['igmma_s8']} in {fn}")
                check(fn in usage, f"sass {name}: no -res-usage entry for {fn}")
                check(usage.get(fn, {}).get("local") == 0,
                      f"sass {name}: {fn} spills to local memory")
            else:
                check(c["hgmma"] == 0 and c["igmma_s8"] == 0,
                      f"sass {name}: the float32 {fn} runs on the tensor cores")
    emit(rec)


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
    # the serving path dispatches batches of 8 and 4 (bf16), training
    # batches of 16; the 200px/p8 geometry holds the D=32 instantiation; f32
    # holds the exact arithmetic
    for geom, (B, N, H, D), dtypes in (
            ("200_p4_b16", (16, 2501, 4, 64), (torch.bfloat16,)),
            ("200_p4", (8, 2501, 4, 64), (torch.float32, torch.bfloat16)),
            ("200_p4_b4", (4, 2501, 4, 64), (torch.bfloat16,)),
            # the token cache's reuse steps: a quarter of 200_p4's tokens
            ("200_p4_tok", (8, 626, 4, 64), (torch.bfloat16,)),
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


def bwd_bound(name, B, N, H, D, dtype_name):
    """Least time for one backward kernel: dq does 6·B·H·N²·D FLOP (Q·Kᵀ,
    dO·Vᵀ, dS·K), dk/dv 8·B·H·N²·D (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q), at the type's
    peak, vs q, k, v, dO, lse and δ read once and dq (or dk and dv) written
    once over HBM."""
    elem = 4 if dtype_name == "float32" else 2
    gemms, outs = (3, 1) if name == "flash_bwd_dq" else (4, 2)
    ops = 2.0 * gemms * B * H * N * N * D
    nbytes = (4 + outs) * B * N * H * D * elem + 2 * 4.0 * B * H * N
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels_bwd(torch, fa):
    """The two backward kernels vs their plain versions on the same inputs
    and the same lse (the forward kernel's), per geometry and dtype."""
    import torch.nn.functional as F

    records = {}
    # training dispatches batches of 16 (8 per grad-accum slice or the
    # 64px-style half batch); the 200px/p8 geometry holds D=32
    for geom, (B, N, H, D), dtypes in (
            ("200_p4", (16, 2501, 4, 64), (torch.float32, torch.bfloat16)),
            ("200_p4_b8", (8, 2501, 4, 64), (torch.bfloat16,)),
            ("200_p8", (16, 626, 12, 32), (torch.float32, torch.bfloat16))):
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            scale = D**-0.5
            o, lse = fa.flash_forward(q, k, v, scale)
            do = torch.randn((B, N, H, D), generator=gen, device="cuda").to(dtype)
            delta = fa.backward_delta(o, do)
            grad = torch.empty((B, N, 3, H, D), dtype=dtype, device="cuda")
            dq, dk, dv = grad.unbind(2)
            run_dq = lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, dq, scale)
            run_dkv = lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale)
            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
            ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
            errs = {}
            for g_name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                     ("dv", dv, ref_dv)):
                diff = (got.float() - ref.float()).abs()
                limit = fa.grad_error_limit(ref)
                scaled = (got.float() * (1 + SCALE_FAULT) - ref.float()).abs()
                errs[g_name] = {
                    "max_abs_err": diff.max().item(),
                    "mean_abs": ref.float().abs().mean().item(),
                    "max_err_over_limit": (diff / limit).max().item(),
                    "within_limit": bool((diff <= limit).all()),
                    "catches_2pct_scale": bool((scaled > limit).any()),
                    "finite": bool(torch.isfinite(got.float()).all())}
            # library: one autograd.grad through SDPA (dq, dk, dv together)
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
            go = do.transpose(1, 2)
            library_ms = time_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), go, retain_graph=True))
            for kname, run, plain, parts in (
                    ("flash_bwd_dq", run_dq,
                     lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                     ("dq",)),
                    ("flash_bwd_dkv", run_dkv,
                     lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                     ("dk", "dv"))):
                rec = {"phase": "kernel", "kernel": kname, "geometry": geom,
                       "B": B, "N": N, "H": H, "D": D, "dtype": name,
                       "errors": {g: errs[g] for g in parts},
                       "max_abs_err": max(errs[g]["max_abs_err"] for g in parts),
                       "ms": time_ms(torch, run),
                       "plain_ms": time_ms(torch, plain, reps=5, warm=1),
                       "library_ms": library_ms}
                rec["bound_ms"], rec["bound_by"] = bwd_bound(kname, B, N, H, D, name)
                emit(rec)
                for g in parts:
                    e = errs[g]
                    check(e["finite"], f"{kname} {g} finite {geom} {name}")
                    check(e["within_limit"], f"{kname} {g} error {e['max_abs_err']} "
                          f"over its limit {geom} {name}")
                    check(e["catches_2pct_scale"], f"{g} limit misses a "
                          f"{SCALE_FAULT:.0%} scale fault {geom} {name}")
                records[(geom, name, kname)] = rec
            del qkv, q, k, v, o, lse, do, delta, grad, dq, dk, dv, ref_dq, ref_dk
            del ref_dv, qt, kt, vt, out, go
            torch.cuda.empty_cache()
    return records


def phase_bwd_large_logits(torch, fa):
    """The bf16 backward kernels at large logits: q, k, v ×8 at 200_p4, B=2
    (|lse| in the hundreds; the inputs of the card test
    ``test_flash_backward_large_logits``). Softmax rows are nearly one-hot,
    so each element of dq and dk is a difference of dS terms far larger
    than itself, and a dS rounding that flips on an f32-level difference
    moves it past ``grad_error_limit``: dq and dk are held to the limit plus
    ``ds_flip_bound``, dv (P alone) to the limit. Recorded per gradient:
    |Δ| over the bare limit and over the gate, the elements past the bare
    limit, whether a 2% fault fails the gate (checked), and the smallest of
    the uniform scale faults 0.1%, 0.2%, ..., 2% of the kernel's output
    that the gate catches (how much slack it leaves)."""
    from ddim_cold_torch.tools import bwd_fixture

    B, N, H, D = 2, 2501, 4, 64
    q, k, v, do = bwd_fixture.large_logit_inputs("cuda", B, N, H, D, seed=6, gain=8.0)
    scale = D**-0.5
    o, lse = fa.flash_forward_reference(q, k, v, scale)
    grad = fa.flash_backward(q, k, v, o, lse, do, scale)
    ref = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
    flips = fa.ds_flip_bound(q, k, v, do, lse, fa.backward_delta(o, do), scale)
    rec = {"phase": "bwd-large-logits", "B": B, "N": N, "H": H, "D": D,
           "dtype": "bfloat16", "gain": 8.0, "max_abs_lse": lse.abs().max().item()}
    for i, g in enumerate(("dq", "dk", "dv")):
        r = ref[:, :, i].float()
        limit = fa.grad_error_limit(ref[:, :, i])
        gate = limit + flips[i] if i < 2 else limit
        err = (grad[:, :, i].float() - r).abs()
        fault = (grad[:, :, i].float() * (1 + SCALE_FAULT) - r).abs()
        caught = [f for f in GATE_FAULTS
                  if bool(((grad[:, :, i].float() * (1 + f) - r).abs() > gate).any())]
        rec[g] = {"err_over_limit": (err / limit).max().item(),
                  "err_over_gate": (err / gate).max().item(),
                  "past_limit": int((err > limit).sum().item()),
                  "finite": bool(torch.isfinite(grad[:, :, i].float()).all()),
                  "fault_past_gate": int((fault > gate).sum().item()),
                  # the smallest scanned uniform scale fault the gate catches
                  "smallest_caught_fault": min(caught) if caught else None}
        check(rec[g]["finite"], f"large-logit {g} finite")
        check(rec[g]["err_over_gate"] <= 1.0,
              f"large-logit {g} {rec[g]['err_over_gate']} over its gate")
        check(rec[g]["fault_past_gate"] > 0, f"large-logit {g}: a 2% fault passes the gate")
    emit(rec)
    check(rec["max_abs_lse"] > 100.0, f"large-logit lse {rec['max_abs_lse']}")
    del q, k, v, o, lse, do, grad, ref, flips
    torch.cuda.empty_cache()
    phase_bwd_against_jax(torch, fa, bwd_fixture)


def phase_bwd_against_jax(torch, fa, bwd_fixture):
    """The bf16 backward kernels against the JAX package's own backward at
    the large-logit case of ROADMAP.md Queue 3, (2, 129, 2, 32) seed 6 ×8:
    ``tools/data/bwd_large_logits.npz`` holds the inputs the CUDA generator
    draws there and JAX's O, lse, dq, dk and dv (interpret mode, on the
    CPU; pinned by tests/test_torch_port_bwd_fixture.py). Both the kernels
    and the plain version get JAX's O and lse. Recorded per gradient: |Δ|
    over ``grad_error_limit`` of JAX's result for the kernel and for the
    plain version, and the kernel's over the gate (dq, dk: the limit plus
    ``ds_flip_bound``; dv: the limit), which it must meet, a 2% fault
    failing it."""
    t = bwd_fixture.load("cuda")
    drawn = bwd_fixture.large_logit_inputs("cuda", **bwd_fixture.CASE)
    same = all(torch.equal(x.view(torch.int16), t[n].view(torch.int16))
               for n, x in zip(bwd_fixture.INPUTS, drawn))
    scale = bwd_fixture.CASE["D"] ** -0.5
    args = (t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"], scale)
    grad = fa.flash_backward(*args)
    plain = fa.flash_backward_reference(*args)
    flips = fa.ds_flip_bound(t["q"], t["k"], t["v"], t["do"], t["lse"],
                             fa.backward_delta(t["o"], t["do"]), scale)
    rec = {"phase": "bwd-large-logits", "against": "jax", **bwd_fixture.CASE,
           "dtype": "bfloat16", "inputs_match_generator": same}
    for i, g in enumerate(("dq", "dk", "dv")):
        ref = t[g].float()
        limit = fa.grad_error_limit(t[g])
        gate = limit + flips[i] if i < 2 else limit
        err = (grad[:, :, i].float() - ref).abs()
        fault = (grad[:, :, i].float() * (1 + SCALE_FAULT) - ref).abs()
        rec[g] = {"kernel_err_over_limit": (err / limit).max().item(),
                  "plain_err_over_limit": ((plain[:, :, i].float() - ref).abs()
                                           / limit).max().item(),
                  "kernel_err_over_gate": (err / gate).max().item(),
                  "kernel_past_limit": int((err > limit).sum().item()),
                  "fault_past_gate": int((fault > gate).sum().item())}
        check(bool(torch.isfinite(grad[:, :, i].float()).all()), f"jax-fixture {g} finite")
        check(rec[g]["kernel_err_over_gate"] <= 1.0,
              f"jax-fixture {g} {rec[g]['kernel_err_over_gate']} over its gate")
        check(rec[g]["fault_past_gate"] > 0, f"jax-fixture {g}: a 2% fault passes the gate")
    emit(rec)
    check(same, "the fixture's inputs are not what the CUDA generator draws")


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
        with torch.inference_mode():
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


def _cold_batches(n: int, batch: int, seed: int):
    """Synthetic raw cold batches: uint8 (batch, 200, 200, 3) bases and
    t ∈ [1, 7], from a seeded numpy generator (the repo's way of timing
    training without a dataset, bench.py's synthetic cold path)."""
    import numpy as np

    rs = np.random.default_rng(seed)
    return [(rs.integers(0, 256, (batch, 200, 200, 3), dtype=np.uint8),
             rs.integers(1, 8, (batch,), dtype=np.int32)) for _ in range(n)]


def _train_model(torch, **rates):
    from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT

    return DiffusionViT(**MODEL_CONFIGS[MODEL], use_flash=rates.pop("use_flash", True),
                        dtype=rates.pop("dtype", torch.bfloat16), seed=SEED, **rates)


def phase_train_check(torch, fa):
    """One optimizer step, flash kernels vs dense attention, every drop
    rate 0, same weights and batch; float32 and bfloat16."""
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    base, t = _cold_batches(1, CHECK_BATCH, SEED + 2)[0]
    batch = (torch.from_numpy(base).cuda(), torch.from_numpy(t).cuda())
    lr = 0.005 * 16 / 512  # the YAML's lr: base_lr · effective batch / 512
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        got = {}
        for use_flash in (True, False):
            model = _train_model(torch, use_flash=use_flash, dtype=dtype,
                                 drop_rate=0.0, attn_drop_rate=0.0,
                                 drop_path_rate=0.0)
            p0 = [p.detach().clone() for p in model.parameters()]
            state = create_train_state(model, lr, TRAIN_TOTAL_STEPS)
            step = make_train_step(model, prepare=prepare)
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0
            state, loss, _ = step(state, batch, torch.Generator(device="cuda"),
                                  torch.tensor(5.0, device="cuda"))
            torch.cuda.synchronize()
            got[use_flash] = {
                "loss": loss.item(), "grad_norm": state.grad_norm.item(),
                "update": [p.detach() - a for p, a in zip(model.parameters(), p0)],
                "launches": dict(fa.LAUNCHES)}
            del model, state, step, p0
        f, d = got[True], got[False]
        upd_gap = math.sqrt(sum(float(((a - b) ** 2).sum())
                                for a, b in zip(f["update"], d["update"])))
        upd_norm = math.sqrt(sum(float((b ** 2).sum()) for b in d["update"]))
        max_gap = max(float((a - b).abs().max()) for a, b in zip(f["update"], d["update"]))
        tol = TRAIN_CHECK_TOL[name]
        rec = {"phase": "train-check", "model": MODEL, "dtype": name,
               "batch": CHECK_BATCH, "lr": lr,
               "loss_flash": f["loss"], "loss_dense": d["loss"],
               "loss_rel": abs(f["loss"] - d["loss"]) / abs(d["loss"]),
               "grad_norm_flash": f["grad_norm"], "grad_norm_dense": d["grad_norm"],
               "grad_norm_rel": abs(f["grad_norm"] - d["grad_norm"]) / d["grad_norm"],
               "upd_rel": upd_gap / upd_norm, "max_param_gap_lr": max_gap / lr,
               "launches_flash": f["launches"], "launches_dense": d["launches"],
               "tol": tol, "tol_max_param_gap_lr": MAX_UPDATE_GAP_LR}
        emit(rec)
        depth = 6
        launched = {k: n for k, n in f["launches"].items() if n}
        check(launched == {"flash_fwd": depth, "flash_bwd_dq": depth,
                           "flash_bwd_dkv": depth},
              f"train-check flash launches {f['launches']}")
        check(not any(d["launches"].values()),
              f"train-check dense launches {d['launches']}")
        for key in ("loss", "grad_norm", "upd_rel"):
            val = rec[f"{key}_rel"] if key != "upd_rel" else rec["upd_rel"]
            check(math.isfinite(val) and val <= tol[key],
                  f"train-check {name} {key} {val} over {tol[key]}")
        check(rec["max_param_gap_lr"] <= MAX_UPDATE_GAP_LR,
              f"train-check {name} param gap {rec['max_param_gap_lr']} lr")
        del got, f, d
        torch.cuda.empty_cache()


def _run_steps(torch, step, state, batches, gen, loss_rec):
    from ddim_cold_torch.data.loader import device_prefetch

    loss = None
    for b in device_prefetch(batches, "cuda"):
        state, loss, loss_rec = step(state, b, gen, loss_rec)
    return state, loss, loss_rec


def phase_train(torch, fa):
    """The training path: 3 warm-up and 20 timed steps of the bf16 flash
    model; then the attention-dropout (dense) rule."""
    from ddim_cold_torch.config import ExperimentConfig
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    # the 20220822_200px.yaml hyper-parameters, built in code
    config = ExperimentConfig(exp_name="chip_smoke", framework="train", amp=True,
                              batch_size=8, epoch=(0, 8), base_lr=0.005,
                              image_size=(200, 200), diff_step=7, patch_size=4,
                              embed_dim=256, depth=6, head=4, use_flash=True)
    batch = config.effective_batch
    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    host = _cold_batches(TRAIN_WARM + TRAIN_STEPS + PROFILE_STEPS, batch, SEED + 3)
    records = {}
    for attn_drop, n_steps in ((0.0, TRAIN_STEPS), (0.1, DENSE_STEPS)):
        model = _train_model(torch, use_flash=config.use_flash, drop_rate=0.1,
                             attn_drop_rate=attn_drop, drop_path_rate=0.1)
        state = create_train_state(model, config.lr, TRAIN_TOTAL_STEPS)
        step = make_train_step(model, prepare=prepare)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        loss_rec = torch.tensor(5.0, device="cuda")
        warm = TRAIN_WARM if attn_drop == 0.0 else 1
        if attn_drop:
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0  # the dense rule: nothing from here on
        state, _, loss_rec = _run_steps(torch, step, state, host[:warm], gen, loss_rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if not attn_drop:
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0  # main path starts here
        t0 = time.perf_counter()
        state, loss, loss_rec = _run_steps(torch, step, state,
                                           host[warm:warm + n_steps], gen, loss_rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv")}  # ... and ends here
        rec = {"phase": "train", "model": MODEL, "dtype": "bfloat16",
               "use_flash": config.use_flash, "drop_rate": 0.1,
               "drop_path_rate": 0.1, "attn_drop_rate": attn_drop,
               "path": "flash" if not attn_drop else "dense (attention dropout)",
               "batch": batch, "lr": config.lr, "warmup_steps": warm,
               "steps": n_steps, "wall_s": wall,
               "ms_per_step": wall / n_steps * 1e3,
               "img_per_sec": batch * n_steps / wall,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "final_loss": loss.item(), "loss_ema": loss_rec.item(),
               "launches": launches}
        emit(rec)
        check(math.isfinite(rec["final_loss"]), f"train loss {rec['final_loss']}")
        if attn_drop:
            check(not any(launches.values()),
                  f"attn_drop_rate={attn_drop} launched flash kernels: {launches}")
        else:
            expect = model.depth * n_steps
            check(all(n == expect for n in launches.values()),
                  f"train launches {launches}, expected {expect} each")
            records = (model, state, step, host[-PROFILE_STEPS:], gen, launches)
        if attn_drop:
            del model, state, step
            torch.cuda.empty_cache()
    return records


def phase_train_profile(torch, model, state, step, batch, gen):
    """Where a training step's time goes: PROFILE_STEPS more steps under
    torch.profiler (the host→device copies of the later batches overlap the
    earlier steps, as in a run); device time of the three kernels and of
    the rest, and the device's idle share over the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss_rec = torch.tensor(5.0, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_steps(torch, step, state, batch, gen, loss_rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": [], "gemm": [],
             "other": []}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = next((k for k in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")
                     if k in name), None)
        if kind is None:
            kind = ("gemm" if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet"))
                    else "other")
        kinds[kind].append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name[:80], [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    spans = [iv for ivs in kinds.values() for iv in ivs]
    window_us = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)) if spans else 0.0
    busy_us = _union_us(spans)
    rec = {"phase": "train-profile", "steps": len(batch), "wall_s": wall,
           "device_window_s": window_us / 1e6, "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / window_us if window_us else None}
    for kind, ivs in kinds.items():
        rec[f"{kind}_s"] = sum(hi - lo for lo, hi in ivs) / 1e6
        rec[f"{kind}_launches"] = len(ivs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec["top_kernels"] = [{"name": n, "s": us / 1e6, "launches": c}
                          for n, (us, c) in top]
    emit(rec)
    for kind in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(rec[f"{kind}_launches"] == model.depth * len(batch),
              f"profiled {kind} launches {rec[f'{kind}_launches']}")


# ------------------------------------------------- the quantized trunk

#: quantized trunk kernels at the 200px/p4 serve shape (B=8 rows of N=2501
#: tokens, C=256, 4 heads) and at 200px/p8 (N=626, C=384, 12 heads of 32)
QUANT_GEOMS = (("200_p4", 8, 2501, 256, 4), ("200_p8", 8, 626, 384, 12))
#: quant-forward: each quantized or fused forward against the float one on
#: the same weights (x̂0, |x̂0| ≲ 1): w8a16 rounds each weight by at most
#: half its channel's step; w8a8 also rounds the activations; fused vs
#: unfused w8a16 and float-fused vs float are the same arithmetic in another
#: order (FWD_TOL)
QUANT_FWD_TOL = {"pallas": 2e-2, "w8a8": 5e-2, "xla": 2e-2}
#: the four served configs: (quant, fused) and the kernels one layer-forward
#: launches, with how many times
SERVE_QUANT = ((("pallas", False), {"dequant_mm": 4, "flash_fwd": 1}),
               (("pallas", True), {"fused_trunk": 1, "mlp_fused": 1}),
               (("w8a8", True), {"fused_trunk": 1, "mlp_fused": 1}),
               ((None, True), {"flash_fwd": 1, "mlp_fused": 1}))
QUANT_KERNELS = ("flash_fwd", "dequant_mm", "mlp_fused", "fused_trunk")


def _bound(ops_by_type, nbytes):
    """Least time: the operations at their type's peak against the bytes
    at the memory rate."""
    t_ops = sum(ops / PEAK_FLOPS[kind] for kind, ops in ops_by_type.items())
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _held(torch, got, ref, limit):
    """Element-wise check of a kernel output against its plain version, and
    that the limit catches the output scaled 2% wrong."""
    diff = (got.float() - ref.float()).abs()
    scaled = (got.float() * (1 + SCALE_FAULT) - ref.float()).abs()
    return {"max_abs_err": diff.max().item(),
            "max_abs_ref": ref.float().abs().max().item(),
            "max_limit": limit.max().item(), "min_limit": limit.min().item(),
            "max_err_over_limit": (diff / limit).max().item(),
            "mean_abs_ref": ref.float().abs().mean().item(),
            "within_limit": bool((diff <= limit).all()),
            "catches_2pct_scale": bool((scaled > limit).any()),
            "finite": bool(torch.isfinite(got.float()).all())}


def _check_held(rec, what):
    check(rec["finite"], f"{what} finite")
    check(rec["within_limit"], f"{what} error {rec['max_abs_err']} over its limit")
    check(rec["catches_2pct_scale"], f"{what} limit misses a {SCALE_FAULT:.0%} "
          "scale fault")


def phase_kernels_quant(torch, fa, quant):
    """dequant_mm, mlp_fused and fused_trunk against their plain versions."""
    import torch.nn.functional as F

    records = {}
    for geom, B, N, C, H in QUANT_GEOMS:
        M = B * N
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            elem = 4 if name == "float32" else 2
            gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
            x = torch.randn((B, N, C), generator=gen, device="cuda").to(dtype)
            x2 = x.reshape(M, C)
            w = {n: quant.quantize_weight(torch.randn((rows, C), generator=gen,
                                                      device="cuda") * 0.05)
                 for n, rows in (("qkv", 3 * C), ("proj", C), ("fc1", C), ("fc2", C))}
            b = {n: torch.randn(wt[0].shape[0], generator=gen, device="cuda") * 0.1
                 for n, wt in w.items()}
            deq = {n: quant.dequantize_weight(*wt, dtype) for n, wt in w.items()}

            # dequant_mm: the qkv projection of the unfused w8a16 path (N =
            # 3C), and proj's shape (N = C; fc1 and fc2 have it too)
            for lin, key in (("qkv", "pallas"), ("proj", "pallas_n_c")):
                codes, scale = w[lin]
                N_out = codes.shape[0]
                run = lambda: quant.dequant_mm(x2, codes, scale, b[lin], dtype)
                y = run()
                torch.cuda.synchronize()
                ref = quant.dequant_mm_reference(x2, codes, scale, b[lin]).to(dtype)
                rec = {"phase": "kernel", "kernel": "dequant_mm", "geometry": geom,
                       "M": M, "K": C, "N": N_out, "dtype": name, "out_dtype": name,
                       **_held(torch, y, ref, quant.mm_error_limit(x2, codes, scale, ref)),
                       "ms": time_ms(torch, run),
                       "plain_ms": time_ms(torch, lambda: quant.dequant_mm_reference(
                           x2, codes, scale, b[lin]), reps=10),
                       "library_ms": time_ms(torch, lambda: F.linear(
                           x2, deq[lin], b[lin].to(dtype))),
                       "library_covers": "F.linear on the weight dequantized beforehand"}
                rec["bound_ms"], rec["bound_by"] = _bound(
                    {name: 2.0 * M * N_out * C}, M * C * elem + N_out * C + M * N_out * elem)
                emit(rec)
                _check_held(rec, f"dequant_mm {geom} {name} N={N_out}")
                records[("dequant_mm", geom, name, key)] = rec

            # mlp_fused: float, w8a16, w8a8
            for mode in (None, "pallas", "w8a8"):
                if mode is None:
                    w1, w2 = deq["fc1"].float(), deq["fc2"].float()
                    kw = {}
                else:
                    (w1, s1), (w2, s2) = w["fc1"], w["fc2"]
                    kw = dict(scale1=s1, scale2=s2, mode=mode)
                args = (x2, w1, b["fc1"], w2, b["fc2"])
                run = lambda: quant.mlp_fused(*args, **kw)
                with torch.inference_mode():
                    y = run()
                torch.cuda.synchronize()
                ref, row_scale = quant.mlp_fused_reference(*args, **kw,
                                                           return_row_scale=True)
                flip = (quant.requant_flip_bound(row_scale, w2, s2)
                        if mode == "w8a8" else None)
                b1c, b2c = b["fc1"].to(dtype), b["fc2"].to(dtype)
                rec = {"phase": "kernel", "kernel": "mlp_fused", "geometry": geom,
                       "M": M, "C": C, "hidden": C, "dtype": name,
                       "mode": mode or "float",
                       **_held(torch, y, ref, quant.trunk_error_limit(ref, mode, flip)),
                       "ms": time_ms(torch, run),
                       "plain_ms": time_ms(torch, lambda: quant.mlp_fused_reference(
                           *args, **kw), reps=5, warm=1),
                       "library_ms": time_ms(torch, lambda: F.linear(F.gelu(
                           F.linear(x2, deq["fc1"], b1c)), deq["fc2"], b2c)),
                       "library_covers": "F.linear, F.gelu, F.linear on weights "
                                         "dequantized beforehand"}
                rec["bound_ms"], rec["bound_by"] = _bound(
                    {"int8" if mode == "w8a8" else name: 4.0 * M * C * C},
                    2 * M * C * elem + w1.numel() * w1.element_size() * 2)
                emit(rec)
                _check_held(rec, f"mlp_fused {geom} {name} {mode}")
                records[("mlp_fused", geom, name, mode)] = rec

            # fused_trunk: w8a16, w8a8
            D = C // H
            for mode in ("pallas", "w8a8"):
                targs = (x, *w["qkv"], b["qkv"], *w["proj"], b["proj"])
                kw = dict(num_heads=H, scale=D**-0.5, mode=mode)
                run = lambda: fa.fused_trunk_attention(*targs, **kw)
                with torch.inference_mode():
                    y = run()
                torch.cuda.synchronize()
                ref, row_scale = fa.fused_trunk_attention_reference(
                    *targs, **kw, return_row_scale=True)
                flip = (quant.requant_flip_bound(row_scale, *w["proj"])
                        if mode == "w8a8" else None)

                def library():
                    qkv = F.linear(x, deq["qkv"], b["qkv"].to(dtype))
                    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
                    o = F.scaled_dot_product_attention(q, k, v, scale=D**-0.5)
                    return F.linear(o.transpose(1, 2).reshape(B, N, C), deq["proj"],
                                    b["proj"].to(dtype))

                proj_ops = 2.0 * B * N * C * 4 * C
                attn_ops = 4.0 * B * N * N * C
                clusters = -(-N // (fa.FUSED_ROWS * fa.FUSED_CLUSTER))
                rec = {"phase": "kernel", "kernel": "fused_trunk", "geometry": geom,
                       "B": B, "N": N, "C": C, "H": H, "dtype": name, "mode": mode,
                       **_held(torch, y, ref, quant.trunk_error_limit(ref, mode, flip)),
                       "ms": time_ms(torch, run, reps=10),
                       "plain_ms": time_ms(torch, lambda: fa.fused_trunk_attention_reference(
                           *targs, **kw), reps=3, warm=1),
                       "library_ms": time_ms(torch, library),
                       "library_covers": "F.linear, SDPA, F.linear on weights "
                                         "dequantized beforehand",
                       "work_gflop": (proj_ops + attn_ops) / 1e9,
                       # every cluster of 8 q tiles re-projects all keys and values
                       "kv_recompute_gflop": B * clusters * 2.0
                       * (-(-N // 64) * 64) * C * 2 * C / 1e9}
                rec["bound_ms"], rec["bound_by"] = _bound(
                    {"int8" if mode == "w8a8" else name: proj_ops, name: attn_ops}
                    if mode == "w8a8" else {name: proj_ops + attn_ops},
                    2 * B * N * C * elem + 4 * C * C)
                emit(rec)
                _check_held(rec, f"fused_trunk {geom} {name} {mode}")
                records[("fused_trunk", geom, name, mode)] = rec
            del x, x2, w, b, deq, y, ref
            torch.cuda.empty_cache()
    return records


def phase_quant_forward(torch, DiffusionViT, MODEL_CONFIGS, quant):
    """Full-width model: each quantized or fused forward against the float
    one, and fused against unfused w8a16, on the same weights."""
    cfg = MODEL_CONFIGS[MODEL]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    H, W = cfg["img_size"]
    x = torch.randn((2, H, W, 3), generator=gen, device="cuda")
    t = torch.randint(0, 2000, (2,), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        base = DiffusionViT(**cfg, dtype=dtype, use_flash=True, seed=SEED)
        qstate = quant.quantize_state_dict(base.state_dict())
        outs = {}
        with torch.inference_mode():
            outs[(None, False)] = base(x, t)
            for q, f in (("xla", False), ("pallas", False), ("w8a8", False),
                         ("pallas", True), ("w8a8", True), (None, True)):
                m = base.clone(quant=q, fused=f)
                m.load_state_dict(qstate if q else base.state_dict(), strict=True,
                                  assign=True)
                outs[(q, f)] = m(x, t)
        torch.cuda.synchronize()
        ref = outs[(None, False)]
        errs = {f"{q or 'float'}{'_fused' if f else ''}": (o - ref).abs().max().item()
                for (q, f), o in outs.items() if (q, f) != (None, False)}
        fused_vs_unfused = (outs[("pallas", True)] - outs[("pallas", False)]).abs().max().item()
        tol = {"float_fused": FWD_TOL[name], "fused_vs_unfused_pallas": FWD_TOL[name],
               **{k: QUANT_FWD_TOL[k.split("_")[0]] for k in errs if k != "float_fused"}}
        emit({"phase": "quant-forward", "model": MODEL, "dtype": name, "batch": 2,
              "max_abs_err_vs_float": errs,
              "fused_vs_unfused_pallas": fused_vs_unfused, "tol": tol,
              "out_abs_max": ref.abs().max().item()})
        for key, o in outs.items():
            check(o.shape == (2, H, W, 3) and bool(torch.isfinite(o).all()),
                  f"quant-forward output {key} {name}")
        for key, err in errs.items():
            check(err <= tol[key], f"quant-forward {key} {name}: {err} over {tol[key]}")
        check(fused_vs_unfused <= tol["fused_vs_unfused_pallas"],
              f"quant-forward fused vs unfused {name}: {fused_vs_unfused}")
        del base, qstate, outs, m
        torch.cuda.empty_cache()


def _zero(counters):
    for c in counters:
        for key in list(c):
            c[key] = 0


def phase_serve_quant(torch, model, fa, quant, serve):
    """The four quantized or fused configs served by one warmed engine, one
    8-row request each, with exact launch counts per config."""
    import numpy as np

    eng = serve.Engine(model, buckets=(8,))
    configs = [serve.SamplerConfig(k=K, quant=q, fused=f) for (q, f), _ in SERVE_QUANT]
    t0 = time.perf_counter()
    warm = serve.warmup(eng, configs)
    warm_s = time.perf_counter() - t0
    programs = eng.stats["programs"]
    steps = len(range(model.total_steps - 1, 0, -K))
    launches = {}
    for config, (_, per_layer) in zip(configs, SERVE_QUANT):
        label = f"quant={config.quant},fused={config.fused}"
        _zero((fa.LAUNCHES, quant.LAUNCHES))          # this path starts here
        ticket = eng.submit(seed=SEED + 7, n=8, config=config)
        report = eng.run()
        torch.cuda.synchronize()
        got = {k: fa.LAUNCHES[k] + quant.LAUNCHES[k] for k in QUANT_KERNELS}  # ... ends
        want = {k: per_layer.get(k, 0) * model.depth * steps for k in QUANT_KERNELS}
        img = ticket.result(timeout=900)
        launches[(config.quant, config.fused)] = got
        emit({"phase": "serve-quant", "model": MODEL, "dtype": "bfloat16", "k": K,
              "config": label, "rows": report["rows"], "batches": report["batches"],
              "wall_s": report["wall_s"], "img_per_sec": report["img_per_sec"],
              "programs_after_warmup": report["programs"], "launches": got,
              "expected_launches": want, "warmup_s": warm_s,
              "warmed_programs": warm["programs"],
              "param_bytes": eng.stats["param_bytes"],
              "param_bytes_quant": eng.stats["param_bytes_quant"]})
        check(img.shape == (8, 200, 200, 3) and bool(np.isfinite(img).all()),
              f"serve-quant {label} output")
        check(bool(((img >= 0.0) & (img <= 1.0)).all()), f"serve-quant {label} in [0, 1]")
        check(report["failed_tickets"] == 0 and report["programs"] == 0
              and eng.stats["programs"] == programs, f"serve-quant {label} programs")
        check(got == want, f"serve-quant {label} launches {got}, expected {want}")
    return eng, configs, launches


#: the serve-edit phase: the start level of the draft and interp tasks, the
#: draft's preview stride, and the cold levels (the 200px YAML's diff_step)
EDIT_T_START, EDIT_PREVIEW, EDIT_LEVELS = 1800, 10, 7


def edit_cases(serve):
    """(label, config, kernels one layer-forward launches, with how many
    times) of the serve-edit phase."""
    C = serve.SamplerConfig
    flash = {"flash_fwd": 1}
    return (
        ("cold", C(sampler="cold", levels=EDIT_LEVELS), flash),
        ("superres", C(task="superres", sampler="cold", levels=3, quant="pallas"),
         {"flash_fwd": 1, "dequant_mm": 4}),
        ("inpaint", C(task="inpaint", k=K), flash),
        ("inpaint fused", C(task="inpaint", k=K, quant="pallas", fused=True),
         {"fused_trunk": 1, "mlp_fused": 1}),
        ("draft", C(task="draft", t_start=EDIT_T_START, k=K, preview_every=EDIT_PREVIEW),
         flash),
        ("interp", C(task="interp", t_start=EDIT_T_START, k=K), flash),
        ("fewstep", C(steps=4), flash),
        ("student", C(steps=4, student=True), flash),
    )


def _forwards(config, total_steps: int) -> int:
    """Model forwards of one batch of ``config``."""
    from ddim_cold_torch.ops import schedule

    if config.sampler == "cold":
        return config.levels
    if config.steps:
        return config.steps
    return len(schedule.ddim_time_sequence(total_steps, config.k, config.t_start))


def phase_serve_edit(torch, model, fa, quant, serve, DiffusionViT, MODEL_CONFIGS):
    """The cold, few-step, student and editing paths, served: one engine
    (buckets 4, 8) over the bf16 model with a second, seed-1 weight set as
    the student, warmed with every config of ``edit_cases``, serves one
    8-row request of each. The launch counters are zeroed just before each
    drain and must read exactly depth × forwards per kernel of the config.
    Then each request is held to the direct ``workloads.*`` or
    ``sampling.*`` call at the same 8-row shape, on models built apart from
    the engine with the config's weights: bit for bit, the draft's previews
    too (the direct call's trajectory at ``preview_indices``, the result its
    last frame); inpaint's known pixels are (known + 1) / 2 bit for bit, and
    ``superres_project`` makes the nearest-downsampled result the input."""
    import numpy as np

    from ddim_cold_torch import workloads
    from ddim_cold_torch.data.resize import nearest_indices
    from ddim_cold_torch.ops import sampling

    cfg = MODEL_CONFIGS[MODEL]
    H, W = model.img_size
    student = DiffusionViT(**cfg, dtype=torch.bfloat16, use_flash=True, seed=SEED + 1)
    eng = serve.Engine(model, buckets=BUCKETS, student_params=student.state_dict())
    cases = edit_cases(serve)
    t0 = time.perf_counter()
    warm = serve.warmup(eng, [c for _, c, _ in cases])
    warm_s = time.perf_counter() - t0
    programs = eng.stats["programs"]
    check(programs == len(cases) * len(BUCKETS), f"serve-edit warmed {programs} programs")

    rs = np.random.RandomState(SEED)
    imgs = rs.uniform(-1, 1, (8, H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    mask[:, :W // 2] = 1.0                                   # the left half known
    low = rs.uniform(-1, 1, (8, H >> 3, W >> 3, 3)).astype(np.float32)   # 25×25, level 3
    pair = imgs[:2]
    submit = {
        "cold": dict(seed=40, n=8), "superres": dict(x_init=workloads.superres_init(low, H)),
        "inpaint": dict(seed=42, x_init=imgs, mask=mask),
        "inpaint fused": dict(seed=43, x_init=imgs, mask=mask),
        "draft": dict(seed=44, x_init=imgs), "interp": dict(seed=45, n=8, x_init=pair),
        "fewstep": dict(seed=46, n=8), "student": dict(seed=47, n=8)}
    served, launches = {}, {}
    for label, config, per_layer in cases:
        _zero((fa.LAUNCHES, quant.LAUNCHES))          # this path starts here
        ticket = eng.submit(config=config, **submit[label])
        report = eng.run()
        torch.cuda.synchronize()
        got = {k: fa.LAUNCHES[k] + quant.LAUNCHES[k] for k in QUANT_KERNELS}  # ... ends
        forwards = _forwards(config, model.total_steps)
        want = {k: per_layer.get(k, 0) * model.depth * forwards for k in QUANT_KERNELS}
        img = ticket.result(timeout=900)
        previews = list(ticket.previews(timeout=60))
        served[label], launches[label] = (img, previews), got
        emit({"phase": "serve-edit", "model": MODEL, "dtype": "bfloat16", "config": label,
              "sampler_config": {k: v for k, v in vars(config).items()
                                 if v != getattr(serve.SamplerConfig, k)},
              "forwards": forwards, "rows": report["rows"], "batches": report["batches"],
              "wall_s": report["wall_s"], "img_per_sec": report["img_per_sec"],
              "programs_after_warmup": report["programs"], "launches": got,
              "expected_launches": want, "preview_frames": len(previews),
              "warmup_s": warm_s, "warmed_programs": warm["programs"]})
        check(img.shape == (8, H, W, 3) and bool(np.isfinite(img).all()),
              f"serve-edit {label} output")
        check(bool(((img >= 0.0) & (img <= 1.0)).all()), f"serve-edit {label} in [0, 1]")
        check(report["failed_tickets"] == 0 and report["programs"] == 0
              and eng.stats["programs"] == programs, f"serve-edit {label} programs")
        check(got == want, f"serve-edit {label} launches {got}, expected {want}")
    check(_forwards(cases[4][1], model.total_steps) == 90, "draft forwards")
    del eng

    # the direct calls, on models built apart from the engine
    def variant(q, fused):
        m = model.clone(quant=q, fused=fused)
        m.load_state_dict(quant.quantize_state_dict(model.state_dict()), strict=True)
        return m

    gen = lambda label: torch.Generator(device="cuda").manual_seed(submit[label]["seed"])  # noqa: E731
    direct = {
        "cold": lambda: sampling.cold_sample(model, gen("cold"), n=8, levels=EDIT_LEVELS),
        "superres": lambda: workloads.super_resolve(variant("pallas", False), low, level=3),
        "inpaint": lambda: workloads.inpaint(model, gen("inpaint"), imgs, mask, k=K),
        "inpaint fused": lambda: workloads.inpaint(variant("pallas", True),
                                                   gen("inpaint fused"), imgs, mask, k=K),
        "draft": lambda: workloads.draft_to_drawing(model, gen("draft"), imgs,
                                                    t_start=EDIT_T_START, k=K,
                                                    return_sequence=True),
        "interp": lambda: workloads.interpolate(model, gen("interp"), pair[0], pair[1],
                                                n_interp=8, t_start=EDIT_T_START, k=K),
        "fewstep": lambda: sampling.ddim_sample_fewstep(model, gen("fewstep"), steps=4, n=8),
        "student": lambda: sampling.ddim_sample_fewstep(student, gen("student"), steps=4,
                                                        n=8),
    }
    rec = {"phase": "serve-edit-direct"}
    for label, call in direct.items():
        want = call().cpu().numpy()
        img, previews = served[label]
        if label == "draft":
            idx = workloads.preview_indices(want.shape[0] - 1, EDIT_PREVIEW)
            ok_prev = ([s for s, _ in previews] == idx and
                       all(np.array_equal(f, want[s]) for s, f in previews))
            rec["draft_preview_steps"] = [s for s, _ in previews]
            check(ok_prev and len(idx) == 8, "serve-edit draft previews are not the "
                  "direct trajectory's frames")
            want = want[-1]
        rec[label] = {"bitwise": bool(np.array_equal(img, want)),
                      "max_abs_diff": float(np.abs(img - want).max())}
        check(rec[label]["bitwise"], f"serve-edit {label} differs from the direct call")
    sel = mask.astype(bool)
    for label in ("inpaint", "inpaint fused"):
        known_ok = bool(np.array_equal(served[label][0][:, sel], (imgs[:, sel] + 1.0) / 2.0))
        rec[f"{label} known pixels exact"] = known_ok
        check(known_ok, f"serve-edit {label}: known pixels moved")
    projected = workloads.superres_project(served["superres"][0], low)
    iy = nearest_indices(low.shape[1], H)
    ix = nearest_indices(low.shape[2], W)
    rec["superres projected exact"] = bool(np.array_equal(
        projected[:, iy[:, None], ix[None, :]], (low + 1.0) / 2.0))
    check(rec["superres projected exact"], "serve-edit superres projection")
    emit(rec)
    del student
    torch.cuda.empty_cache()
    return launches


#: serve-cache: the adaptive config's drift gate (bench.py:991-992) and the
#: token config's live share, the "liveliest quarter" (bench.py:1115-1117)
CACHE_TAU, TOKEN_SHARE = 0.05, 4


def cache_cases(serve, n_tokens: int):
    """(label, config, kernels one layer-forward launches) of the
    serve-cache phase; ``n_tokens`` is the model's N+1."""
    C = serve.SamplerConfig
    flash = {"flash_fwd": 1}
    k_tok = -(-n_tokens // TOKEN_SHARE)
    return (
        ("delta i2", C(k=K, cache_interval=2), flash),
        ("full i2", C(k=K, cache_interval=2, cache_mode="full"), flash),
        ("adaptive i4", C(k=K, cache_interval=4, cache_mode="adaptive",
                          cache_threshold=CACHE_TAU, telemetry=True), flash),
        (f"token i2 k{k_tok}", C(k=K, cache_interval=2, cache_mode="token",
                                 cache_tokens=k_tok), flash),
        ("fused w8a16 delta i2", C(k=K, cache_interval=2, quant="pallas", fused=True),
         {"fused_trunk": 1, "mlp_fused": 1}),
        ("pallas delta i2", C(k=K, cache_interval=2, quant="pallas"),
         {"dequant_mm": 4, "flash_fwd": 1}),
        ("inpaint delta i2", C(task="inpaint", k=K, cache_interval=2), flash),
        ("cold delta i2", C(sampler="cold", levels=EDIT_LEVELS, cache_interval=2), flash),
        ("fewstep delta i2", C(steps=4, cache_interval=2), flash),
    )


def _uncached(config):
    """The same config with the step cache off."""
    import dataclasses

    return dataclasses.replace(config, cache_interval=1, cache_mode="delta",
                               cache_threshold=None, cache_tokens=0, telemetry=False)


def _cache_plan(model, config, taken=None):
    """(spec, branches taken, blocks run) of one batch of a cached config:
    the static table, or for adaptive the branches its telemetry read."""
    from ddim_cold_torch.ops import sampling, step_cache

    spec = sampling._cached_spec(model, _forwards(config, model.total_steps),
                                 config.cache_interval, config.cache_mode,
                                 config.cache_threshold, config.cache_tokens or None)
    branches = list(spec.branches if taken is None else taken)
    return spec, branches, sum(step_cache.blocks_run(spec, b) for b in branches)


def _device_launches(torch, fn):
    """Every kernel the device ran during ``fn()`` (torch.profiler): their
    count, the device's idle share over their window and its busy seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    window = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)) if spans else 0.0
    busy = _union_us(spans)
    return len(spans), (1.0 - busy / window) if window else None, busy / 1e6


def phase_serve_cache(torch, model, fa, quant, serve):
    """The step cache, served: one engine (buckets 4, 8) over the bf16
    model, warmed with every config of ``cache_cases`` and their uncached
    twins, serves one 8-row request of each cached config and of the
    uncached DDIM config three times: the first drain timed, the second
    with ``torch.cuda.memory_allocated`` read before and after (the
    spare-cache pool keeps it flat), the third under torch.profiler (every
    device kernel counted, busy time, the idle share); then each cached
    config and its twin are drained in turns (twin, cached, cached, twin)
    for the speed-up, as the host's pace drifts between drains. The launch
    counters (and the adaptive gate's host reads, ``step_cache.GATE_SYNCS``)
    are zeroed just before the first two drains and must read exactly what
    the branch table says (for adaptive, the branches its telemetry took):
    blocks run × launches per block. Then every served row is held bit for
    bit to its direct ``sampling.*`` / ``workloads.*`` call at the same
    8-row shape; a 3-row adaptive request in bucket 4 (row-0 replica
    padding) to the direct call on the same padded batch, and its gate to
    the unpadded call's; and the collapses: τ = 0 and ``cache_tokens`` = N+1
    are the uncached batch, τ = ∞ is the delta batch, telemetry off is
    telemetry on, ``cache_interval=1`` is the uncached batch. Reported:
    wall and img/s, the speed-up over the uncached batch beside
    ``flops_saved_fraction``, max and mean |cached − uncached| at the same
    seed, device launches per wall second."""
    import numpy as np

    from ddim_cold_torch import workloads
    from ddim_cold_torch.ops import sampling, step_cache

    H, W = model.img_size
    n_tokens = model.num_patches + 1
    cases = cache_cases(serve, n_tokens)
    plain = serve.SamplerConfig(k=K)
    # each cached config's uncached twin, the speed-up's baseline
    twins = {label: _uncached(config) for label, config, _ in cases}
    warmed = list(dict.fromkeys([plain] + [c for _, c, _ in cases] + list(twins.values())))
    eng = serve.Engine(model, buckets=BUCKETS)
    t0 = time.perf_counter()
    warm = serve.warmup(eng, warmed)
    warm_s = time.perf_counter() - t0
    programs = eng.stats["programs"]
    check(programs == len(warmed) * len(BUCKETS), f"serve-cache warmed {programs}")

    rs = np.random.RandomState(SEED + 30)
    imgs = rs.uniform(-1, 1, (8, H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    mask[:, :W // 2] = 1.0                                   # the left half known
    seed = SEED + 31

    def submit(config, s=seed, n=8):
        if config.task == "inpaint":
            return eng.submit(config=config, seed=s, x_init=imgs[:n], mask=mask)
        return eng.submit(config=config, seed=s, n=n)

    def drain(config, s=seed, n=8):
        ticket = submit(config, s, n)
        report = eng.run()
        torch.cuda.synchronize()
        return ticket, report

    served, recs = {}, {}
    for label, config, per_layer in [("uncached", plain, {"flash_fwd": 1})] + list(cases):
        shapes: dict = {}
        orig = fa.flash_forward

        def recording(q, k, v, scale):
            shapes[q.shape[1]] = shapes.get(q.shape[1], 0) + 1
            return orig(q, k, v, scale)

        fa.flash_forward = recording
        try:
            walls, counts = [], []
            for batch in range(2):
                shapes.clear()
                before = torch.cuda.memory_allocated()
                _zero((fa.LAUNCHES, quant.LAUNCHES, step_cache.GATE_SYNCS))  # starts here
                ticket, report = drain(config, seed + batch)
                got = {k: fa.LAUNCHES[k] + quant.LAUNCHES[k] for k in QUANT_KERNELS}  # ends
                syncs = step_cache.GATE_SYNCS["adaptive_gate"]
                after = torch.cuda.memory_allocated()
                img = ticket.result(timeout=900)
                walls.append(report["wall_s"])
                tel = ticket.telemetry
                if config.cached:
                    spec, taken, blocks = _cache_plan(model, config,
                                                      tel["branch"] if tel else None)
                else:
                    spec, taken, blocks = None, None, model.depth * _forwards(
                        config, model.total_steps)
                want = {k: per_layer.get(k, 0) * blocks for k in QUANT_KERNELS}
                want_syncs = (sum(b != 0 for b in spec.branches)
                              if config.cache_mode == "adaptive" and config.cached else 0)
                counts.append((got, want, syncs, want_syncs, before, after, taken))
                if batch == 0:
                    served[label] = (config, img, tel)
                    by_tokens = {str(n): c for n, c in sorted(shapes.items())}
                check(img.shape == (8, H, W, 3) and bool(np.isfinite(img).all()),
                      f"serve-cache {label} output")
                check(bool(((img >= 0.0) & (img <= 1.0)).all()),
                      f"serve-cache {label} in [0, 1]")
                check(report["failed_tickets"] == 0 and report["programs"] == 0
                      and eng.stats["programs"] == programs, f"serve-cache {label} programs")
                check(got == want, f"serve-cache {label} batch {batch} launches {got}, "
                      f"expected {want}")
                check(syncs == want_syncs, f"serve-cache {label} gate syncs {syncs}, "
                      f"expected {want_syncs}")
                if batch == 1:
                    check(after == before, f"serve-cache {label}: memory_allocated "
                          f"{before} -> {after} over a second batch")
        finally:
            fa.flash_forward = orig
        device_kernels, idle, busy = _device_launches(torch, lambda: drain(config, seed + 2))
        got, want, syncs, want_syncs, before, after, taken = counts[0]
        rec = {"phase": "serve-cache", "model": MODEL, "dtype": "bfloat16", "config": label,
               "sampler_config": {k: v for k, v in vars(config).items()
                                  if v != getattr(serve.SamplerConfig, k)},
               "forwards": _forwards(config, model.total_steps),
               "wall_s": walls, "img_per_sec": 8 / walls[0],
               "launches": got, "expected_launches": want,
               "flash_fwd_by_tokens": by_tokens,
               "gate_syncs": syncs, "expected_gate_syncs": want_syncs,
               "memory_allocated_second_batch": [counts[1][4], counts[1][5]],
               "device_kernels": device_kernels, "idle_share": idle, "device_busy_s": busy,
               "wall_per_device_kernel_us": walls[0] / device_kernels * 1e6
               if device_kernels else None,
               "warmup_s": warm_s, "warmed_programs": warm["programs"]}
        if config.cached:
            rec["branches"] = "".join(str(b) for b in taken)
            rec["refreshes"] = sum(b == 0 for b in taken)
            rec["flops_saved_fraction"] = step_cache.flops_saved_fraction(spec)
            if served[label][2]:
                rec["telemetry"] = {k: v for k, v in served[label][2].items()
                                    if k not in ("branch", "drift")}
        recs[label] = rec
    # the speed-up: each cached config and its uncached twin drained in
    # turns (twin, cached, cached, twin), as the host's pace drifts
    for label, config, _ in cases:
        pair = {"cached": [], "uncached": []}
        for kind in ("uncached", "cached", "cached", "uncached"):
            pair[kind].append(drain(config if kind == "cached" else twins[label],
                                    seed + 3)[1]["wall_s"])
        recs[label].update({"paired_wall_s": pair["cached"],
                            "paired_uncached_wall_s": pair["uncached"],
                            "speedup_vs_uncached": statistics.mean(pair["uncached"])
                            / statistics.mean(pair["cached"])})

    token_label, token_cfg, _ = cases[3]
    _, taken, _ = _cache_plan(model, token_cfg)
    refresh = sum(b == 0 for b in taken)
    want_tok = {str(n_tokens): refresh * model.depth,
                str(token_cfg.cache_tokens): (len(taken) - refresh) * model.depth}
    check(recs[token_label]["flash_fwd_by_tokens"] == want_tok,
          f"serve-cache token flash_fwd by tokens "
          f"{recs[token_label]['flash_fwd_by_tokens']}, expected {want_tok}")

    # a 3-row adaptive request in bucket 4: padded with a replica of row 0
    adaptive = cases[2][1]
    _zero((fa.LAUNCHES, quant.LAUNCHES))
    ticket3, report3 = drain(adaptive, seed, 3)
    launches3 = fa.LAUNCHES["flash_fwd"]
    img3 = ticket3.result(timeout=900)
    del eng
    torch.cuda.empty_cache()

    # the direct calls, on models built apart from the engine
    def variant(q, fused):
        m = model.clone(quant=q, fused=fused)
        m.load_state_dict(quant.quantize_state_dict(model.state_dict()), strict=True)
        return m

    def cache_kw(config):
        return dict(cache_interval=config.cache_interval, cache_mode=config.cache_mode,
                    cache_threshold=config.cache_threshold,
                    cache_tokens=config.cache_tokens or None)

    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731

    def direct(config, **kw):
        kw = {**cache_kw(config), **kw}
        m = variant(config.quant, config.fused) if config.quant else model
        if config.task == "inpaint":
            return workloads.inpaint(m, gen(), imgs, mask, k=K, **kw)
        if config.sampler == "cold":
            return sampling.cold_sample(m, gen(), n=8, levels=config.levels, **kw)
        if config.steps:
            return sampling.ddim_sample_fewstep(m, gen(), steps=config.steps, n=8, **kw)
        return sampling.ddim_sample(m, gen(), n=8, k=K, **kw)

    out = {"phase": "serve-cache-direct"}
    check(np.array_equal(served["uncached"][1], direct(plain).cpu().numpy()),
          "serve-cache uncached differs from the direct call")
    for label, config, _ in cases:
        _, img, tel = served[label]
        if config.telemetry:
            want, want_tel = direct(config, telemetry=True)
            want = want.cpu().numpy()
            off = direct(config).cpu().numpy()
            out["telemetry off bitwise on"] = bool(np.array_equal(off, want))
            check(out["telemetry off bitwise on"], "serve-cache telemetry off vs on")
            check(list(want_tel.branch) == tel["branch"],
                  f"serve-cache {label}: served branches are not the direct call's")
        else:
            want = direct(config).cpu().numpy()
        base = (served["uncached"][1] if config.task == "sample" and not config.steps
                and config.sampler == "ddim" and not config.quant
                else direct(_uncached(config)).cpu().numpy())
        diff = np.abs(img - base)
        rec = recs[label]
        rec.update({"bitwise_direct": bool(np.array_equal(img, want)),
                    "max_abs_vs_uncached": float(diff.max()),
                    "mean_abs_vs_uncached": float(diff.mean())})
        check(rec["bitwise_direct"], f"serve-cache {label} differs from the direct call")
        emit(rec)
    emit(recs["uncached"])

    # the collapses, at the delta batch's seed and shape
    delta_cfg, full_base = cases[0][1], served["uncached"][1]
    collapses = {
        "adaptive tau=0 == uncached": (dict(cache_interval=2, cache_mode="adaptive",
                                            cache_threshold=0.0), full_base),
        f"token k={n_tokens} == uncached": (dict(cache_interval=2, cache_mode="token",
                                                 cache_tokens=n_tokens), full_base),
        "adaptive tau=inf == delta": (dict(cache_interval=2, cache_mode="adaptive",
                                           cache_threshold=float("inf")),
                                      served[cases[0][0]][1]),
        "cache_interval=1 == uncached": (dict(cache_interval=1), full_base),
    }
    for name, (kw, want) in collapses.items():
        got = sampling.ddim_sample(model, gen(), n=8, k=K, **kw).cpu().numpy()
        out[name] = bool(np.array_equal(got, want))
        check(out[name], f"serve-cache collapse {name}")
    check(delta_cfg.cache_mode == "delta", "serve-cache case 0 is delta")

    # the 3-row adaptive request against the direct call on the same padded
    # batch, and its gate against the unpadded call's
    kw = cache_kw(adaptive)
    x3 = sampling.fresh_start(model, gen(), 3, "cuda")
    padded = sampling.ddim_sample(model, x_init=torch.cat([x3, x3[:1]]), k=K,
                                  **kw)[:3].cpu().numpy()
    unpadded, unpadded_tel = sampling.ddim_sample(model, gen(), n=3, k=K,
                                                  telemetry=True, **kw)
    _, _, blocks = _cache_plan(model, adaptive, ticket3.telemetry["branch"])
    rec3 = out["adaptive 3 rows in bucket 4"] = {
        "padded_rows": report3["padded_rows"], "flash_fwd": launches3,
        "expected_flash_fwd": blocks,
        "bitwise_direct_on_padded_batch": bool(np.array_equal(img3, padded)),
        "branches_equal_unpadded": list(unpadded_tel.branch) == ticket3.telemetry["branch"],
        "max_abs_vs_unpadded": float(np.abs(img3 - unpadded.cpu().numpy()).max())}
    check(report3["padded_rows"] == 1 and launches3 == blocks,
          f"serve-cache adaptive 3 rows: {rec3}")
    check(rec3["bitwise_direct_on_padded_batch"], "serve-cache adaptive replica padding")
    check(rec3["branches_equal_unpadded"], "serve-cache adaptive padding moved the gate")
    emit(out)
    torch.cuda.empty_cache()
    return {label: rec["launches"] for label, rec in recs.items()}


#: the fid phase: the guards' samples (n_samples 32 in 8-row batches, so 4
#: sampler batches a stream), the extractor's card-vs-CPU tolerance (JAX's
#: own framework-parity tolerance, tests/test_inception_parity.py:232) and
#: its timed batch
FID_SAMPLES, FID_BATCH = 32, 8
FID_RTOL, FID_ATOL = 2e-3, 2e-4
EXTRACTOR_BATCH = 32
#: the distill phase: rounds 4 → 2 → 1 of DISTILL_ITERS updates at the
#: training batch, a live checkpoint every 2 updates; cold over 8 levels
#: (8 | 2·4); then DISTILL_REPS timed updates of the first round's step
DISTILL_ITERS, DISTILL_BATCH, DISTILL_LR, DISTILL_LEVELS = 4, 16, 1e-4, 8
DISTILL_WARM, DISTILL_REPS = 2, 10
#: the kernels whose launches the fid and distill phases count
PATH_KERNELS = QUANT_KERNELS + ("flash_bwd_dq", "flash_bwd_dkv")


def _counts(fa, quant) -> dict:
    return {k: fa.LAUNCHES[k] + quant.LAUNCHES[k] for k in PATH_KERNELS}


def phase_fid(torch, model, fa, quant, serve):
    """FID and the four quality guards on the card. The extractor (the
    seeded proxy, ``inception.init_variables(0)``) at 200 px against the
    same module's CPU float32 output on 2 images, element-wise within
    ``FID_ATOL + FID_RTOL·|cpu|`` (TF32 off); its device time for a batch
    of ``EXTRACTOR_BATCH`` and its peak memory. Then, at k=20 over
    ``FID_SAMPLES`` samples in ``FID_BATCH``-row batches:
    ``cached_sampler_guard`` at ``cache_interval=1`` (exactly 0.0 and max
    |Δ| 0: the two streams are one program), full i2, and the inpaint task
    at delta i2; ``quantized_sampler_guard`` with ``quant="pallas"``
    (dequant_mm) and with ``quant="w8a8"`` on ``model.clone(fused=True)``
    (fused_trunk, mlp_fused); ``superres_consistency_guard`` on a served
    superres batch after ``workloads.superres_project`` (bit-exact), and on
    the raw batch (reported). The launch counters are zeroed just before
    each guard and read just after: exactly blocks run × launches a block,
    from the branch tables. The distances are recorded with no limit: the
    JAX package sets none, and the proxy's absolute scale means nothing."""
    import numpy as np

    from ddim_cold_torch import workloads
    from ddim_cold_torch.eval import fid, inception

    t_phase = time.perf_counter()
    H, W = model.img_size
    rs = np.random.RandomState(SEED + 40)
    _, proxy = inception.init_variables(0)
    fn_cpu, _ = fid.make_feature_fn(variables=proxy, device="cpu")
    fn, dim = fid.make_feature_fn(variables=proxy)
    imgs = rs.rand(2, H, W, 3).astype(np.float32)
    want = fn_cpu(imgs).numpy()
    got = fn(imgs).cpu().numpy()
    err = np.abs(got - want)
    over = err / (FID_ATOL + FID_RTOL * np.abs(want))
    batch = torch.rand((EXTRACTOR_BATCH, H, W, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 41))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: fn(batch), reps=5, warm=2)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "fid", "what": "extractor", "input_px": H, "dim": dim,
          "max_abs_err_vs_cpu": float(err.max()), "max_err_over_tol": float(over.max()),
          "rtol": FID_RTOL, "atol": FID_ATOL, "feature_std": float(want.std()),
          "batch": EXTRACTOR_BATCH, "ms": ms, "img_per_sec": EXTRACTOR_BATCH / ms * 1e3,
          "peak_mem_gib": peak / 2**30, "peak_above_resident_gib": (peak - base) / 2**30})
    check(got.shape == (2, dim) and bool(np.isfinite(got).all()), "fid extractor output")
    check(float(over.max()) <= 1.0, f"fid extractor card vs CPU: {float(over.max())} "
          "of the tolerance")
    del fn_cpu, fn, batch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    common = dict(generator=gen, n_samples=FID_SAMPLES, sample_batch=FID_BATCH, k=K)
    n_batches = -(-FID_SAMPLES // FID_BATCH)
    plain = model.depth * _forwards(serve.SamplerConfig(k=K), model.total_steps)
    full = _cache_plan(model, serve.SamplerConfig(k=K, cache_interval=2,
                                                  cache_mode="full"))[2]
    delta = _cache_plan(model, serve.SamplerConfig(task="inpaint", k=K,
                                                   cache_interval=2))[2]
    fused = model.clone(fused=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    guards = (
        ("fid cached i1", "fid_exact_vs_cached",
         lambda: fid.cached_sampler_guard(model, cache_interval=1, **common),
         {"flash_fwd": 2 * plain}),
        ("fid cached full i2", "fid_exact_vs_cached",
         lambda: fid.cached_sampler_guard(model, cache_interval=2, cache_mode="full",
                                          **common),
         {"flash_fwd": plain + full}),
        ("fid inpaint delta i2", "fid_exact_vs_cached",
         lambda: fid.cached_sampler_guard(model, cache_interval=2, cache_mode="delta",
                                          task="inpaint", **common),
         {"flash_fwd": plain + delta}),
        ("fid quant pallas", "fid_exact_vs_quant",
         lambda: fid.quantized_sampler_guard(model, quant="pallas", **common),
         {"flash_fwd": 2 * plain, "dequant_mm": 4 * plain}),
        ("fid quant w8a8 fused", "fid_exact_vs_quant",
         lambda: fid.quantized_sampler_guard(fused, quant="w8a8", **common),
         {"flash_fwd": plain, "mlp_fused": 2 * plain, "fused_trunk": plain}),
    )
    launches, reports = {}, {}
    for label, key, run, per_batch in guards:
        _zero((fa.LAUNCHES, quant.LAUNCHES))          # this path starts here
        t0 = time.perf_counter()
        report = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(fa, quant)                      # ... and ends here
        want = {k: per_batch.get(k, 0) * n_batches for k in PATH_KERNELS}
        launches[label], reports[label] = got, report
        emit({"phase": "fid", "what": label, "model": MODEL, "dtype": "bfloat16",
              "report": report, "wall_s": wall, "launches": got,
              "expected_launches": want})
        check(math.isfinite(report[key]) and math.isfinite(report["max_abs_pixel_delta"]),
              f"{label}: distance {report[key]}")
        check(got == want, f"{label} launches {got}, expected {want}")
    i1 = reports["fid cached i1"]
    check(i1["fid_exact_vs_cached"] == 0.0 and i1["max_abs_pixel_delta"] == 0.0,
          f"fid cached i1 is not exactly 0: {i1}")
    del fused
    torch.cuda.empty_cache()

    # the superres guard on a served batch (3 levels: 25×25 → 200×200)
    low = rs.uniform(-1, 1, (8, H >> 3, W >> 3, 3)).astype(np.float32)
    config = serve.SamplerConfig(task="superres", sampler="cold", levels=3)
    eng = serve.Engine(model, buckets=(8,))
    serve.warmup(eng, [config])
    _zero((fa.LAUNCHES, quant.LAUNCHES))              # this path starts here
    ticket = eng.submit(x_init=workloads.superres_init(low, H), config=config)
    report = eng.run()
    torch.cuda.synchronize()
    got = _counts(fa, quant)                          # ... and ends here
    want = {k: (model.depth * 3 if k == "flash_fwd" else 0) for k in PATH_KERNELS}
    out = ticket.result(timeout=900)
    del eng
    projected = fid.superres_consistency_guard(workloads.superres_project(out, low), low)
    raw = fid.superres_consistency_guard(out, low)
    launches["fid superres served"] = got
    emit({"phase": "fid", "what": "superres served", "levels": 3, "rows": report["rows"],
          "projected": projected, "raw": raw, "launches": got, "expected_launches": want})
    check(projected["bit_exact"], f"superres guard on the projected batch: {projected}")
    check(got == want, f"fid superres served launches {got}, expected {want}")
    emit({"phase": "fid", "what": "phase", "seconds": time.perf_counter() - t_phase})
    return launches


def phase_distill(torch, model, fa, quant, serve):
    """Progressive distillation of the bf16 200_p4 model (its seeded
    weights; synthetic 4×4-tile batches of ``DISTILL_BATCH``; rounds 4 → 2
    → 1 of ``DISTILL_ITERS`` updates, ``save_every`` 2), ``ddim`` and
    ``cold``. The student's forward is the evaluation forward, so even at
    ``attn_drop_rate`` 0.1 it takes the flash route: every update launches
    depth × 3 flash_fwd (the teacher's two sub-steps and the student) and
    depth × one of each backward kernel, counted over the whole run and
    over ``DISTILL_REPS`` timed updates of the first round's step (ms/step,
    peak memory). Every logged loss finite. For ``ddim``: a run stopped in
    round k=2 after its live save restarts, restores the finished k=4
    student and resumes at iteration 2 (the result against the
    uninterrupted run's, reported); ``distilled_sampler_guard`` of the k=1
    student against the teacher at k=20; the k=1 student served through
    ``Engine(student_params=...)`` with ``SamplerConfig(steps=1,
    student=True)``, bit for bit the direct ``ddim_sample_fewstep`` of the
    same seed and batch."""
    import dataclasses
    import tempfile

    import numpy as np

    from ddim_cold_torch.eval import fid
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.train import distill

    t_phase = time.perf_counter()
    H, W = model.img_size
    per_step = {"flash_fwd": 3 * model.depth, "flash_bwd_dq": model.depth,
                "flash_bwd_dkv": model.depth}
    expect = lambda n: {k: per_step.get(k, 0) * n for k in PATH_KERNELS}  # noqa: E731
    launches, students = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("ddim", "cold"):
            cfg = distill.DistillConfig(
                start_steps=4, target_steps=1, iters=DISTILL_ITERS,
                batch_size=DISTILL_BATCH, lr=DISTILL_LR, variant=variant,
                cold_levels=DISTILL_LEVELS, log_every=1, save_every=2,
                checkpoint_dir=os.path.join(tmp, variant), seed=SEED)
            n_updates = len(cfg.round_steps()) * cfg.iters
            _zero((fa.LAUNCHES, quant.LAUNCHES))      # this path starts here
            t0 = time.perf_counter()
            out = distill.distill(model, cfg, log=os.path.join(tmp, f"{variant}.log"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _counts(fa, quant)                  # ... and ends here
            launches[f"distill {variant}"] = got
            history = {str(k): v for k, v in out["history"].items()}
            finite = all(len(v) == cfg.iters and all(map(math.isfinite, v))
                         for v in out["history"].values())

            # the first round's step, timed
            state = distill.make_student_state(model, cfg.lr, DISTILL_WARM + DISTILL_REPS)
            step = distill.make_distill_step(model, steps=4, variant=variant,
                                             cold_levels=DISTILL_LEVELS)
            g = torch.Generator(device="cuda").manual_seed(SEED + 50)
            x0 = distill.synthetic_batch(g, DISTILL_BATCH, (H, W), 3)
            rec = torch.zeros((), device="cuda")
            for _ in range(DISTILL_WARM):
                state, loss, rec = step(state, model, x0, g, rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero((fa.LAUNCHES, quant.LAUNCHES))      # this path starts here
            t0 = time.perf_counter()
            for _ in range(DISTILL_REPS):
                state, loss, rec = step(state, model, x0, g, rec)
            torch.cuda.synchronize()
            step_wall = time.perf_counter() - t0
            step_got = _counts(fa, quant)             # ... and ends here
            peak = torch.cuda.max_memory_allocated()
            emit({"phase": "distill", "variant": variant, "model": MODEL,
                  "dtype": "bfloat16", "attn_drop_rate": model.attn_drop_rate,
                  "batch": DISTILL_BATCH, "rounds": cfg.round_steps(), "iters": cfg.iters,
                  "cold_levels": DISTILL_LEVELS if variant == "cold" else None,
                  "wall_s": wall, "updates": n_updates, "history": history,
                  "launches": got, "expected_launches": expect(n_updates),
                  "timed_updates": DISTILL_REPS, "ms_per_step": step_wall / DISTILL_REPS * 1e3,
                  "peak_mem_gib": peak / 2**30, "timed_launches": step_got,
                  "expected_timed_launches": expect(DISTILL_REPS),
                  "timed_final_loss": loss.item()})
            check(finite, f"distill {variant}: losses {history}")
            check(math.isfinite(loss.item()), f"distill {variant} timed loss {loss.item()}")
            check(got == expect(n_updates),
                  f"distill {variant} launches {got}, expected {expect(n_updates)}")
            check(step_got == expect(DISTILL_REPS),
                  f"distill {variant} timed launches {step_got}")
            del state, step
            if variant == "ddim":
                students, ddim_cfg = out["students"], cfg
            torch.cuda.empty_cache()

        # a restart: stopped in round k=2 after its live save at iteration 2
        class Stopped(Exception):
            pass

        calls = []

        def stopping(generator):
            calls.append(1)
            if len(calls) == ddim_cfg.iters + 3:
                raise Stopped
            return distill.synthetic_batch(generator, DISTILL_BATCH, (H, W), 3)

        cfg = dataclasses.replace(ddim_cfg, checkpoint_dir=os.path.join(tmp, "restart"))
        try:
            distill.distill(model, cfg, batches=stopping)
            stopped = False
        except Stopped:
            stopped = True
        log = os.path.join(tmp, "restart.log")
        again = distill.distill(model, cfg, log=log)
        with open(log) as f:
            text = f.read()
        diffs = {str(n): max(float((again["students"][n][k].float() - v.float()).abs().max())
                             for k, v in sd.items()) for n, sd in students.items()}
        rec = {"phase": "distill", "what": "restart", "stopped": stopped,
               "restored_k4": "(k=4): restored finished student" in text,
               "resumed_k2_at_2": "(k=2): resumed at iter 2" in text,
               "history_lengths": {str(k): len(v) for k, v in again["history"].items()},
               "max_abs_vs_uninterrupted": diffs,
               "bitwise_uninterrupted": all(d == 0.0 for d in diffs.values())}
        emit(rec)
        check(stopped and rec["restored_k4"] and rec["resumed_k2_at_2"]
              and rec["history_lengths"] == {"4": 0, "2": DISTILL_ITERS - 2,
                                             "1": DISTILL_ITERS},
              f"distill restart: {rec}")

    # the k=1 student: its guard against the teacher, and served
    student = model.clone()
    student.load_state_dict(students[1], strict=True)
    _zero((fa.LAUNCHES, quant.LAUNCHES))              # this path starts here
    t0 = time.perf_counter()
    report = fid.distilled_sampler_guard(
        model, student, generator=torch.Generator(device="cuda").manual_seed(SEED + 51),
        steps=1, n_samples=FID_SAMPLES, sample_batch=FID_BATCH, k=K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(fa, quant)                          # ... and ends here
    n_batches = -(-FID_SAMPLES // FID_BATCH)
    want = {k: (model.depth * (_forwards(serve.SamplerConfig(k=K), model.total_steps) + 1)
                * n_batches if k == "flash_fwd" else 0) for k in PATH_KERNELS}
    launches["fid distilled k1"] = got
    emit({"phase": "distill", "what": "fid distilled k1", "report": report,
          "wall_s": wall, "launches": got, "expected_launches": want})
    check(math.isfinite(report["fid_teacher_vs_student"]),
          f"distilled guard {report['fid_teacher_vs_student']}")
    check(got == want, f"fid distilled k1 launches {got}, expected {want}")

    config = serve.SamplerConfig(steps=1, student=True)
    eng = serve.Engine(model, buckets=(8,), student_params=students[1])
    serve.warmup(eng, [config])
    seed = SEED + 52
    _zero((fa.LAUNCHES, quant.LAUNCHES))              # this path starts here
    ticket = eng.submit(seed=seed, n=8, config=config)
    served = eng.run()
    torch.cuda.synchronize()
    got = _counts(fa, quant)                          # ... and ends here
    img = ticket.result(timeout=900)
    del eng
    direct = sampling.ddim_sample_fewstep(
        student, torch.Generator(device="cuda").manual_seed(seed), steps=1, n=8)
    direct = direct.cpu().numpy()
    want = {k: (model.depth if k == "flash_fwd" else 0) for k in PATH_KERNELS}
    launches["serve student k1"] = got
    rec = {"phase": "distill", "what": "serve student k1", "rows": served["rows"],
           "wall_s": served["wall_s"], "img_per_sec": served["img_per_sec"],
           "bitwise_direct": bool(np.array_equal(img, direct)),
           "max_abs_vs_direct": float(np.abs(img - direct).max()),
           "launches": got, "expected_launches": want}
    emit(rec)
    check(img.shape == (8, H, W, 3) and bool(np.isfinite(img).all()),
          "served k=1 student output")
    check(rec["bitwise_direct"], "served k=1 student differs from the direct call")
    check(got == want, f"serve student k1 launches {got}, expected {want}")
    del student
    torch.cuda.empty_cache()
    emit({"phase": "distill", "what": "phase", "seconds": time.perf_counter() - t_phase})
    return launches


def _kind_of(name: str, kinds) -> str:
    name = name.lower()
    hit = next((k for k in kinds if k in name), None)
    if hit is not None:
        return hit
    return "gemm" if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")) else "other"


def phase_profile_quant(torch, eng, config, per_layer, model):
    """One more batch of a quantized config under torch.profiler: device
    time by kernel and the device's idle share; each of the config's
    kernels (``per_layer``: launches a layer-forward) launched exactly
    depth × steps times that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ticket = eng.submit(seed=SEED + 8, n=8, config=config)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticket.result(timeout=900)
    kinds = {k: [] for k in QUANT_KERNELS + ("gemm", "other")}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kinds[_kind_of(e.name, QUANT_KERNELS)].append(
                (e.time_range.start, e.time_range.end))
    spans = [iv for ivs in kinds.values() for iv in ivs]
    window_us = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)) if spans else 0.0
    busy_us = _union_us(spans)
    rec = {"phase": "profile-quant", "config": f"quant={config.quant},fused={config.fused}",
           "rows": report["rows"], "wall_s": wall, "device_window_s": window_us / 1e6,
           "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / window_us if window_us else None}
    for kind, ivs in kinds.items():
        rec[f"{kind}_s"] = sum(hi - lo for lo, hi in ivs) / 1e6
        rec[f"{kind}_launches"] = len(ivs)
    emit(rec)
    steps = len(range(model.total_steps - 1, 0, -K))
    for name, n in per_layer.items():
        check(rec[f"{name}_launches"] == n * model.depth * steps,
              f"profiled {rec['config']}: {name} launches {rec[f'{name}_launches']}")


def main() -> int:
    import torch

    from ddim_cold_torch import serve
    from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT
    from ddim_cold_torch.ops import _build
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.ops import quant

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
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, at once
        libs = dict(zip(SOURCES, pool.map(_build.load_library, SOURCES)))
    emit({"phase": "build", "libraries": [lib._name for lib in libs.values()],
          "seconds": time.perf_counter() - t0})
    phase_sass(libs, _build._nvcc())

    records = phase_kernels(torch, fa)
    bwd = phase_kernels_bwd(torch, fa)
    phase_bwd_large_logits(torch, fa)
    qk = phase_kernels_quant(torch, fa, quant)
    model = phase_forward(torch, DiffusionViT, MODEL_CONFIGS)
    eng, config, serve_launches = phase_serve(torch, model, fa, serve)
    phase_profile(torch, eng, config)
    del eng
    phase_quant_forward(torch, DiffusionViT, MODEL_CONFIGS, quant)
    eng, qconfigs, quant_launches = phase_serve_quant(torch, model, fa, quant, serve)
    for config, (_, per_layer) in list(zip(qconfigs, SERVE_QUANT))[:2]:  # pallas, fused w8a16
        phase_profile_quant(torch, eng, config, per_layer, model)
    del eng
    edit_launches = phase_serve_edit(torch, model, fa, quant, serve, DiffusionViT,
                                     MODEL_CONFIGS)
    cache_launches = phase_serve_cache(torch, model, fa, quant, serve)
    new_paths = {**phase_fid(torch, model, fa, quant, serve),
                 **phase_distill(torch, model, fa, quant, serve)}
    del model
    torch.cuda.empty_cache()
    phase_train_check(torch, fa)
    train_model, state, step, batch, gen, train_launches = phase_train(torch, fa)
    phase_train_profile(torch, train_model, state, step, batch, gen)

    fwd = records[("200_p4_b16", "bfloat16")]
    lines = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ddim_cold_torch/csrc/flash_fwd.cu",
        "replaces": "ddim_cold_tpu/ops/flash_attention.py:79",
        "launches": train_launches["flash_fwd"],
        "launches_by_path": {"train": train_launches["flash_fwd"],
                             "serve": serve_launches,
                             **{f"serve quant={q},fused={f}": n["flash_fwd"]
                                for (q, f), n in quant_launches.items()},
                             **{f"serve-edit {label}": n["flash_fwd"]
                                for label, n in edit_launches.items() if n["flash_fwd"]},
                             **{f"serve-cache {label}": n["flash_fwd"]
                                for label, n in cache_launches.items() if n["flash_fwd"]},
                             **{label: n["flash_fwd"]
                                for label, n in new_paths.items() if n["flash_fwd"]}},
        "max_abs_err": fwd["max_abs_err_o"], "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
        "design": "wgmma",
        "measured_at": "200_p4 B=16 bfloat16"}]
    for name, line in (("flash_bwd_dq", 246), ("flash_bwd_dkv", 284)):
        rec = bwd[("200_p4", "bfloat16", name)]
        lines.append({
            "name": name, "route": "cuda",
            "source": "ddim_cold_torch/csrc/flash_bwd.cu",
            "replaces": f"ddim_cold_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"train": train_launches[name],
                                 **{label: n[name] for label, n in new_paths.items()
                                    if n[name]}},
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            # one SDPA backward computes dq, dk and dv together
            "library_ms": rec["library_ms"], "library_covers": "dq+dk+dv",
            "design": "wgmma"})
    for name, line, key in (
            ("fused_trunk", "ddim_cold_tpu/ops/flash_attention.py:495",
             ("fused_trunk", "200_p4", "bfloat16", "pallas")),
            ("dequant_mm", "ddim_cold_tpu/ops/quant.py:275",
             ("dequant_mm", "200_p4", "bfloat16", "pallas")),
            ("mlp_fused", "ddim_cold_tpu/ops/quant.py:419",
             ("mlp_fused", "200_p4", "bfloat16", "pallas"))):
        rec = qk[key]
        by_path = {f"serve quant={q},fused={f}": n[name]
                   for (q, f), n in quant_launches.items()}
        by_path.update({f"serve-edit {label}": n[name]
                        for label, n in edit_launches.items() if n[name]})
        by_path.update({f"serve-cache {label}": n[name]
                        for label, n in cache_launches.items() if n[name]})
        by_path.update({label: n[name] for label, n in new_paths.items() if n[name]})
        lines.append({
            "name": name, "route": "cuda", "source": f"ddim_cold_torch/csrc/{name}.cu",
            "replaces": line, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_covers": rec["library_covers"],
            "measured_at": "200_p4 B=8 bfloat16 w8a16",
            "design": "wgmma"})
    emit({"kernels": lines})
    if FAILURES:
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
