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
2b. sass   — ``cuobjdump -sass`` of the ``flash_fwd``, ``flash_bwd`` and
   ``fused_trunk`` libraries: every bfloat16 kernel function runs its
   products on the tensor cores (HGMMA; the w8a8 one also the int8 IGMMA)
   and spills nothing, no float32 one does; registers, stack and spills
   from ``cuobjdump -res-usage``;
3. kernel  — the flash forward kernel against its plain PyTorch version at
   the main paths' shapes (and the 200px/p8 head dim), in bfloat16 and
   float32, with CUDA-event median times of the kernel, the plain version
   and the one PyTorch call that computes the same function (timed only,
   never used by the port), beside the card's least possible time for the
   same work;
4. kernel  — the two flash backward kernels (``flash_bwd_dq``,
   ``flash_bwd_dkv``) likewise, dq/dk/dv held element-wise to
   ``flash_attention.grad_error_limit``; the library time is one
   ``autograd.grad`` through ``F.scaled_dot_product_attention``; then the
   bfloat16 pair at large logits (inputs ×8): finite, dv within the limit,
   dq and dk within it plus ``flash_attention.ds_flip_bound`` (what flipped
   bf16 roundings of dS can move them), and a 2% fault in either caught;
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
   (and the float Mlp): element-wise within ``quant.mm_error_limit`` /
   ``quant.trunk_error_limit``, a 2% fault caught, CUDA-event medians of
   kernel, plain version and library yardstick, and the bound;
12. quant-forward — the full-width model in float32 and bfloat16: each
   quantized or fused forward against the float one, and fused against
   unfused w8a16, within the stated tolerances;
13. serve-quant — one warmed engine over the bf16 model serves one 8-row
   request under each of ``quant="pallas"``, ``quant="pallas", fused=True``,
   ``quant="w8a8", fused=True`` and ``fused=True``; the launch counters are
   zeroed just before each drain and must read exactly depth × steps per
   kernel of the config (dequant_mm 4× that); then one more fused w8a16
   batch under ``torch.profiler``;
14. the ``kernels`` summary line (all six kernels, each with its design:
   "wgmma" on the tensor cores or "fma" on the CUDA cores), then the card's
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
#: flash_bwd: dq and dk/dv of each; fused_trunk: w8a16 and w8a8 of each)
WGMMA_LIBS = {"flash_fwd": (2, 2), "flash_bwd": (4, 4), "fused_trunk": (4, 4)}


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
    """The bfloat16 kernels of flash_fwd, flash_bwd and fused_trunk run
    their products through wgmma (HGMMA in the SASS, and the int8 IGMMA in
    w8a8) and spill no register to local memory; the float32 ones, the
    exact oracle route, hold no wgmma. Kernel functions are told apart by
    name: the bfloat16 ones carry ``bf16``, the w8a8 one ``w8a8``."""
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
                check(c["hgmma"] > 0, f"sass {name}: no HGMMA in {fn}")
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
    limit, and whether a 2% fault fails the gate (checked)."""
    B, N, H, D = 2, 2501, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = (torch.randn((B, N, 3, H, D), generator=gen, device="cuda") * 8.0).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    scale = D**-0.5
    o, lse = fa.flash_forward_reference(q, k, v, scale)
    do = torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
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
        rec[g] = {"err_over_limit": (err / limit).max().item(),
                  "err_over_gate": (err / gate).max().item(),
                  "past_limit": int((err > limit).sum().item()),
                  "finite": bool(torch.isfinite(grad[:, :, i].float()).all()),
                  "fault_past_gate": int((fault > gate).sum().item())}
        check(rec[g]["finite"], f"large-logit {g} finite")
        check(rec[g]["err_over_gate"] <= 1.0,
              f"large-logit {g} {rec[g]['err_over_gate']} over its gate")
        check(rec[g]["fault_past_gate"] > 0, f"large-logit {g}: a 2% fault passes the gate")
    emit(rec)
    check(rec["max_abs_lse"] > 100.0, f"large-logit lse {rec['max_abs_lse']}")
    del qkv, q, k, v, o, lse, do, grad, ref, flips
    torch.cuda.empty_cache()


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

            # dequant_mm: the qkv projection of the unfused w8a16 path
            codes, scale = w["qkv"]
            run = lambda: quant.dequant_mm(x2, codes, scale, b["qkv"], dtype)
            y = run()
            torch.cuda.synchronize()
            ref = quant.dequant_mm_reference(x2, codes, scale, b["qkv"]).to(dtype)
            rec = {"phase": "kernel", "kernel": "dequant_mm", "geometry": geom,
                   "M": M, "K": C, "N": 3 * C, "dtype": name, "out_dtype": name,
                   **_held(torch, y, ref, quant.mm_error_limit(x2, codes, scale, ref)),
                   "ms": time_ms(torch, run),
                   "plain_ms": time_ms(torch, lambda: quant.dequant_mm_reference(
                       x2, codes, scale, b["qkv"]), reps=10),
                   "library_ms": time_ms(torch, lambda: F.linear(
                       x2, deq["qkv"], b["qkv"].to(dtype))),
                   "library_covers": "F.linear on the weight dequantized beforehand"}
            rec["bound_ms"], rec["bound_by"] = _bound(
                {name: 2.0 * M * 3 * C * C}, M * C * elem + 3 * C * C + M * 3 * C * elem)
            emit(rec)
            _check_held(rec, f"dequant_mm {geom} {name}")
            records[("dequant_mm", geom, name, "pallas")] = rec

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


def _kind_of(name: str, kinds) -> str:
    name = name.lower()
    hit = next((k for k in kinds if k in name), None)
    if hit is not None:
        return hit
    return "gemm" if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")) else "other"


def phase_profile_quant(torch, eng, config, model):
    """One more fused w8a16 batch under torch.profiler: device time by
    kernel and the device's idle share."""
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
    check(rec["fused_trunk_launches"] == model.depth * steps,
          f"profiled fused_trunk launches {rec['fused_trunk_launches']}")


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
    phase_profile_quant(torch, eng, qconfigs[1], model)
    del eng, model
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
                                for (q, f), n in quant_launches.items()}},
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
            "launches": train_launches[name], "max_abs_err": rec["max_abs_err"],
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
        lines.append({
            "name": name, "route": "cuda", "source": f"ddim_cold_torch/csrc/{name}.cu",
            "replaces": line, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_covers": rec["library_covers"],
            "measured_at": "200_p4 B=8 bfloat16 w8a16",
            "design": "wgmma" if name == "fused_trunk" else "fma"})
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
