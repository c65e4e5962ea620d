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
7. profile — one more drain (a single 8-row batch) traced by
   ``utils/profiling.trace``: device time by kernel kind and the device's
   idle share; then the trace read back by ``obs/attrib`` (an ``attrib``
   line: per scope self and inclusive time, events, share of busy,
   achieved TFLOP/s, MFU against the card's peak from ``utils/flops``,
   roofline class; coverage, busy fraction, the top fusion candidates) and
   held: ``flash_attention/fwd`` holds exactly the batch's flash_fwd
   launches and their device time (5% slack), the busy fraction is the
   phase's own 1 − idle share within 0.005, no MFU above 1 nor rate above
   the peak, coverage at least ``attrib.COVERAGE_FLOOR``;
7b. serve-chaos — the engine's robustness layer on the serve engine (its
   defaults: 2 batches assembled ahead on a side stream, 2 in flight, the
   stall watchdog at 900 s): ten requests (41 rows) disarmed, every row bit
   for bit the direct ``ddim_sample`` on its bucket batch and depth × steps
   flash_fwd launches per batch; the same requests under chaos (transient
   dispatch faults, a permanent one on one request, one assembly and one
   fetch fault): every ticket resolves, the poisoned request quarantined,
   the survivors bitwise at their dispatch shape, retries equal to the
   transient fires, launches exact; a fetch hung 3 s under a 1 s stall
   budget fails the open tickets while the process lives and a new engine
   serves; ``QueueFullError``, ``DeadlineExceeded``, ``EngineClosedError``;
   then, the phase returned, device memory is back where it stood before
   it and a garbage collection frees none (no failed ticket pins its batch
   in a reference cycle, no watchdog thread its engine);
7c. serve-fleet — the fleet over the same bf16 model, one bucket (8,),
   k=20: (a) a ``Router`` over two in-process replicas (tenants web 2,
   batch 1, ``max_pending`` 24) answers eight requests of 31 rows, every
   row bit for bit the direct ``ddim_sample`` over an 8-row batch holding
   its start, flash_fwd launches 600 × the batches both engines
   dispatched, no program after warmup; then 12 one-row ``batch``
   requests in a tight loop admit at most its share of 8, the rest
   ``QueueFullError``, a ``web`` request still admitted; then eight more
   under the fleet chaos schedule (r0's dispatch dead, assembly
   transients, placement transients on r1): every ticket resolves, each
   failure a ``ServeError`` naming its replica, the survivors bitwise, r0
   retired and replaced, no program after warmup on any of the three; (b)
   a ``Router`` over two subprocess replicas
   (``python -m ddim_cold_torch.serve.replica_main`` on the card, the
   same seeded weights), r0 SIGKILLed at its second work request: the
   crash detected, its tickets failed over, every row bitwise the
   parent's direct call, a third replica spawned and warmed, no program
   after warmup; spawn and crash-detection seconds, img/s and p50
   reported; every child gone when the phase returns, and the parent's
   device memory back where it stood;
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
10. train-profile — three more training steps traced by
   ``utils/profiling.start_trace``/``stop_trace``: device time of the three
   kernels and of the rest, and the idle share; attributed and held as in
   7 (the three flash scopes), coverage reported only (autograd's
   LayerNorm and GEMM backward kernels run under no scope);
10a. train-dispatch, train-blocks — the bf16 flash model of 9 (attention
   dropout 0) built from an ``ExperimentConfig``, four B=16 steps from one
   seeded state as four single calls, as two calls of
   ``steps_per_dispatch=2`` and as four single calls with ``flash_blocks:
   [512, 1024]``: both bit for bit the single calls (parameters, moments,
   losses, EMA loss), each flash kernel launched exactly depth × 4 in each
   way (counters zeroed before each way); ms/step reported, no speed
   claimed;
10b. train-nan — two B=16 steps with and without
   ``profiling.enable_nan_checks``: losses bit for bit equal, ms/step of
   each; then a NaN weight raises ``FloatingPointError`` naming the
   module;
10c. native — the native C++ decode tier: the build tools (``g++``,
   ``jpeglib.h``, ``png.h``, libjpeg, libpng), the build (with every tool
   present it must load; without, the compiler's error is printed and the
   trainer reads through PIL, as the line says); a synthetic folder of 128
   train and 32 val images of sizes around 500×500 (PNG written with zlib
   and struct, every other one JPEG where PIL is importable); one epoch of
   the loader at 200 px with 8 threads per tier and route, in images per
   second beside the dense trainer's consumption, and on the native tier
   every batch from the fast path with no PIL decode;
10d. train-remat — the bf16 200_p4 model at B=16, dropout and drop path
   0.1, remat off and on from the same seed, batches and generator seed, on
   the flash route (attention dropout 0; 3 + 10 steps) and the dense route
   (0.1; 1 + 3): losses, parameters and the generator state bit for bit
   equal, launches exact (remat: flash_fwd 2 × 6 a step, each backward
   kernel 6; dense: none), ms/step and peak memory of each;
10e. train-run — ``python -m ddim_cold_torch train <exp>`` as a child
   process on the 200px YAML's keys (the synthetic folder, 3 epochs,
   ``remat: True``): run 1 SIGKILLed by a ``ckpt.save:kill`` fault at the
   post-write window of the second epoch's first save (lastepoch.ckpt, or
   bestloss.ckpt when the val loss improved; every checkpoint left loads,
   lastepoch.ckpt holds epoch 0, the warm-start pkl loads); run 2 resumes
   from it through a ``python -c`` wrapper of the same ``main`` (the resume
   lines, epochs 1 and 2, 24 steps, no temp file left beside a file it
   saved; training launches no flash kernel, the dense rule, and the
   deterministic evaluation forwards launch only flash_fwd, depth × val
   batches an epoch), with each child's wall, run 2's peak memory and
   seconds per epoch;
10e2. cli — the commands users start: ``python -m ddim_cold_torch sample
   --config oxford_flower_200_p4 --init-random --sample_n 8 --acc_k 20`` as
   a child process in a temporary directory (every tile of
   ``samples.png`` bit for bit ``to_uint8`` of the parent's direct
   ``ddim_sample`` from the same seed; float32 dense, no flash launch; its
   img/s), then in process ``edit`` (a 200 px draft, two interpolation
   ends, 4 cold samples: four PNGs, 7 cold levels, the draft tile exact),
   ``fid`` cold and ddim k=20 (32 samples in batches of 8), ``fid-trend``
   and ``publish`` on 10e's finished run directory (bf16, flash): flash_fwd
   launched exactly depth × forwards × batches (168, 2,400, 168, 84), JAX's
   JSON keys, finite values; ``attrib-report`` on 7's serve capture, its
   scope rows those of 7's attrib line; ``obs-report --from-jsonl`` on the
   span dump of one traced batch;
10f. probe-xla — the attention probe of the bf16 flash model against the
   dense model's at layers 0 (bit for bit), 2 and −1 (row total variation
   within ``PROBE_TV``, while layer 1's probe and another input's land
   above it), rows summing to 1; the ``use_flash="xla"`` route at
   B=8 against the flash model within ``FWD_TOL``, launching nothing, its
   time beside the flash forward's (10c–10f run after train-nan);
10g. dist-probe — which collectives gloo carries on CUDA tensors (two ranks
   on the one card, probed first in 10h's world; point to point in a world
   of its own, since a rank it kills must not take the other phases with
   it), and NCCL at world 1 in this process: the ones ``parallel/`` runs
   must all hold;
10h. dist-train, dist-sample — one world of two gloo ranks on the one card
   (NCCL refuses two ranks on one device), CUDA tensors, on ``{data: 2}``,
   Ulysses ``{seq: 2}``, ring ``{seq: 2}``, tensor-parallel ``{model: 2}``,
   pipelined ``{pipe: 2}`` (4 microbatches) and expert-parallel ``{expert:
   2}`` (the moe phase's Switch-MoE model, 2 experts a bank a rank, stepping
   with its aux weight; ``DIST_MOE``) and ``{data: 2}`` at
   ``steps_per_dispatch=2`` (``DIST_DISPATCH``: each rank its rows of both
   inner steps, 1 + 3 calls of two steps, 36 launches each): the bf16 200_p4 model,
   every drop rate 0, 1 + 3 steps at B=16, built as the trainer builds it,
   each step held to the one-process step on the same batches within
   ``DIST_TRAIN_TOL``, the flash kernels launched exactly a rank (18 each,
   the tp rank on its 2 heads; 36 each on the pipe, 3 blocks × 4
   microbatches × 3 steps; none on the ring), the pipe layout's gathered
   checkpoint read back into a one-process model within the update limit
   of the twin's, a traced step of each sequence-parallel layout attributed
   to its ``sp/`` scopes, ms/step, peak memory and parameter and moment
   elements a rank reported; then ``ddim_sample(mesh=)`` of the float32
   model at k=20 over 8 rows on the data and seq layouts within
   ``DIST_SAMPLE_TOL`` of the one-process sampler, flash_fwd 600 a rank
   (none on the ring); then
   dist-serve in the same world: the serving engine across the two ranks
   (``Engine(mesh={data: 2})``), every rank warming the eleven configs of
   ``DIST_SERVE`` (float, ``quant="pallas"``, pallas fused, w8a8 and w8a8
   fused on the data mesh at k=20; Ulysses, the ring, Ulysses with the full step cache,
   Ulysses pallas fused, and the token cache under Ulysses and the ring
   (626 live tokens) at ``sp_degree=2``, k=100), rank 0 serving one
   8-row batch (3 + 5 rows) of each while rank 1 follows: the rows within
   ``DIST_SERVE_TOL`` of the one-process twin's at the same bucket and
   start, zero programs after warmup on both ranks, each rank's launches
   exact (the Ulysses token config's flash shapes too), rank 1's
   ``follow()`` report rank 0's batches; wall, img/s and p50 reported (two
   ranks share one card: no speed claimed); then dist-probe-sp: the f32
   probe at B=2 on Ulysses ``{seq: 2}``, layers 0 and −1, the whole
   weights on each rank within ``PROBE_SP_TOL`` of the one-process probe,
   a control layer above it, exact launches; then dist-fleet, last: a
   ``Router`` on rank 0 over two replicas of ``local_factory(mesh={data:
   2})`` while rank 1 runs ``follow_replicas``, ``DIST_FLEET``'s three
   configs, an sp ticket hedged off r0 by a transient fault, r0 retired and
   replaced on both ranks, every row within ``DIST_SERVE_TOL`` of the
   one-process call at its dispatch shape, each rank's launches exact, zero
   programs after warmup, no group or thread left; wall, img/s and p50;
10h'. dist-train-4 — a world of four gloo ranks on the card: ``{pipe: 2,
   model: 2}`` (4 microbatches), Ulysses ``{seq: 2, model: 2}`` and
   Ulysses ``{seq: 2, expert: 2}`` (the Switch-MoE model), 1 + 2 steps each
   under dist-train's limits, every rank's launches exact (24, 12 and 12 of
   each flash kernel);
10i. dist-cli — ``python -m ddim_cold_torch train`` as three children at
   once on 10c's folder: a ``{data: 1, seq: 1}`` Ulysses mesh (an NCCL
   world of one: its log line, the epoch, loadable checkpoints, exact
   launches), ``num_gpus: 2`` (JAX's clamp line) and ``mesh: {data: 2}``
   (JAX's error);
11. kernel — the quantized trunk's kernels (``dequant_mm``, ``mlp_fused``,
   ``fused_trunk``) against their plain versions at the 200px/p4 serve
   shape (B=8) and at 200px/p8, in float32 and bfloat16, w8a16 and w8a8
   (and the float Mlp; dequant_mm at the qkv shape N = 3C and at N = C,
   the shape of proj, fc1 and fc2): element-wise within
   ``quant.mm_error_limit`` /
   ``quant.trunk_error_limit``, a 2% fault caught, CUDA-event medians of
   kernel, plain version and library yardstick, and the bound;
11b. tuning — ``ops/tuning.py``'s sweeps at 200_p4 B=8 in bfloat16 w8a8:
   every ``fused_trunk`` ``block_q`` (64–512) and ``mlp_fused``
   ``block_m`` (32–256) launched, timed with CUDA events and held to its
   plain version at the same block; each candidate's ms, max |Δ| and shared
   bytes; the static pick in the space and equal to the model's default
   (512, 256), the default's ms beside 11's w8a16 and w8a8 times; the table
   stays empty;
12. quant-forward — the full-width model in float32 and bfloat16: each
   quantized or fused forward against the float one, and fused against
   unfused w8a16, within the stated tolerances;
13. serve-quant — one warmed engine over the bf16 model serves one 8-row
   request under each of ``quant="pallas"``, ``quant="pallas", fused=True``,
   ``quant="w8a8", fused=True`` and ``fused=True``; the launch counters are
   zeroed just before each drain and must read exactly depth × steps per
   kernel of the config (dequant_mm 4× that); then one more batch of each
   config traced, with its launch counts checked, attributed and held as
   in 7 (each kernel's scope; in w8a8 the int8 shares of the scopes' work
   set their peaks);
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
17b. moe — the Switch-MoE model family (``models/moe.py``) at full width,
   200_p4 with 4 experts and capacity factor 1.25 (782 slots an expert),
   both dispatches: the float32 forward at B=8 against the port's CPU
   forward on the same weights (routing equal, |Δ| within ``MOE_FWD_TOL``),
   einsum against index, each block's dropped-token share; an engine over
   the bf16 model serving 8 one-row requests at k=20 in one batch
   (flash_fwd 600, every row bit for bit its direct ``ddim_sample``, no
   program after warmup, img/s and p50 beside the serve phase's); 2 + 5
   bf16 training steps at B=16 per dispatch with ``moe_aux_weight`` 0.01
   (loss and aux finite, 30 launches of each flash kernel, ms/step and peak
   memory);
18. the ``kernels`` summary line (all six kernels, each with its design:
   "wgmma", the bfloat16 route on the tensor cores; the flash rows count
   the train-remat launches too), then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": ...}`` as the last
   line.

A failed check is reported on stderr when it happens; the run goes on, so
that one call reports every failure, and exits non-zero at the end without
the "ok" line. An exception stops it at once. It exits non-zero without
printing a result when the port's package is not beside it (the import
fails) and when CUDA is unavailable.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
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
#: the moe phase: JAX's Switch-MoE defaults on the 200_p4 model, C =
#: ⌈2501·1.25/4⌉ = 782 slots an expert
MOE = dict(num_experts=4, moe_capacity_factor=1.25)
MOE_FWD_BATCH, MOE_SERVE_N, MOE_TRAIN_BATCH = 8, 8, 16
MOE_TRAIN_WARM, MOE_TRAIN_STEPS = 2, 5
MOE_AUX_WEIGHT = 0.01
#: the float32 card forward against the port's CPU forward on the same
#: weights: the dense forward's flash-vs-dense limit (FWD_TOL), every
#: routing decision equal (the per-block expert and kept counts)
MOE_FWD_TOL = FWD_TOL["float32"]
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
    return eng, config, launches, report


def _chaos_starts(torch, model, sampling, reqs):
    return {s: sampling.fresh_start(model, torch.Generator(device="cuda").manual_seed(s),
                                    n, "cuda") for s, n in reqs}


def _rows_bitwise(torch, model, sampling, reqs, plans) -> dict:
    """Each completed request's rows against the direct ``ddim_sample`` on
    the bucket batch it was dispatched in (its rows of its own start at its
    offset, zero padding): {seed: bitwise}, for the requests that completed."""
    starts = _chaos_starts(torch, model, sampling, reqs)
    H, W = model.img_size
    out: dict = {}
    for plan in plans:
        live = [e for e in plan.entries if not e[0].ticket.failed]
        if not live:
            continue
        x = torch.zeros((plan.bucket, H, W, 3), device="cuda")
        for req, lo, hi, off in plan.entries:
            x[off:off + hi - lo] = starts[int(req.key)][lo:hi]
        want = sampling.ddim_sample(model, x_init=x, k=K).cpu().numpy()
        for req, lo, hi, off in live:
            got = req.ticket.result(timeout=60)[lo:hi]
            same = bool((got == want[off:off + hi - lo]).all())
            out[int(req.key)] = out.get(int(req.key), True) and same
    return out


def _lone_plan(serve, config, seed: int, n: int, ticket):
    """The bucket-4 plan a lone request of n ≤ 4 rows is served in."""
    return serve.BatchPlan(config, 4, ((serve.Request(config, n, key=seed, ticket=ticket),
                                        0, n, 0),), n)


#: serve-chaos: ten requests (seed, n) of 41 rows, planned into five 8-row
#: batches and one of 4; (a) serves seeds 200–209, (b) seeds 300–309
CHAOS_NS = (3, 5, 2, 8, 1, 4, 6, 2, 7, 3)
#: (b)'s outcome on those plans (the same schedule the CPU test
#: ``test_chaos_schedule_and_outcomes_match_jax[chip-serve-chaos]`` holds to
#: the JAX engine's): the first fetch fails 300 and 301, the assembly of
#: the batch of 308 and 309 fails, 304 is quarantined, the rest complete
CHAOS_FAILED = {300: "RequestFailedError", 301: "RequestFailedError",
                304: "RequestQuarantinedError", 308: "RequestFailedError",
                309: "RequestFailedError"}


def phase_serve_chaos(torch, model, fa, serve, eng, config, serve_report):
    """The engine's robustness layer on the north-star model: (a) disarmed
    on the serve phase's engine (the new defaults: prefetch 2, in flight 2,
    the watchdog at its CUDA default), every row bitwise its direct call at
    its bucket batch, exact launches, no program added; (b) chaos on the
    same engine: transient dispatch faults (rate 0.3, seed 11) retried, a
    permanent dispatch fault on the request of seed 304 bisected out and
    quarantined, one permanent assembly fault (the request of seed 309's
    first batch), one permanent fetch fault; every ticket resolves, the
    survivors are bitwise at their dispatch shape, retries equal the
    transient fires, launches equal depth × steps × dispatched batches,
    then a clean drain; (c) a fetch that hangs 3 s under a 1 s stall budget
    fails the open tickets with EngineStalledError while the process lives,
    and a new engine serves; then the bounded queue, the plan-time deadline
    and drain's closed engine."""
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.serve.batching import plan_batches
    from ddim_cold_torch.utils import faults

    t_phase = time.perf_counter()
    steps = len(range(model.total_steps - 1, 0, -K))
    per_batch = model.depth * steps
    programs = eng.stats["programs"]
    check((eng.prefetch_depth, eng.inflight, eng.stall_s) == (2, 2, 900.0),
          f"serve-chaos engine defaults {(eng.prefetch_depth, eng.inflight, eng.stall_s)}")
    rec: dict = {"phase": "serve-chaos", "model": MODEL, "dtype": "bfloat16",
                 "buckets": list(BUCKETS), "k": K, "requests": list(CHAOS_NS),
                 "serve_img_per_sec": serve_report["img_per_sec"],
                 "serve_p50_latency_s": serve_report["latency"]["p50_s"]}

    # (a) disarmed
    reqs = tuple(zip(range(200, 210), CHAOS_NS))
    fa.LAUNCHES["flash_fwd"] = 0          # path (a) starts here
    tickets = {s: eng.submit(seed=s, n=n, config=config) for s, n in reqs}
    report = eng.run()
    torch.cuda.synchronize()
    launches_a = fa.LAUNCHES["flash_fwd"]  # ... and ends here
    pending = [serve.Request(config=config, n=n, key=s, ticket=tickets[s]) for s, n in reqs]
    bitwise = _rows_bitwise(torch, model, sampling, reqs, plan_batches(pending, BUCKETS))
    rec["disarmed"] = {
        "batches": report["batches"], "rows": report["rows"],
        "padded_rows": report["padded_rows"], "wall_s": report["wall_s"],
        "img_per_sec": report["img_per_sec"],
        "p50_latency_s": report["latency"]["p50_s"],
        "flash_fwd_launches": launches_a,
        "expected_launches": per_batch * report["batches"],
        "programs_after_warmup": eng.stats["programs"] - programs,
        "rows_bitwise": sum(bitwise.values()), "requests": len(reqs)}
    check(launches_a == per_batch * report["batches"],
          f"serve-chaos (a): flash_fwd launched {launches_a}")
    check(report["failed_tickets"] == 0 and len(bitwise) == len(reqs)
          and all(bitwise.values()), f"serve-chaos (a): rows bitwise {bitwise}")

    # (b) chaos on the same engine
    reqs = tuple(zip(range(300, 310), CHAOS_NS))
    base = eng._next_rid
    specs = (faults.FaultSpec("serve.dispatch", "transient", rate=0.3, seed=11),
             faults.FaultSpec("serve.dispatch", "permanent", match=f"req:{base + 4}|"),
             faults.FaultSpec("serve.assemble", "permanent", match=f"req:{base + 9}|",
                              max_fires=1),
             faults.FaultSpec("serve.fetch", "permanent", max_fires=1, seed=4))
    finished = []
    eng._finish = lambda plan, out, f=type(eng)._finish: (finished.append(plan),
                                                         f(eng, plan, out))
    try:
        fa.LAUNCHES["flash_fwd"] = 0      # path (b) starts here
        with faults.inject(*specs) as plan:
            tickets = {s: eng.submit(seed=s, n=n, config=config) for s, n in reqs}
            report = eng.run()
            torch.cuda.synchronize()
            launches_b = fa.LAUNCHES["flash_fwd"]  # ... and ends here
            realized = list(plan.realized)
            by_site = plan.by_site()
    finally:
        del eng._finish
    failed, typed = {}, True
    for s, _ in reqs:
        exc = tickets[s].exception(timeout=60)   # TimeoutError: a hung ticket
        if exc is not None:
            failed[s] = type(exc).__name__
            typed &= (isinstance(exc, serve.RequestFailedError)
                      and isinstance(exc.__cause__, faults.FaultError))
    q = tickets[304].exception()
    bitwise = _rows_bitwise(torch, model, sampling, reqs, finished)
    transient = sum(1 for r in realized if r["kind"] == "transient")
    rec["chaos"] = {
        "by_site": by_site, "transient_fires": transient,
        "retries": report["retries"], "quarantined": report["quarantined"],
        "failed": {str(k): v for k, v in failed.items()},
        "batches": report["batches"], "rows": report["rows"],
        "wall_s": report["wall_s"], "flash_fwd_launches": launches_b,
        "expected_launches": per_batch * report["batches"],
        "survivors_bitwise": sum(bitwise.values()),
        "survivors": len(reqs) - len(failed),
        "programs_after_warmup": eng.stats["programs"] - programs}
    check(failed == CHAOS_FAILED, f"serve-chaos (b): failed {failed}")
    check(typed, "serve-chaos (b): every failure a RequestFailedError caused by a fault")
    check(isinstance(q, serve.RequestQuarantinedError)
          and isinstance(q.__cause__, faults.PermanentFault),
          f"serve-chaos (b): seed 304 quarantined ({q!r})")
    check(report["retries"] == transient and transient > 0,
          f"serve-chaos (b): retries {report['retries']} vs transient fires {transient}")
    check(launches_b == per_batch * report["batches"],
          f"serve-chaos (b): flash_fwd launched {launches_b}")
    check(set(bitwise) == set(dict(reqs)) - set(failed) and all(bitwise.values()),
          f"serve-chaos (b): survivors bitwise {bitwise}")
    t = eng.submit(seed=399, n=3, config=config)   # the scope closed: clean
    eng.run()
    clean = _rows_bitwise(torch, model, sampling, ((399, 3),),
                          [_lone_plan(serve, config, 399, 3, t)])
    check(clean == {399: True}, "serve-chaos (b): clean follow-up drain bitwise")
    check(eng.stats["programs"] == programs, "serve-chaos: no program added")

    # (c) a wedged fetch under a 1 s stall budget
    stalled_eng = serve.Engine(model, buckets=BUCKETS, stall_s=1.0)
    serve.warmup(stalled_eng, [config])
    open_tickets = [stalled_eng.submit(seed=s, n=n, config=config)
                    for s, n in ((320, 3), (321, 6))]
    with faults.inject(faults.FaultSpec("serve.fetch", "hang", hang_s=3.0,
                                        max_fires=1)) as plan:
        report = stalled_eng.run()
        hangs = plan.by_site()
    errors = [type(t.exception(timeout=60)).__name__ for t in open_tickets]
    health = stalled_eng.health()
    fresh = serve.Engine(model, buckets=(4,))
    serve.warmup(fresh, [config])
    t = fresh.submit(seed=330, n=2, config=config)
    fresh.run()
    after = _rows_bitwise(torch, model, sampling, ((330, 2),),
                          [_lone_plan(serve, config, 330, 2, t)])
    rec["stall"] = {"wall_s": report["wall_s"], "stalled": report["stalled"],
                    "errors": errors, "stalls": health["stalls"], "hang_by_site": hangs,
                    "new_engine_bitwise": after == {330: True}}
    check(report["stalled"] and health["stalled"] and health["stalls"] == 1,
          f"serve-chaos (c): stall flagged {report['stalled']}, {health['stalls']}")
    check(errors == ["EngineStalledError"] * 2, f"serve-chaos (c): tickets {errors}")
    check(hangs == {"serve.fetch": 1}, f"serve-chaos (c): hang fired {hangs}")
    check(after == {330: True}, "serve-chaos (c): a new engine serves bitwise")

    # admission: the bounded queue, the plan-time deadline, a drained engine
    bounded = serve.Engine(model, buckets=(4,), max_queue=2)
    queued = [bounded.submit(seed=s, n=1, config=config) for s in (340, 341)]
    try:
        bounded.submit(seed=342, n=1, config=config)
        rec["queue_full"] = False
    except serve.QueueFullError:
        rec["queue_full"] = True
    bounded.drain(timeout=5)
    late = fresh.submit(seed=343, n=1, config=config, deadline_s=0.0)
    fresh.run()
    rec["deadline"] = type(late.exception(timeout=60)).__name__
    fresh.drain(timeout=60)
    try:
        fresh.submit(seed=344, n=1, config=config)
        rec["closed"] = False
    except serve.EngineClosedError:
        rec["closed"] = True
    check(rec["queue_full"], "serve-chaos: the third submit at max_queue=2 is refused")
    check(all(isinstance(t.exception(timeout=5), serve.EngineClosedError) for t in queued),
          "serve-chaos: drain fails the queued tickets")
    check(rec["deadline"] == "DeadlineExceeded", f"serve-chaos: deadline {rec['deadline']}")
    check(rec["closed"], "serve-chaos: a drained engine refuses submit")
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return {"serve-chaos disarmed": launches_a, "serve-chaos chaos": launches_b}


#: serve-fleet: eight requests of 31 rows, tenants alternating web, batch;
#: (a) seeds 400–407 disarmed, 430–441 and 450 the admission check, 410–417
#: under chaos, (b) 420–427 over subprocess replicas
FLEET_NS = (3, 5, 2, 8, 1, 4, 6, 2)
FLEET_BUCKETS = (8,)
FLEET_TENANTS = ("web", "batch")
#: (b)'s child-side schedule: r0 SIGKILLs itself at its second work request
FLEET_KILL = "replica.kill:kill:at=1,match=replica:r0|"


def _fleet_direct(torch, model, sampling, seed: int, n: int):
    """The direct ``ddim_sample`` of a request's rows over an 8-row batch
    holding its start in rows 0..n-1 and zero padding: the batch shape the
    fleet serves it at, whatever its batchmates there."""
    H, W = model.img_size
    x = torch.zeros((FLEET_BUCKETS[0], H, W, 3), device="cuda")
    x[:n] = sampling.fresh_start(model, torch.Generator(device="cuda").manual_seed(seed),
                                 n, "cuda")
    return sampling.ddim_sample(model, x_init=x, k=K)[:n].cpu().numpy()


def _poll(pred, timeout_s: float) -> bool:
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.05)
    return True


def _healed(router) -> bool:
    """r0 retired and the fleet back at two active replicas."""
    h = router.health()
    return h["retired_replicas"] >= 1 and h["active_replicas"] == 2


def _fleet_dispatches(health: dict) -> int:
    """Batches dispatched by every engine of a fleet, active and retired."""
    return sum(r.get("dispatches", 0) for r in health["replicas"].values())


def phase_serve_fleet(torch, model, fa, serve, MODEL_CONFIGS):
    """The fleet on the card (see the module docstring, 7c): (a) two
    in-process replicas over the serve model, disarmed, the tenant shares,
    then the fleet chaos schedule; (b) two subprocess replicas with the same
    seeded weights, r0 SIGKILLed at its second work request and replaced."""
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.utils import faults

    t_phase = time.perf_counter()
    config = serve.SamplerConfig(k=K)
    per_batch = model.depth * len(range(model.total_steps - 1, 0, -K))
    rec: dict = {"phase": "serve-fleet", "model": MODEL, "dtype": "bfloat16",
                 "buckets": list(FLEET_BUCKETS), "k": K, "requests": list(FLEET_NS)}

    def run(router, seeds):
        """The eight requests; every ticket waited for (a TimeoutError is a
        ticket that never resolved). Returns tickets, outcomes and wall."""
        t0 = time.perf_counter()
        tickets = {s: router.submit(seed=s, n=n, config=config,
                                    tenant=FLEET_TENANTS[i % 2])
                   for i, (s, n) in enumerate(zip(seeds, FLEET_NS))}
        outcomes = {s: t.exception(timeout=900) for s, t in tickets.items()}
        return tickets, outcomes, time.perf_counter() - t0

    def bitwise(tickets, outcomes) -> dict:
        return {s: bool((t.result(0) == _fleet_direct(torch, model, sampling, s, t.n)).all())
                for s, t in tickets.items() if outcomes[s] is None}

    def served(tickets, wall) -> dict:
        return {"wall_s": wall, "img_per_sec": sum(FLEET_NS) / wall,
                "p50_latency_s": statistics.median(t.latency_s for t in tickets.values()
                                                   if t.latency_s is not None)}

    # (a) two in-process replicas over the shared model
    t0 = time.perf_counter()
    router = serve.Router(serve.local_factory(model, buckets=FLEET_BUCKETS), replicas=2,
                          configs=[config], tenants={"web": 2, "batch": 1},
                          max_pending=24, max_hedges=2, drain_timeout_s=120)
    up_s = time.perf_counter() - t0
    d0 = _fleet_dispatches(router.health())
    fa.LAUNCHES["flash_fwd"] = 0                  # path (a) starts here
    tickets, outcomes, wall = run(router, range(400, 408))
    torch.cuda.synchronize()
    launches_a = fa.LAUNCHES["flash_fwd"]         # ... and ends here
    h = router.health()
    batches = _fleet_dispatches(h) - d0
    bw = bitwise(tickets, outcomes)
    rec["in_process"] = {
        "fleet_up_s": up_s, "batches": batches,
        "batches_by_replica": {rid: r["dispatches"] for rid, r in h["replicas"].items()},
        "flash_fwd_launches": launches_a, "expected_launches": per_batch * batches,
        "rows_bitwise": sum(t.n for s, t in tickets.items() if bw.get(s)),
        "programs_after_warmup": h["programs_after_warmup"], **served(tickets, wall)}
    check(all(e is None for e in outcomes.values()),
          f"serve-fleet (a): failed {[repr(e) for e in outcomes.values() if e]}")
    check(len(bw) == len(FLEET_NS) and all(bw.values()), f"serve-fleet (a): bitwise {bw}")
    check(batches > 0 and launches_a == per_batch * batches,
          f"serve-fleet (a): flash_fwd launched {launches_a} for {batches} batches")
    check(h["programs_after_warmup"] == 0
          and all(r["programs_after_warmup"] == 0 for r in h["replicas"].values()),
          "serve-fleet (a): no program after warmup")
    check(not model.training, "serve-fleet (a): the shared model stays in eval mode")

    # the tenant share: batch holds 24 · 1 // 3 = 8 admitted-unresolved
    admitted, rejected = [], 0
    for s in range(430, 442):
        try:
            admitted.append((s, router.submit(seed=s, n=1, config=config, tenant="batch")))
        except serve.QueueFullError:
            rejected += 1
    n_batch = len(admitted)
    try:
        admitted.append((450, router.submit(seed=450, n=1, config=config, tenant="web")))
        web_ok = True
    except serve.QueueFullError:
        web_ok = False
    adm = {s: t.exception(timeout=900) is None
           and bool((t.result(0) == _fleet_direct(torch, model, sampling, s, 1)).all())
           for s, t in admitted}
    rec["admission"] = {"batch_admitted": n_batch, "batch_rejected": rejected,
                        "web_admitted": web_ok, "rows_bitwise": sum(adm.values()),
                        "rejected_by_tenant": router.stats["rejected_by_tenant"]}
    check(1 <= n_batch <= 8 and rejected == 12 - n_batch,
          f"serve-fleet (a): batch admitted {n_batch}, rejected {rejected}")
    check(web_ok, "serve-fleet (a): web admitted beside a batch flood")
    check(all(adm.values()), f"serve-fleet (a): admitted rows bitwise {adm}")

    # (a) under the fleet chaos schedule (tests/test_fleet.py:178-186)
    schedule = (
        faults.FaultSpec("serve.dispatch", "permanent", rate=1.0, match="replica:r0|"),
        faults.FaultSpec("serve.assemble", "transient", rate=0.25, seed=11),
        faults.FaultSpec("router.place", "transient", rate=0.2, seed=12,
                         match="replica:r1|"))
    h0 = router.health()
    fa.LAUNCHES["flash_fwd"] = 0                  # path (a, chaos) starts here
    with faults.inject(*schedule) as plan:
        tickets, outcomes, wall = run(router, range(410, 418))
        healed = _poll(lambda: _healed(router), 300)
        by_site = plan.by_site()
    torch.cuda.synchronize()
    launches_c = fa.LAUNCHES["flash_fwd"]         # ... and ends here
    h = router.health()
    batches = _fleet_dispatches(h) - _fleet_dispatches(h0)
    spawned = h["replicas_spawned"] - h0["replicas_spawned"]
    bw = bitwise(tickets, outcomes)
    failed = {s: repr(e) for s, e in outcomes.items() if e is not None}
    named = all(isinstance(e, serve.ServeError) and "replica 'r" in str(e)
                for e in outcomes.values() if e is not None)
    rec["chaos"] = {
        "by_site": by_site, "failed": {str(s): e for s, e in failed.items()},
        "survivors_bitwise": sum(bw.values()), "survivors": len(bw),
        "hedges": h["hedges"] - h0["hedges"], "failovers": h["failovers"] - h0["failovers"],
        "replicas_spawned": spawned, "healed": healed,
        "states": {rid: r.get("state") for rid, r in h["replicas"].items()},
        "batches": batches, "flash_fwd_launches": launches_c,
        # a replacement's warmup runs its one (config, bucket) batch
        "expected_launches": per_batch * (batches + spawned),
        "programs_after_warmup": {rid: r.get("programs_after_warmup")
                                  for rid, r in h["replicas"].items()},
        "wall_s": wall}
    check(named, f"serve-fleet (a) chaos: every failure typed and naming its replica {failed}")
    check(len(bw) >= 1 and all(bw.values()), f"serve-fleet (a) chaos: survivors bitwise {bw}")
    check("serve.dispatch" in by_site, f"serve-fleet (a) chaos: fired {by_site}")
    check(healed and h["replicas"].get("r0", {}).get("state") == "closed" and spawned == 1
          and h["active_replicas"] == 2, f"serve-fleet (a) chaos: r0 replaced {rec['chaos']}")
    check(len(h["replicas"]) == 3 and h["programs_after_warmup"] == 0
          and all(r.get("programs_after_warmup") == 0 for r in h["replicas"].values()),
          "serve-fleet (a) chaos: no program after warmup on any of the three replicas")
    check(launches_c == per_batch * (batches + spawned),
          f"serve-fleet (a) chaos: flash_fwd launched {launches_c}")
    router.drain(timeout=120)
    del router, tickets, outcomes, admitted

    # (b) two subprocess replicas on the card, r0 killed at its second work request
    cfg = MODEL_CONFIGS[MODEL]
    spec = {"backend": "engine",
            "model": dict(cfg, img_size=list(cfg["img_size"]), dtype="bfloat16",
                          use_flash=True),
            "init_seed": SEED, "engine": {"buckets": list(FLEET_BUCKETS)}}
    factory = serve.remote_factory(spec, env={"DDIM_COLD_FAULTS": FLEET_KILL},
                                   heartbeat_s=1.0, miss_budget=5, spawn_timeout_s=300,
                                   rpc_timeout_s=60, warm_timeout_s=600)
    children, submits = [], {}

    def tracking(rid):
        rep = factory(rid)
        children.append(rep)
        submit = rep.submit

        def timed(*args, **kwargs):     # when each submit left: the kill's time
            submits.setdefault(rid, []).append(time.perf_counter())
            return submit(*args, **kwargs)
        rep.submit = timed
        return rep

    try:
        t0 = time.perf_counter()
        router = serve.Router(tracking, replicas=2, configs=[config], drain_timeout_s=120)
        up_s = time.perf_counter() - t0
        tickets, outcomes, wall = run(router, range(420, 428))
        healed = _poll(lambda: _healed(router), 600)
        h = router.health()
        bw = bitwise(tickets, outcomes)
        dense = model.clone(use_flash=False)
        dense.load_state_dict(model.state_dict(), assign=True)
        x = torch.zeros((8, *model.img_size, 3), device="cuda")
        x[:3] = sampling.fresh_start(model, torch.Generator(device="cuda").manual_seed(420),
                                     3, "cuda")
        dense_rows = sampling.ddim_sample(dense, x_init=x, k=K)[:3].cpu().numpy()
        not_dense = bool((tickets[420].result(0) != dense_rows).any())
        del dense
        r0 = children[0]
        kill_t = submits.get("r0", [None, None])[1:2]
        detect_s = (r0.crashed_at - kill_t[0]) if kill_t and r0.crashed_at else None
        rec["subprocess"] = {
            "fleet_up_s": up_s,
            "spawn_s": {rep.replica_id: rep.spawn_s for rep in children},
            "warm_s": {rep.replica_id: rep.warm_s for rep in children},
            "crash_reason": r0.crash_reason, "crash_detect_s": detect_s,
            "failovers": h["failovers"], "hedges": h["hedges"],
            "replicas_spawned": h["replicas_spawned"], "healed": healed,
            "rows_bitwise": sum(t.n for s, t in tickets.items() if bw.get(s)),
            "rows_differ_from_dense": not_dense,
            "programs_after_warmup": h["programs_after_warmup"], **served(tickets, wall)}
        check(r0.replica_id == "r0" and r0.crash_reason is not None,
              f"serve-fleet (b): r0's crash seen ({r0.crash_reason})")
        check(all(e is None for e in outcomes.values()),
              f"serve-fleet (b): failed {[repr(e) for e in outcomes.values() if e]}")
        check(len(bw) == len(FLEET_NS) and all(bw.values()),
              f"serve-fleet (b): rows bitwise the parent's direct call {bw}")
        check(not_dense, "serve-fleet (b): rows are the kernel route's, not the dense one's")
        check(h["failovers"] >= 1, f"serve-fleet (b): failovers {h['failovers']}")
        check(healed and h["replicas_spawned"] == 3 and children[-1].warm_s is not None,
              f"serve-fleet (b): a third replica spawned and warmed ({h['replicas_spawned']})")
        check(h["programs_after_warmup"] == 0, "serve-fleet (b): no program after warmup")
        router.drain(timeout=120)
    finally:
        left = [rep.replica_id for rep in children if rep._proc.poll() is None]
        for rep in children:             # stop every process this phase started
            if rep._proc.poll() is None:
                rep._proc.kill()
                rep._proc.wait(timeout=60)
    rec.setdefault("subprocess", {})["children_left"] = left
    check(not left, f"serve-fleet (b): children still running after drain: {left}")
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return {"serve-fleet in-process": launches_a, "serve-fleet chaos": launches_c}


def check_released(torch, what: str, before: int) -> None:
    """A phase that has returned holds no device memory: what it allocated
    is freed by the time it returns (``before`` is ``memory_allocated``
    just before it), and a garbage collection then frees nothing. Memory
    held by a reference cycle or by a thread that outlives the phase would
    be freed later, in the middle of whatever phase follows."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    after = torch.cuda.memory_allocated()
    check(held == after, f"{what}: the collector freed {held - after} bytes of device memory")
    check(after == before, f"{what}: {after - before} bytes of device memory outlived it")


def drop_cublas_workspaces(torch) -> None:
    """Free the cuBLAS workspaces PyTorch keeps in the caching allocator,
    one per (cuBLAS handle, stream). A thread's first GEMM takes a handle
    from PyTorch's pool and allocates its workspace; when the thread ends,
    the handle and its workspace stay in the pool for the next thread. The
    fleet's replica worker threads leave theirs behind when they end: a
    bounded cache, not memory of the phase's data, so serve-fleet's release
    check reads ``memory_allocated`` with all workspaces dropped, before and
    after (the next GEMM on a thread allocates its workspace again)."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


# ------------------------------------------------ attribution of the captures

#: each hand-written kernel's profiler scope (``obs/attrib.REGISTERED_SCOPES``;
#: the key is a substring of the kernel's device function names)
KERNEL_SCOPES = {"flash_fwd": "flash_attention/fwd", "flash_bwd_dq": "flash_attention/dq",
                 "flash_bwd_dkv": "flash_attention/dkv",
                 "fused_trunk": "flash_attention/fused_qkv",
                 "dequant_mm": "dequant_matmul/pallas", "mlp_fused": "mlp/pallas"}
#: a kernel scope's device time against its kernel's: the scope opens around
#: the launch alone (the wrappers' copies, casts and w8a8 activation
#: quantization sit outside it), so it may exceed the kernel's summed device
#: time by 5%, plus SCOPE_ROUND_S for the trace's µs rounding of each event
SCOPE_SLACK = 1.05
SCOPE_ROUND_S = 5e-6
#: ``busy_fraction`` against 1 − the phase's own idle share, absolute
BUSY_TOL = 0.005
#: where the captures' Chrome traces are written and read back (gitignored;
#: each is deleted once attributed)
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")


def _device_spans(prof):
    """The profiler's device events that are work — kernels, copies, sets —
    and not the ``gpu_user_annotation`` mirror of a scope."""
    from torch.autograd import DeviceType

    from ddim_cold_torch.obs import attrib

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in attrib.REGISTERED_SCOPES]


def serve_scope_costs(model, forwards: int, quant=None, fused=False) -> dict:
    """A served capture's scope costs: ``flops.vit_scope_costs`` of one
    image's forward × ``forwards`` (rows × steps); in w8a8 with the share of
    a scope's FLOPs that runs at the int8 rate: the fused attention's
    projections, the whole fused Mlp, the forward's trunk GEMMs."""
    from ddim_cold_torch.models import MODEL_CONFIGS
    from ddim_cold_torch.utils import flops

    kw = dict(MODEL_CONFIGS[MODEL], mlp_ratio=1.0)
    per = flops.vit_scope_costs(**kw, flash=True, quant=quant is not None, fused=fused)
    fractions = {}
    if quant == "w8a8":
        n, c = model.num_patches + 1, model.embed_dim
        fractions = {"flash_attention/fused_qkv": 2 * c / (n + 2 * c), "mlp/pallas": 1.0,
                     "sampler/model": flops.vit_trunk_gemm_fraction(**kw)}
    return {scope: {"flops": cost["flops"] * forwards, "bytes": cost["bytes"] * forwards,
                    **({"int8_fraction": fractions[scope]} if scope in fractions else {})}
            for scope, cost in per.items()}


def train_scope_costs(model, images: int) -> dict:
    """The flash kernels' work in a training window: per image and layer the
    forward's 4·N²·C FLOPs, dq's 6·N²·C (S, dP and dS·K again) and dk/dv's
    8·N²·C (S, dP, Pᵀ·dO and dSᵀ·Q), in bf16; bytes each input read and
    each output written once."""
    n, c, depth = model.num_patches + 1, model.embed_dim, model.depth
    per = {"flash_attention/fwd": (4, 4), "flash_attention/dq": (6, 5),
           "flash_attention/dkv": (8, 6)}
    return {scope: {"flops": float(f * n * n * c * depth * images),
                    "bytes": float(b * n * c * 2 * depth * images)}
            for scope, (f, b) in per.items()}


def attribute_capture(torch, prof, log_dir: str, capture: str, costs: dict,
                      launches: dict, idle_share: float, floor: bool,
                      keep: bool = False) -> dict:
    """Read back a capture's trace with ``obs.attrib`` and hold it: each
    kernel's scope holds exactly its launches and its summed device time
    (by name, from the profiler's own events) within SCOPE_SLACK; the busy
    fraction is 1 − the phase's idle share within BUSY_TOL; no MFU above 1
    nor achieved rate above the scope's peak; with ``floor``, coverage at
    least ``attrib.COVERAGE_FLOOR``. Emits one ``attrib`` record and returns
    the report; the capture's directory is removed unless ``keep``."""
    from ddim_cold_torch.obs import attrib
    from ddim_cold_torch.utils import flops

    kind = torch.cuda.get_device_name(0)
    path = os.path.join(log_dir, "trace.json")
    trace_mb = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    report = attrib.attribute(log_dir, device_kind=kind, scope_costs=costs)
    parse_s = time.perf_counter() - t0
    if not keep:
        shutil.rmtree(log_dir)
    kernel_s = {name: 0.0 for name in launches}
    for e in _device_spans(prof):
        for name in kernel_s:
            if name in e.name:
                kernel_s[name] += (e.time_range.end - e.time_range.start) / 1e6
    keys = ("self_s", "total_s", "events", "share_of_busy", "achieved_tflops", "mfu",
            "roofline")
    scopes = {name: {k: node[k] for k in keys}
              for name, node in attrib.ranked_scopes(report)}
    rec = {"phase": "attrib", "capture": capture, "device_kind": kind,
           "coverage": report["coverage"], "busy_fraction": report["busy_fraction"],
           "phase_idle_share": idle_share, "window_s": report["window_s"],
           "device_busy_s": report["device_busy_s"], "idle_s": report["idle_s"],
           "device_lanes": report["device_lanes"], "scopes": scopes,
           "kernel_s": kernel_s, "expected_events": launches,
           "fusion_candidates": report["fusion_candidates"][:3],
           "trace_mb": trace_mb, "attribute_s": parse_s}
    emit(rec)
    for name, n in launches.items():
        node = report["scopes"].get(KERNEL_SCOPES[name], {})
        self_s = node.get("self_s", 0.0)
        check(node.get("events") == n,
              f"attrib {capture}: {KERNEL_SCOPES[name]} events {node.get('events')}, "
              f"{name} launched {n}")
        check(kernel_s[name] - SCOPE_ROUND_S <= self_s
              <= SCOPE_SLACK * kernel_s[name] + SCOPE_ROUND_S,
              f"attrib {capture}: {KERNEL_SCOPES[name]} self {self_s} s against "
              f"{name}'s {kernel_s[name]} s")
    check(report["busy_fraction"] is not None
          and abs(report["busy_fraction"] - (1.0 - idle_share)) <= BUSY_TOL,
          f"attrib {capture}: busy fraction {report['busy_fraction']} against the "
          f"phase's idle share {idle_share}")
    for name, node in report["scopes"].items():
        peak = flops.mixed_peak_tflops(kind, (costs.get(name) or {}).get("int8_fraction", 0.0))
        check(node["mfu"] is None or node["mfu"] <= 1.0,
              f"attrib {capture}: {name} mfu {node['mfu']}")
        check(node["achieved_tflops"] is None or (peak and node["achieved_tflops"] <= peak),
              f"attrib {capture}: {name} {node['achieved_tflops']} TFLOP/s against a "
              f"peak of {peak}")
    if floor:
        check(report["coverage"] is not None and report["coverage"] >= attrib.COVERAGE_FLOOR,
              f"attrib {capture}: coverage {report['coverage']} under "
              f"{attrib.COVERAGE_FLOOR}")
    return report


def phase_profile(torch, eng, config):
    """Where a served batch's time goes: one more drain of a single 8-row
    batch traced by ``utils/profiling.trace``; device kernel time by kind
    and the device's idle share over the drain; then the trace attributed
    to the port's scopes (``obs/attrib``). Returns the attribution report;
    the capture stays in ``TRACE_DIR/serve`` for the cli phase."""
    from ddim_cold_torch.utils import profiling

    ticket = eng.submit(seed=3, n=8, config=config)
    log_dir = os.path.join(TRACE_DIR, "serve")
    with profiling.trace(log_dir) as prof:
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticket.result(timeout=600)
    kernels = _device_spans(prof)
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
    launches = eng.model.depth * steps * report["batches"]
    check(rec["flash_fwd_launches"] == launches,
          f"profiled flash_fwd launches {rec['flash_fwd_launches']}")
    forwards = steps * (report["rows"] + report["padded_rows"])  # image-forwards
    # the capture stays for the cli phase's attrib-report
    return attribute_capture(torch, prof, log_dir, "serve",
                             serve_scope_costs(eng.model, forwards), {"flash_fwd": launches},
                             rec["idle_share"], floor=True, keep=True)


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


#: train-dispatch: optimizer steps of each way, and steps a dispatch
DISPATCH_STEPS, DISPATCH_N = 4, 2


def phase_train_dispatch(torch, fa) -> dict:
    """train-dispatch and train-blocks: the bf16 flash 200_p4 model at B=16
    (dropout and drop path 0.1, attention dropout 0), built from an
    ``ExperimentConfig`` through ``model_kwargs``, from one seeded state,
    four steps three ways: four single calls, two dispatches of
    ``steps_per_dispatch=2``, and four single calls of the model built with
    ``flash_blocks: [512, 1024]``. Each step draws from its own step's
    generator. Checks: the dispatch and the blocks runs bit for bit the
    single calls (parameters, moments, EMA loss; a dispatch's loss the mean
    of its two steps'), each flash kernel launched depth × 4 times in each
    way. ms/step of each way (no speed claimed). Returns the dispatch's and
    the blocks run's launches."""
    from ddim_cold_torch.config import ExperimentConfig
    from ddim_cold_torch.data.loader import device_prefetch, group_batches
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.train.step import (create_train_state, make_train_step,
                                            step_generator)

    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    host = _cold_batches(DISPATCH_STEPS, 16, SEED + 11)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    runs = {}
    for way, n, blocks in (("single", 1, None), ("dispatch", DISPATCH_N, None),
                           ("blocks", 1, (512, 1024))):
        config = ExperimentConfig(exp_name="chip_smoke", framework="dispatch", amp=True,
                                  batch_size=8, epoch=(0, 8), base_lr=0.005,
                                  image_size=(200, 200), diff_step=7, patch_size=4,
                                  embed_dim=256, depth=6, head=4, use_flash=True,
                                  flash_blocks=blocks, steps_per_dispatch=n)
        model = DiffusionViT(**config.model_kwargs(), dtype=torch.bfloat16, seed=SEED,
                             attn_drop_rate=0.0, device="cuda")
        state = create_train_state(model, config.lr, TRAIN_TOTAL_STEPS)
        step = make_train_step(model, prepare=prepare, steps_per_dispatch=n)
        rec = torch.tensor(5.0, device="cuda")

        def gen_of(s):
            return step_generator(SEED, s, "cuda")

        losses = []
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0  # this way's path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in device_prefetch(group_batches(host, n), "cuda"):
            state, loss, rec = step(state, b, gen_of if n > 1 else gen_of(state.step), rec)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[way] = {"losses": torch.stack(losses), "rec": rec,
                     "tensors": [p.detach().clone() for p in model.parameters()]
                     + [m.clone() for m in state.mu + state.nu],
                     "launches": {k: fa.LAUNCHES[k] for k in kernels},  # ... and ends here
                     "ms_per_step": wall / DISPATCH_STEPS * 1e3,
                     "depth": model.depth}
        del model, state, step
    single = runs["single"]
    want = single["depth"] * DISPATCH_STEPS
    for way in ("dispatch", "blocks"):
        got = runs[way]
        if way == "dispatch":
            pairs = single["losses"].reshape(-1, DISPATCH_N)
            same_loss = all(torch.equal(got["losses"][j], pairs[j].mean())
                            for j in range(len(pairs)))
        else:
            same_loss = torch.equal(got["losses"], single["losses"])
        same = all(torch.equal(a, b) for a, b in zip(got["tensors"], single["tensors"]))
        rec = {"phase": f"train-{way}", "model": MODEL, "dtype": "bfloat16", "batch": 16,
               "steps": DISPATCH_STEPS,
               "steps_per_dispatch": DISPATCH_N if way == "dispatch" else 1,
               "flash_blocks": [512, 1024] if way == "blocks" else None,
               "ms_per_step": got["ms_per_step"],
               "single_ms_per_step": single["ms_per_step"],
               "speed": "reported, no claim", "bitwise_state": same,
               "bitwise_losses": same_loss,
               "bitwise_loss_ema": torch.equal(got["rec"], single["rec"]),
               "losses": got["losses"].tolist(), "launches": got["launches"],
               "single_launches": single["launches"], "want_launches": want}
        emit(rec)
        check(same and same_loss and rec["bitwise_loss_ema"],
              f"train-{way} not bitwise the single calls: {rec}")
        check(all(v == want for v in list(got["launches"].values())
                  + list(single["launches"].values())),
              f"train-{way} launches {got['launches']} / {single['launches']}, want {want}")
        check(bool(torch.isfinite(got["losses"]).all()), f"train-{way} losses {rec['losses']}")
    out = {"train-dispatch n=2": runs["dispatch"]["launches"],
           "train flash_blocks": runs["blocks"]["launches"]}
    del runs
    torch.cuda.empty_cache()
    return {label: dict(dict.fromkeys(PATH_KERNELS, 0), **counts)
            for label, counts in out.items()}


def phase_train_profile(torch, model, state, step, batch, gen):
    """Where a training step's time goes: PROFILE_STEPS more steps traced by
    ``utils/profiling.start_trace``/``stop_trace`` (the trainer's
    ``profile_steps``; the host→device copies of the later batches overlap
    the earlier steps, as in a run); device time of the three kernels and
    of the rest, and the device's idle share over the window; then the
    trace attributed to the port's scopes (coverage reported: autograd's
    backward kernels outside the dq/dkv scopes are under no scope)."""
    from ddim_cold_torch.utils import profiling

    loss_rec = torch.tensor(5.0, device="cuda")
    log_dir = os.path.join(TRACE_DIR, "train")
    profiling.start_trace(log_dir)
    t0 = time.perf_counter()
    _run_steps(torch, step, state, batch, gen, loss_rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profiling.stop_trace()
    kinds = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": [], "gemm": [],
             "other": []}
    by_name: dict = {}
    for e in _device_spans(prof):
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
    images = len(batch) * int(batch[0][0].shape[0])
    attribute_capture(torch, prof, log_dir, "train", train_scope_costs(model, images),
                      {k: model.depth * len(batch)
                       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                      rec["idle_share"], floor=False)


def phase_train_nan(torch):
    """``nan_checks`` at the training path's full width: two B=16 steps of
    the bf16 flash model without and with ``profiling.enable_nan_checks``
    (fresh seeded models, the same batches and generator seed): no false
    positive, each loss bit for bit the plain one, the second step of each
    timed; then one NaN written into a weight raises ``FloatingPointError``
    naming the module its output reached. The checks are off afterwards."""
    from torch.nn.modules import module as nn_module

    from ddim_cold_torch.data.loader import device_prefetch
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.train.step import create_train_state, make_train_step
    from ddim_cold_torch.utils import profiling

    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    host = _cold_batches(3, 16, SEED + 4)
    lr = 0.005 * 16 / 512
    got = {}
    raised = None
    for checked in (False, True):
        model = _train_model(torch, drop_rate=0.1, attn_drop_rate=0.0, drop_path_rate=0.1)
        state = create_train_state(model, lr, TRAIN_TOTAL_STEPS)
        step = make_train_step(model, prepare=prepare)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        loss_rec = torch.tensor(5.0, device="cuda")
        losses, ms = [], None
        if checked:
            profiling.enable_nan_checks(True, model)
        try:
            for i, b in enumerate(device_prefetch(host[:2], "cuda")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss, loss_rec = step(state, b, gen, loss_rec)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                losses.append(loss.item())
            if checked:
                with torch.no_grad():
                    model.blocks[2].mlp.fc1.weight[0, 0] = float("nan")
                try:
                    _run_steps(torch, step, state, host[2:], gen, loss_rec)
                    torch.cuda.synchronize()
                except FloatingPointError as err:
                    raised = str(err)
        finally:
            profiling.enable_nan_checks(False)
        got[checked] = (losses, ms)
        del model, state, step
    torch.cuda.empty_cache()
    rec = {"phase": "train-nan", "model": MODEL, "dtype": "bfloat16", "batch": 16,
           "losses_plain": got[False][0], "losses_nan_checks": got[True][0],
           "ms_per_step_plain": got[False][1], "ms_per_step_nan_checks": got[True][1],
           "slowdown": got[True][1] / got[False][1], "raised": raised}
    emit(rec)
    check(got[True][0] == got[False][0] and all(map(math.isfinite, got[False][0])),
          f"train-nan: losses {got[True][0]} under nan_checks, {got[False][0]} without")
    check(raised is not None and "'blocks.2.mlp'" in raised,
          f"train-nan: a NaN weight raised {raised!r}")
    check(not torch.is_anomaly_enabled() and not nn_module._global_forward_hooks,
          "train-nan: the checks outlived the phase")


# ------------------------------------------- the trainer as users start it

#: the synthetic image folder of the native and train-run phases: sizes
#: drawn around 500×500 (Oxford Flowers' own JPEGs are not in the repo)
NATIVE_TRAIN, NATIVE_VAL, NATIVE_SIDE = 128, 32, (440, 561)
LOADER_THREADS = 8
#: the dense trainer's consumption rate at B=16: 16 images / 137.98 ms a
#: step (PERF.md §5: the dense route on an H100 80GB HBM3 at 700 W)
DENSE_TRAIN_IMG_S = 16 / 0.13798
#: train-remat: (route, attention dropout, warm-up steps, timed steps)
REMAT_ROUTES = (("flash", 0.0, 3, 10), ("dense", 0.1, 1, 3))
#: train-run: the epochs, and the ``ckpt.save`` call the kill is placed at:
#: each save fires 4 windows; epoch 0 saves bestloss.ckpt (calls 0-3: the
#: val loss always improves on the initial 5.0) and lastepoch.ckpt (4-7);
#: epoch 1's first save is calls 8-11, so call 9 is its post-write window:
#: lastepoch.ckpt's when the val loss does not improve, bestloss.ckpt's
#: when it does. Either way the file on disk still holds epoch 0 and
#: lastepoch.ckpt is epoch 0's; the temp file the kill leaves names the file
#: it hit, and is checked to be one of the two.
RUN_EPOCHS, KILL_AT = 3, 9
#: the val folder's batches of 16: the evaluation forward is deterministic,
#: so it takes the flash kernel (the dense rule binds training only)
RUN_VAL_BATCHES = NATIVE_VAL // 16
#: probe-xla: a probed layer's weights on the flash model against the dense
#: model's: layer 0 bit for bit (nothing runs before it); later layers see
#: inputs that went through the flash or the dense route, so each row's
#: total-variation distance must stay under this: ten times the largest
#: reading on an H100 80GB HBM3 at 700 W (0.00049, PERF.md §6). At the
#: seeded init every row is close to uniform, so two controls (another
#: layer, another input) must land above it, showing the check can fail
PROBE_TV = 5e-3


def _png(arr) -> bytes:
    """An RGB8 PNG of ``arr`` (H, W, 3) uint8, written with zlib and struct."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in arr)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _write_images(folder: str, n: int, rs, jpeg) -> dict:
    """``n`` seeded images of varied sizes: smooth colour fields plus noise,
    PNG, every other one JPEG when ``jpeg`` (PIL's Image) is given."""
    import numpy as np

    os.makedirs(folder)
    formats: dict = {}
    for i in range(n):
        h, w = (int(s) for s in rs.integers(*NATIVE_SIDE, size=2))
        low = rs.uniform(0, 255, (h // 64 + 2, w // 64 + 2, 3))
        img = np.repeat(np.repeat(low, 64, 0), 64, 1)[:h, :w]
        img = np.clip(img + rs.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        if jpeg is not None and i % 2:
            jpeg.fromarray(img).save(os.path.join(folder, f"{i:04d}.jpg"), quality=90)
            formats["jpg"] = formats.get("jpg", 0) + 1
        else:
            with open(os.path.join(folder, f"{i:04d}.png"), "wb") as f:
                f.write(_png(img))
            formats["png"] = formats.get("png", 0) + 1
    return formats


def phase_native(torch):
    """The native decode tier on the card's machine: the build tools, the
    build, then one epoch of the loader at 200 px with 8 threads over a
    synthetic folder, per tier and route, against the dense trainer's
    consumption rate. With the tools present the tier must load and take
    every batch; without them the compiler's error is printed and the
    trainer runs on the PIL tier, as the line says."""
    import ctypes.util
    import tempfile

    import numpy as np

    from ddim_cold_torch.data import ColdDownSampleDataset, ShardedLoader
    from ddim_cold_torch.data import datasets, native

    tools = {"g++": shutil.which("g++") is not None,
             "jpeglib.h": os.path.isfile("/usr/include/jpeglib.h"),
             "png.h": os.path.isfile("/usr/include/png.h"),
             "libjpeg": ctypes.util.find_library("jpeg") is not None,
             "libpng": ctypes.util.find_library("png") is not None}
    t0 = time.perf_counter()
    available = native.available()
    build_s = time.perf_counter() - t0
    try:
        from PIL import Image
    except ImportError:
        Image = None
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    rs = np.random.default_rng(SEED + 6)
    formats = {"train": _write_images(os.path.join(root, "train"), NATIVE_TRAIN, rs, Image),
               "val": _write_images(os.path.join(root, "val"), NATIVE_VAL, rs, Image)}
    tiers = (["native"] if available else []) + (["pil"] if Image is not None else [])
    loader = {}
    for tier in tiers:
        for raw in (False, True):
            ds = ColdDownSampleDataset(os.path.join(root, "train"), imgSize=(200, 200),
                                       use_native=tier == "native", cache_images=False)
            ld = ShardedLoader(ds, 16, shuffle=True, seed=42, drop_last=True,
                               num_threads=LOADER_THREADS, raw=raw)
            pil_before = datasets.PIL_DECODES["files"]
            t0 = time.perf_counter()
            n = sum(len(b[0]) for b in ld)
            wall = time.perf_counter() - t0
            loader[f"{tier} {'raw' if raw else 'host-degrade'}"] = {
                "img_per_s": n / wall, "images": n, "routes": dict(ld.routes),
                "pil_decodes": datasets.PIL_DECODES["files"] - pil_before}
    rec = {"phase": "native", "available": available,
           "has_decode_batch": native.has_decode_batch(), "build_s": build_s,
           "library": native.library_path(), "tools": tools,
           "build_error": None if available else native.build_error(),
           "images": {"train": NATIVE_TRAIN, "val": NATIVE_VAL}, "formats": formats,
           "loader_threads": LOADER_THREADS, "loader": loader,
           "dense_train_consumes_img_per_s": DENSE_TRAIN_IMG_S,
           "trainer_tier": "native" if available else "pil"}
    emit(rec)
    if all(tools.values()):
        check(available, f"native: the build tools are present but the tier did "
                         f"not load: {native.build_error()}")
    if not available:
        print(f"chip_smoke: native: the tier is unavailable here (tools {tools}); "
              f"the trainer runs on the PIL tier. Compiler:\n{native.build_error()}",
              file=sys.stderr, flush=True)
    for key, got in loader.items():
        if key.startswith("native"):
            route = "raw" if key.endswith("raw") else "get_batch"
            check(got["routes"] == {route: NATIVE_TRAIN // 16} and not got["pil_decodes"],
                  f"native: {key} took {got['routes']}, {got['pil_decodes']} PIL decodes")
    check(bool(tiers), "native: neither the native tier nor PIL can read images here")
    return root, rec["trainer_tier"]


def phase_train_remat(torch, fa):
    """``remat`` at the training path's full width: the bf16 200_p4 model
    at B=16 (dropout and drop path 0.1), remat off and on with the same
    seed, batches and generator seed, on the flash route (attention dropout
    0) and the dense route (0.1): losses, parameters and the generator's
    state bit for bit equal; exact launches (remat: the forward kernel
    2 × depth a step, each backward kernel depth); ms/step and peak memory
    of each."""
    from ddim_cold_torch.data.loader import device_prefetch
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    host = _cold_batches(max(w + s for _, _, w, s in REMAT_ROUTES), 16, SEED + 5)
    lr = 0.005 * 16 / 512
    remat_launches = {}
    for route, attn_drop, warm, n_steps in REMAT_ROUTES:
        got = {}
        for remat in (False, True):
            model = _train_model(torch, drop_rate=0.1, attn_drop_rate=attn_drop,
                                 drop_path_rate=0.1, remat=remat)
            state = create_train_state(model, lr, TRAIN_TOTAL_STEPS)
            step = make_train_step(model, prepare=prepare)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            loss_rec = torch.tensor(5.0, device="cuda")
            losses = []
            batches = list(device_prefetch(host[:warm + n_steps], "cuda"))
            for b in batches[:warm]:
                state, loss, loss_rec = step(state, b, gen, loss_rec)
                losses.append(loss)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0
            t0 = time.perf_counter()
            for b in batches[warm:]:
                state, loss, loss_rec = step(state, b, gen, loss_rec)
                losses.append(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got[remat] = {
                "losses": torch.stack(losses).cpu(),
                "params": [p.detach().clone() for p in model.parameters()],
                "gen": gen.get_state(), "ms_per_step": wall / n_steps * 1e3,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": {k: fa.LAUNCHES[k] for k in
                             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
            del model, state, step, batches
            torch.cuda.empty_cache()
        off, on = got[False], got[True]
        depth = 6
        rec = {"phase": "train-remat", "model": MODEL, "dtype": "bfloat16", "batch": 16,
               "route": route, "attn_drop_rate": attn_drop, "drop_rate": 0.1,
               "drop_path_rate": 0.1, "warmup_steps": warm, "steps": n_steps,
               "ms_per_step": {"off": off["ms_per_step"], "on": on["ms_per_step"]},
               "ms_ratio_on_off": on["ms_per_step"] / off["ms_per_step"],
               "peak_mem_gib": {"off": off["peak_mem_gib"], "on": on["peak_mem_gib"]},
               "losses": off["losses"].tolist(),
               "losses_bitwise": torch.equal(off["losses"], on["losses"]),
               "params_bitwise": all(torch.equal(a, b)
                                     for a, b in zip(off["params"], on["params"])),
               "generator_bitwise": torch.equal(off["gen"], on["gen"]),
               "launches": {"off": off["launches"], "on": on["launches"]}}
        emit(rec)
        for key in ("losses_bitwise", "params_bitwise", "generator_bitwise"):
            check(rec[key], f"train-remat {route}: {key} false")
        check(all(map(math.isfinite, rec["losses"])), f"train-remat {route} losses")
        if route == "flash":
            want_on = {"flash_fwd": 2 * depth * n_steps, "flash_bwd_dq": depth * n_steps,
                       "flash_bwd_dkv": depth * n_steps}
            want_off = {k: depth * n_steps for k in want_on}
            remat_launches = on["launches"]
        else:
            want_on = want_off = {k: 0 for k in on["launches"]}
        check(on["launches"] == want_on and off["launches"] == want_off,
              f"train-remat {route} launches {rec['launches']}")
        del got, off, on
    return remat_launches


def _run_yaml(data_root: str, resume: str = "none") -> str:
    """``20220822_200px.yaml``'s keys, with ``dataStorage`` at the synthetic
    folder, RUN_EPOCHS epochs, ``remat: True`` and no ``snapshot_epochs``."""
    here = os.path.dirname(os.path.abspath(__file__))
    lines = []
    with open(os.path.join(here, "20220822_200px.yaml")) as f:
        for line in f:
            key = line.split(":", 1)[0].strip()
            if key == "dataStorage":
                line = (f"dataStorage : [{json.dumps(os.path.join(data_root, 'train'))}, "
                        f"{json.dumps(os.path.join(data_root, 'val'))}]\n")
            elif key == "epoch":
                line = f"epoch : [0,{RUN_EPOCHS}]\n"
            elif key == "resume":
                line = f"resume : {json.dumps(resume)}\n"
            elif key == "snapshot_epochs":
                continue
            lines.append(line)
    return "".join(lines) + "remat : True\n"


#: run 2's child: the same entry point a user starts, then one JSON line of
#: what only the child can read (its peak memory and launch counts)
RESUME_CHILD = """
import json, sys, torch
from ddim_cold_torch import __main__ as cli
from ddim_cold_torch.ops import flash_attention as fa
rc = cli.main(["train", sys.argv[1]])
print(json.dumps({"child": {"rc": rc,
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                            "launches": dict(fa.LAUNCHES)}}), flush=True)
sys.exit(rc)
"""


def _epoch_lines(log: str) -> list:
    """(epoch, val loss, seconds since the epoch) of each ``epoch:`` line."""
    out = []
    for m in re.finditer(r"^epoch:\s+(\d+)\s+loss: ([0-9.eE+-]+|nan)\s+time:(.+)$", log,
                         re.MULTILINE):
        when = time.mktime(time.strptime(m.group(3).strip(), "%a %b %d %H:%M:%S %Y"))
        out.append((int(m.group(1)), float(m.group(2)), when))
    return out


def phase_train_run(torch, data_root: str, tier: str):
    """The trainer as users start it: ``python -m ddim_cold_torch train
    <exp>`` as a child process on the 200px YAML's keys (``remat: True``,
    3 epochs of the synthetic folder). Run 1 is SIGKILLed by a
    ``ckpt.save:kill`` fault at the post-write window of the second epoch's
    first save (lastepoch.ckpt, or bestloss.ckpt when the val loss
    improved): every checkpoint left loads, lastepoch.ckpt holds epoch 0,
    the warm-start pkl was written. Run 2 resumes from it and finishes
    epochs 1 and 2 (24 steps); every path it saves has no temp file left
    beside it (the dead writer's is removed by that path's next save); its
    training launches no flash kernel (attention dropout 0.1: the dense
    rule), and its evaluation forwards, deterministic, launch flash_fwd
    depth × val batches an epoch and no backward kernel. Returns (working
    directory, run directory): the cli phase reads the finished run, and
    the caller removes the working directory after it."""
    import signal
    import tempfile

    from ddim_cold_torch.utils import checkpoint as ckpt

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_train_run_")
    exp = "chip_smoke_run"
    run_dir = os.path.join(work, "Saved_Models", exp + "flower200_diffusion")
    last = os.path.join(run_dir, "lastepoch.ckpt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    torch.cuda.empty_cache()
    with open(os.path.join(work, exp + ".yaml"), "w") as f:
        f.write(_run_yaml(data_root))
    t0 = time.perf_counter()
    run1 = subprocess.run(
        [sys.executable, "-m", "ddim_cold_torch", "train", exp], cwd=work,
        capture_output=True, text=True, timeout=300,
        env=dict(env, DDIM_COLD_FAULTS=f"ckpt.save:kill:match=window:post-write|,at={KILL_AT}"))
    wall1 = time.perf_counter() - t0
    log1 = open(os.path.join(run_dir, "train.log")).read()
    epochs1 = _epoch_lines(log1)
    left = sorted(os.listdir(run_dir))
    killed = [n for n in left if n.endswith(".writing")]
    loads = {}
    for name in left:
        if name.endswith(".ckpt"):
            try:
                loads[name] = ckpt.load_checkpoint(os.path.join(run_dir, name))
            except Exception as e:  # noqa: BLE001 — a torn file is what this checks for
                loads[name] = e
    pkl = os.path.join(work, "Saved_Models", "flower200_p4.pkl")
    try:
        pkl_leaves = len(ckpt.load_torch_pkl(pkl))
    except Exception as e:  # noqa: BLE001 — reported and failed below
        pkl_leaves = repr(e)
    survivor = loads.get("lastepoch.ckpt")
    survivor_epoch = survivor.get("epoch") if isinstance(survivor, dict) else None
    rec1 = {"phase": "train-run", "run": 1, "command": f"python -m ddim_cold_torch train {exp}",
            "tier": tier, "fault": f"ckpt.save:kill at={KILL_AT} post-write",
            "returncode": run1.returncode, "wall_s": wall1, "files": left,
            "epochs": [(e, loss) for e, loss, _ in epochs1],
            "killed_while_writing": killed,
            "checkpoints_load": {k: not isinstance(v, Exception) for k, v in loads.items()},
            "lastepoch_epoch": survivor_epoch, "warm_start_pkl_leaves": pkl_leaves,
            "stderr_tail": run1.stderr[-600:]}
    emit(rec1)
    check(run1.returncode == -signal.SIGKILL,
          f"train-run 1: exit {run1.returncode}, not SIGKILL: {run1.stderr[-2000:]}")
    check(len(killed) == 1 and killed[0].split(".ckpt.")[0] in ("lastepoch", "bestloss"),
          f"train-run 1: call {KILL_AT} was not epoch 1's first post-write "
          f"(left {killed}, epochs {rec1['epochs']})")
    check(loads and all(rec1["checkpoints_load"].values()),
          f"train-run 1: checkpoints {rec1['checkpoints_load']}")
    check(survivor_epoch == 0, f"train-run 1: lastepoch.ckpt holds epoch {survivor_epoch}")
    check(isinstance(pkl_leaves, int) and pkl_leaves > 0,
          f"train-run 1: warm-start pkl {pkl_leaves}")

    with open(os.path.join(work, exp + ".yaml"), "w") as f:
        f.write(_run_yaml(data_root, resume=last))
    t0, start2 = time.perf_counter(), time.time()
    run2 = subprocess.run([sys.executable, "-c", RESUME_CHILD, exp], cwd=work,
                          capture_output=True, text=True, timeout=300, env=env)
    wall2 = time.perf_counter() - t0
    child = {}
    for line in run2.stdout.splitlines():
        if line.startswith('{"child"'):
            child = json.loads(line)["child"]
    log2 = open(os.path.join(run_dir, "train.log")).read()[len(log1):]
    epochs2 = _epoch_lines(log2)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        ends = [json.loads(line)["time"] for line in f][len(epochs1):]
    final = ckpt.load_checkpoint(last) if os.path.isfile(last) else {}
    metric = survivor.get("metric") if isinstance(survivor, dict) else None
    writing = [n for n in os.listdir(run_dir) if n.endswith(".writing")]
    # a dead writer's temp file may stay only beside a path run 2 never saved
    saved = {n for n in os.listdir(run_dir)
             if n.endswith(".ckpt") and os.path.getmtime(os.path.join(run_dir, n)) >= start2}
    stale = [n for n in writing if n.split(".ckpt.")[0] + ".ckpt" in saved]
    flash = {k: n for k, n in child.get("launches", {}).items() if n}
    rec2 = {"phase": "train-run", "run": 2, "resume": last, "returncode": run2.returncode,
            "wall_s": wall2, "peak_mem_gib": child.get("peak_mem_gib"),
            "epochs": [(e, loss) for e, loss, _ in epochs2],
            "s_per_epoch_from_log": [b[2] - a[2] for a, b in zip(epochs2, epochs2[1:])],
            "s_per_epoch_from_metrics": [b - a for a, b in zip(ends, ends[1:])],
            "final_epoch": final.get("epoch"), "final_steps": final.get("steps"),
            "writing_left": writing, "writing_beside_a_saved_path": stale,
            "flash_launches": flash,
            "stderr_tail": run2.stderr[-600:]}
    emit(rec2)
    check(run2.returncode == 0, f"train-run 2: exit {run2.returncode}: {run2.stderr[-2000:]}")
    check("resuming from epoch        1 of" in log2,
          "train-run 2: no 'resuming from epoch        1' line")
    check(metric is not None and f"recovering best_loss {metric:4f}" in log2,
          f"train-run 2: best_loss not recovered as {metric}")
    check([e for e, _, _ in epochs2] == [1, 2], f"train-run 2: epochs {rec2['epochs']}")
    check(final.get("epoch") == 2 and final.get("steps") == RUN_EPOCHS * NATIVE_TRAIN // 16,
          f"train-run 2: lastepoch.ckpt epoch {final.get('epoch')} steps {final.get('steps')}")
    check(not stale and set(writing) <= set(killed),
          f"train-run 2: temp files left {writing} (beside a path it saved: {stale})")
    check(child and flash == {"flash_fwd": 6 * RUN_VAL_BATCHES * len(epochs2)},
          f"train-run 2: flash launches {flash} (child {child})")
    return work, run_dir


#: the cli phase: sample's rows and stride; fid's samples and batch (fid-trend
#: takes CLI_TREND_N a point); the scope keys attrib-report must reproduce
CLI_SAMPLE_N, CLI_SAMPLE_K = 8, 20
CLI_FID_N, CLI_BATCH, CLI_TREND_N = 32, 8, 16
CLI_ATTRIB_KEYS = ("self_s", "total_s", "events", "share_of_busy")


def _cli_call(fa, quant, argv: list, base: str) -> dict:
    """``__main__.main(argv)`` in this process with the launch counters
    zeroed just before and read just after: rc, wall, stdout's last JSON
    line (if any) and the counts."""
    import contextlib
    import io

    from ddim_cold_torch import __main__ as cli

    _zero([fa.LAUNCHES, quant.LAUNCHES])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, base_dir=base)
    wall = time.perf_counter() - t0
    last = None
    for line in out.getvalue().splitlines():
        if line.startswith("{"):
            last = json.loads(line)
    return {"rc": rc, "wall_s": wall, "json": last, "stdout": out.getvalue(),
            "launches": _counts(fa, quant)}


def phase_cli(torch, fa, quant, run_dir: str, data_root: str, serve_report: dict) -> dict:
    """The commands users start, at full width on the card. ``sample``
    (``oxford_flower_200_p4``, ``--init-random``, 8 samples at k=20) as a
    child process in a temporary working directory: the parent rebuilds the
    seeded model and decodes ``samples.png``, each tile bit for bit
    ``to_uint8`` of the parent's direct ``ddim_sample`` from generator seed
    1 (float32, dense: no flash launch); its img/s from the two PNGs' write
    times. In process through ``__main__.main``: ``edit`` (a 200 px draft
    and two interpolation ends from the synthetic folder, 4 cold samples:
    four PNGs, 7 cold levels, the draft tile exact); ``fid`` cold and ddim
    k=20, ``fid-trend`` (points random and best) and ``publish`` on
    train-run's finished run directory (bf16, the YAML's ``use_flash``):
    flash_fwd launched exactly depth × forwards × batches, JAX's JSON keys,
    finite values (``publish`` whole where matplotlib imports, else its
    ``render_samples``); ``attrib-report`` on the profile phase's serve
    capture, its scope rows equal to that capture's attrib line;
    ``obs-report --from-jsonl`` on the span dump of one traced batch.
    Returns each flash path's counts for the kernels line."""
    import tempfile

    import numpy as np

    from ddim_cold_torch import serve
    from ddim_cold_torch.cli import edit, sample
    from ddim_cold_torch.models import MODEL_CONFIGS
    from ddim_cold_torch.obs import spans
    from ddim_cold_torch.ops import sampling, schedule
    from ddim_cold_torch.utils import image
    from ddim_cold_torch.utils.run_io import load_run_template

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    rec: dict = {"phase": "cli"}
    paths: dict = {}
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # sample: a child process, as a user starts it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = ["sample", "--config", MODEL, "--init-random", "--sample_n", str(CLI_SAMPLE_N),
            "--acc_k", str(CLI_SAMPLE_K)]
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "ddim_cold_torch"] + argv, cwd=work,
                           capture_output=True, text=True, timeout=300, env=env)
    wall = time.perf_counter() - t0
    saved = os.path.join(work, "Saved_Models")
    seq_png, smp_png = (os.path.join(saved, n) for n in ("denoise_sequence.png", "samples.png"))
    model = sample.build_model(MODEL, None, True, 0, work, torch.device("cuda"))
    _zero([fa.LAUNCHES, quant.LAUNCHES])
    want = sampling.ddim_sample(model, torch.Generator(device="cuda").manual_seed(1),
                                n=CLI_SAMPLE_N, k=CLI_SAMPLE_K, device="cuda")
    direct_launches = _counts(fa, quant)
    want = image.to_uint8(want.cpu().numpy())
    nrows, ncols = image.grid_shape(CLI_SAMPLE_N)
    tiles = (image.grid_tiles(smp_png, CLI_SAMPLE_N, nrows=nrows, ncols=ncols)
             if os.path.isfile(smp_png) else None)
    sampling_s = (os.path.getmtime(smp_png) - os.path.getmtime(seq_png)
                  if tiles is not None and os.path.isfile(seq_png) else None)
    rec["sample"] = {"command": "python -m ddim_cold_torch " + " ".join(argv),
                     "rc": child.returncode, "wall_s": wall,
                     "samples_s_from_png_times": sampling_s,
                     "img_per_s": CLI_SAMPLE_N / sampling_s if sampling_s else None,
                     "tiles_bitwise": tiles is not None and np.array_equal(tiles, want),
                     "flash_launches_direct": direct_launches["flash_fwd"],
                     "route": "float32 dense (ViT.py's model)",
                     "stderr_tail": child.stderr[-600:]}
    check(child.returncode == 0, f"cli sample: exit {child.returncode}: {child.stderr[-2000:]}")
    check(rec["sample"]["tiles_bitwise"], "cli sample: samples.png tiles are not the "
          "direct ddim_sample's")
    check(direct_launches["flash_fwd"] == 0, f"cli sample: {direct_launches} on the dense route")
    del model

    # edit, in process
    val = os.path.join(data_root, "val")
    names = sorted(os.listdir(val))
    draft, ends = os.path.join(val, names[0]), [os.path.join(val, n) for n in names[1:3]]
    got = _cli_call(fa, quant, ["edit", "--config", MODEL, "--init-random", "--cold-n", "4",
                                "--draft", draft, "--interpolate"] + ends, work)
    pngs = {n: os.path.isfile(os.path.join(saved, n)) for n in (
        "cold_sequence.png", "cold_samples.png", "draft2img.png", "interpolation.png")}
    side = MODEL_CONFIGS[MODEL]["img_size"][0]
    levels = int(math.log2(side))
    seq_ok = draft_ok = False
    if all(pngs.values()):
        from PIL import Image

        w = Image.open(os.path.join(saved, "cold_sequence.png")).size
        seq_ok = w == ((levels + 1) * side + levels * 2, 4 * side + 3 * 2)
        x = edit.img2tensor(draft, (side, side))
        draft_ok = np.array_equal(
            image.grid_tiles(os.path.join(saved, "draft2img.png"), 1, nrows=2, ncols=5)[0],
            image.to_uint8(((x[0] + 1) / 2).numpy()))
    rec["edit"] = {"rc": got["rc"], "wall_s": got["wall_s"], "pngs": pngs,
                   "cold_sequence_levels": levels if seq_ok else None,
                   "draft_tile_exact": draft_ok, "flash_launches": got["launches"]["flash_fwd"]}
    check(got["rc"] == 0 and all(pngs.values()), f"cli edit: {rec['edit']}")
    check(seq_ok and draft_ok, f"cli edit: cold sequence / draft tile {rec['edit']}")

    # fid, fid-trend, publish on train-run's run directory: the flash path
    config, run_model, _ = load_run_template(run_dir, "cuda")
    depth = run_model.depth
    cold_fwd = len(schedule.cold_time_sequence(int(math.log2(config.image_size[0]))))
    ddim_fwd = len(schedule.ddim_time_sequence(run_model.total_steps, CLI_SAMPLE_K))
    del run_model
    n_real = min(len(names), 2048)
    batches = -(-CLI_FID_N // CLI_BATCH)
    keys = {"metric", "value", "n_samples", "n_real", "extractor", "run"}
    for sampler, fwd in (("cold", cold_fwd), ("ddim", ddim_fwd)):
        got = _cli_call(fa, quant, ["fid", run_dir, "--n-samples", str(CLI_FID_N), "--batch",
                                    str(CLI_BATCH), "--n-real", str(n_real), "--sampler",
                                    sampler, "--k", str(CLI_SAMPLE_K)], work)
        want_n = depth * fwd * batches
        out = got["json"] or {}
        rec[f"fid {sampler}"] = {"rc": got["rc"], "wall_s": got["wall_s"], "json": out,
                                 "launches": got["launches"], "expected_flash_fwd": want_n}
        paths[f"cli fid {sampler}"] = got["launches"]
        check(got["rc"] == 0 and set(out) == keys and np.isfinite(out.get("value", np.nan))
              and out.get("n_real") == (n_real // CLI_BATCH) * CLI_BATCH,
              f"cli fid {sampler}: {rec[f'fid {sampler}']}")
        check(got["launches"]["flash_fwd"] == want_n and sum(got["launches"].values()) == want_n,
              f"cli fid {sampler}: launches {got['launches']}, flash_fwd {want_n} expected")
    got = _cli_call(fa, quant, ["fid-trend", run_dir, "--n-samples", str(CLI_TREND_N),
                                "--batch", str(CLI_BATCH), "--n-real", str(n_real)], work)
    out = got["json"] or {}
    points = [p.get("ckpt") for p in out.get("points", [])]
    want_n = depth * cold_fwd * (-(-CLI_TREND_N // CLI_BATCH)) * len(points)
    rec["fid-trend"] = {"rc": got["rc"], "wall_s": got["wall_s"], "points": out.get("points"),
                        "launches": got["launches"], "expected_flash_fwd": want_n}
    paths["cli fid-trend"] = got["launches"]
    check(got["rc"] == 0 and points == ["random", "best"]
          and all(np.isfinite(p["fid"]) for p in out["points"]),
          f"cli fid-trend: {rec['fid-trend']}")
    check(got["launches"]["flash_fwd"] == want_n and sum(got["launches"].values()) == want_n,
          f"cli fid-trend: launches {got['launches']}, flash_fwd {want_n} expected")
    try:
        import matplotlib  # noqa: F401 — the whole command needs it for val_curve.png
        whole = True
    except ImportError:
        whole = False
    if whole:
        got = _cli_call(fa, quant, ["publish", run_dir], work)
    else:
        from ddim_cold_torch.cli.publish_run import render_samples

        _zero([fa.LAUNCHES, quant.LAUNCHES])
        t0 = time.perf_counter()
        out_dir = os.path.join(work, "results", os.path.basename(run_dir))
        os.makedirs(out_dir, exist_ok=True)
        render_samples(run_dir, out_dir)
        got = {"rc": 0, "wall_s": time.perf_counter() - t0, "launches": _counts(fa, quant)}
    want_n = depth * cold_fwd * 2  # 16 samples, then the 4-row sequence
    out_dir = os.path.join(work, "results", os.path.basename(run_dir))
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    rec["publish"] = {"whole_command": whole, "rc": got["rc"], "wall_s": got["wall_s"],
                      "files": files, "launches": got["launches"],
                      "expected_flash_fwd": want_n}
    paths["cli publish"] = got["launches"]
    need = {"samples.png", "cold_sequence.png"} | (
        {"val_curve.png", "summary.json", "train.log"} if whole else set())
    check(got["rc"] == 0 and need <= set(files), f"cli publish: {rec['publish']}")
    check(got["launches"]["flash_fwd"] == want_n and sum(got["launches"].values()) == want_n,
          f"cli publish: launches {got['launches']}, flash_fwd {want_n} expected")

    # attrib-report on the serve capture
    kind = torch.cuda.get_device_name(0)
    report_path = os.path.join(work, "attrib.json")
    got = _cli_call(fa, quant, ["attrib-report", os.path.join(TRACE_DIR, "serve"),
                                "--device-kind", kind, "--json", report_path], work)
    cli_rows = []
    if got["rc"] == 0:
        with open(report_path) as f:
            rows = json.load(f)["scopes"]
        from ddim_cold_torch.obs import attrib

        cli_rows = [(n, [rows[n][k] for k in CLI_ATTRIB_KEYS])
                    for n, _ in attrib.ranked_scopes({"scopes": rows})]
    line_rows = [(n, [node[k] for k in CLI_ATTRIB_KEYS])
                 for n, node in sorted(serve_report["scopes"].items(),
                                       key=lambda kv: -kv[1]["self_s"])]
    rec["attrib-report"] = {"rc": got["rc"], "wall_s": got["wall_s"],
                            "rows": len(cli_rows), "rows_equal": cli_rows == line_rows}
    check(got["rc"] == 0 and cli_rows and cli_rows == line_rows,
          f"cli attrib-report: rows {cli_rows} against the attrib line's {line_rows}")
    shutil.rmtree(os.path.join(TRACE_DIR, "serve"), ignore_errors=True)

    # obs-report on the span dump of one traced batch
    model = sample.build_model(MODEL, None, True, 0, work, torch.device("cuda"))
    eng = serve.Engine(model, buckets=(CLI_BATCH,))
    cfg = serve.SamplerConfig(k=500)
    serve.warmup(eng, [cfg])
    spans.clear()
    with spans.tracing():
        ticket = eng.submit(seed=0, n=CLI_BATCH, config=cfg)
        eng.run()
    ticket.result(timeout=600)
    dump = os.path.join(work, "spans.jsonl")
    rows = spans.export_jsonl(dump)
    spans.clear()
    chrome = os.path.join(work, "trace.json")
    got = _cli_call(fa, quant, ["obs-report", "--from-jsonl", dump, "--chrome", chrome], work)
    events = json.load(open(chrome))["traceEvents"] if os.path.isfile(chrome) else []
    rec["obs-report"] = {"rc": got["rc"], "wall_s": got["wall_s"], "spans": len(rows),
                         "events": len(events),
                         "summary_head": got["stdout"].splitlines()[:1]}
    check(got["rc"] == 0 and rows and len(events) == len(rows)
          and got["stdout"].startswith(f"{len(rows)} span(s) across 1 trace(s)"),
          f"cli obs-report: {rec['obs-report']}")
    del eng, model
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


#: the two-rank layouts of dist-train: (name, mesh, sp_mode); dist-sample
#: runs the data and seq ones (the samplers take no model or pipe mesh)
DIST_LAYOUTS = (("data", {"data": 2}, None), ("ulysses", {"seq": 2}, "ulysses"),
                ("ring", {"seq": 2}, "ring"), ("tp", {"model": 2}, None),
                ("pipe", {"pipe": 2}, None), ("expert", {"expert": 2}, None),
                ("data-n2", {"data": 2}, None))
#: layouts whose step runs several optimizer steps a call (steps_per_dispatch)
DIST_DISPATCH = {"data-n2": 2}
DIST_SAMPLE_LAYOUTS = DIST_LAYOUTS[:3]
#: dist-train-4: the layouts of a second world, of four gloo ranks on the card
DIST4_LAYOUTS = (("pipe-tp", {"pipe": 2, "model": 2}, None),
                 ("ulysses-tp", {"seq": 2, "model": 2}, "ulysses"),
                 ("ulysses-ep", {"seq": 2, "expert": 2}, "ulysses"))
#: the dist-train layouts of the Switch-MoE model (the moe phase's E = 4,
#: stepping with its aux weight), each expert rank holding 2 experts a bank
DIST_MOE = {"expert": MOE, "ulysses-ep": MOE}
#: microbatches a pipelined layout splits its B=16 rows into
DIST_MICROBATCHES = {"pipe": 4, "pipe-tp": 4}
DIST_WARM, DIST_STEPS = 1, 3
DIST4_STEPS = 2
#: dist-train's limits against the one-process step: both sides run the same
#: kernels, so each is about ten times the largest difference of a sound
#: two-rank run on an H100 (loss 4.5e-5, gradient norm 1.6e-4, update
#: 0.042 relative); a gradient share counted twice or not averaged moves the
#: norm by 1. The update's largest element gap stays MAX_UPDATE_GAP_LR a
#: step: Adam's first update is lr·sign(g), so one element whose gradient
#: is near 0 may flip by 2·lr in any sound run.
DIST_TRAIN_TOL = {"loss": 5e-4, "grad_norm": 2e-3, "upd_rel": 0.4}
#: dist-sample: rows, and the largest |Δ| allowed against the one-process
#: ddim_sample in float32: about ten times a sound run's largest (0 on
#: {data: 2} and Ulysses, 6e-7 for the ring's f32 online softmax against
#: the f32 flash kernel), under the ~1/2501 a padding key left unmasked
#: would weigh
DIST_SAMPLE_N, DIST_SAMPLE_TOL = 8, 6e-6
#: dist-serve: (label, SamplerConfig kwargs, kernels one layer-forward
#: launches on a rank). The data-mesh configs run k=20 (100 forwards); the
#: sp configs k=100 (20 forwards), since their exchanges stage through the
#: host under gloo (a k=20 Ulysses call took 26.87 s in dist-sample)
DIST_SERVE_SP_K = 100
#: the token configs' live tokens: serve-cache's ⌈(N+1)/TOKEN_SHARE⌉ at 200_p4
DIST_SERVE_TOKENS = 626
DIST_SERVE = (
    ("float {data: 2}", dict(k=K), {"flash_fwd": 1}),
    ("pallas {data: 2}", dict(k=K, quant="pallas"), {"flash_fwd": 1, "dequant_mm": 4}),
    ("pallas fused {data: 2}", dict(k=K, quant="pallas", fused=True),
     {"fused_trunk": 1, "mlp_fused": 1}),
    ("w8a8 {data: 2}", dict(k=K, quant="w8a8"), {"flash_fwd": 1}),
    ("w8a8 fused {data: 2}", dict(k=K, quant="w8a8", fused=True),
     {"fused_trunk": 1, "mlp_fused": 1}),
    ("ulysses sp2", dict(k=DIST_SERVE_SP_K, sp_mode="ulysses", sp_degree=2),
     {"flash_fwd": 1}),
    ("ring sp2", dict(k=DIST_SERVE_SP_K, sp_mode="ring", sp_degree=2), {}),
    ("ulysses sp2 full i2", dict(k=DIST_SERVE_SP_K, sp_mode="ulysses", sp_degree=2,
                                 cache_interval=2, cache_mode="full"), {"flash_fwd": 1}),
    # under sp the fused attention is gated off: qkv and proj run as
    # dequant_mm around the Ulysses exchange, the Mlp as one kernel
    ("ulysses sp2 pallas fused", dict(k=DIST_SERVE_SP_K, sp_mode="ulysses", sp_degree=2,
                                      quant="pallas", fused=True),
     {"mlp_fused": 1, "dequant_mm": 2, "flash_fwd": 1}),
    # the token cache under sp: 10 refresh steps at 2501 tokens, 10 reuse
    # steps at the 626 live ones (one global selection, the trunk's blocks
    # of 313 tokens a rank)
    ("ulysses sp2 token", dict(k=DIST_SERVE_SP_K, sp_mode="ulysses", sp_degree=2,
                               cache_interval=2, cache_mode="token",
                               cache_tokens=DIST_SERVE_TOKENS), {"flash_fwd": 1}),
    ("ring sp2 token", dict(k=DIST_SERVE_SP_K, sp_mode="ring", sp_degree=2,
                            cache_interval=2, cache_mode="token",
                            cache_tokens=DIST_SERVE_TOKENS), {}),
)
#: dist-serve: each flash_fwd shape a rank launches per config where the
#: shape is the point (Ulysses runs a rank's 2 heads over the whole
#: sequence: 2501 tokens at a refresh, the 626 live ones at a reuse)
DIST_SERVE_SHAPES = {"ulysses sp2 token": {"(8, 2501, 2, 64)": 60, "(8, 626, 2, 64)": 60},
                     "ring sp2 token": {}}
#: dist-serve: the largest |Δ| allowed against the one-process twin at the
#: same bucket and start, DIST_SAMPLE_TOL for every config (~10× the ring's
#: reading): on an H100 a sound run read 0 for each but the ring (4.8e-7),
#: the quant ones included (each row runs the same kernels at the same shape
#: on both sides, w8a8 takes the whole batch's activation scale, and the
#: fused w8a8 Mlp runs the whole row tiles of the one-process call that a
#: rank's rows touch, so each tile's requant is the one-process one), while
#: the w8a8 config with the scale taken per rank read 1.1e-2 and followers
#: sampling zeros in place of the broadcast batch 0.88
DIST_SERVE_TOL = {label: DIST_SAMPLE_TOL for label, _, _ in DIST_SERVE}
#: the collectives parallel/ runs: the ring rotates with all_to_all_single
#: (point to point is not needed), the head's outputs are all_gather'ed,
#: the gradients all_reduce'd, rank 0's parameters broadcast
DIST_OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all_single")
#: dist-fleet: (label, SamplerConfig kwargs, kernels one layer-forward
#: launches on a rank) of the replicas across the two ranks, at one bucket
#: of FLEET_MESH_BUCKET rows (3 real); the sp config's request is the one
#: the fault hedges
DIST_FLEET = (
    ("float", dict(k=K), {"flash_fwd": 1}),
    ("ulysses sp2", dict(k=DIST_SERVE_SP_K, sp_mode="ulysses", sp_degree=2),
     {"flash_fwd": 1}),
    ("pallas fused", dict(k=K, quant="pallas", fused=True),
     {"fused_trunk": 1, "mlp_fused": 1}),
)
FLEET_MESH_BUCKET, FLEET_MESH_ROWS = 4, 3
#: JAX's sp failover test's fault: r0's first assembly fails, once
FLEET_MESH_FAULT = dict(site="serve.assemble", kind="transient", rate=1.0,
                        match="replica:r0|", max_fires=1)
#: dist-probe-sp: the f32 200_p4 probe on {seq: 2} at B=2 (a layer's weights
#: are 200 MB of f32 a rank), its layers, and the control: the last layer's
#: weights against the one-process probe of layer 1
PROBE_SP_N, PROBE_SP_LAYERS, PROBE_SP_CONTROL = 2, (0, -1), 1
#: the largest |Δ| allowed between the sp probe and the one-process one: a
#: sound run on an H100 read 0.0 at both layers (the same kernels, f32, the
#: q and k blocks gathered), so the limit is ten float32 spacings at 1, the
#: largest weight; the control (layer −1 against layer 1) read 3.8e-4
PROBE_SP_TOL = 1.2e-6


def phase_dist_probe(torch, gloo: list) -> None:
    """Which collectives gloo carries on CUDA tensors at this torch: ``gloo``,
    the two ranks' answers (probed first in dist-train's world), then point
    to point in a world of its own (a rank it kills must not take the other
    phases with it); then NCCL at world 1 in this process."""
    import torch.distributed as dist

    from ddim_cold_torch.parallel import mesh as pmesh
    from ddim_cold_torch.tools import dist_cases as dc

    t0 = time.perf_counter()
    try:
        p2p = dc.run_world([("probe", {"ops": dc.PROBE_OPS[-1:]})], 2, device="cuda",
                           backend="gloo", timeout_s=60)[0][0]["batch_isend_irecv"]
    except dc.RankError as e:
        p2p = f"a rank died: {str(e).strip()[:300]}"
    pmesh.initialize_distributed(init_method=f"tcp://localhost:{pmesh.free_port()}",
                                 world_size=1, rank=0, device="cuda")
    try:
        nccl = dc.probe(torch.device("cuda"))
    finally:
        dist.destroy_process_group()
    rec = {"phase": "dist-probe", "torch": torch.__version__,
           "gloo_cuda_two_ranks": {**gloo[0], "batch_isend_irecv": p2p},
           "ranks_agree": gloo[0] == gloo[1], "nccl_world_1": nccl,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    for op in DIST_OPS:
        check(gloo[0].get(op) == "ok" and gloo[1].get(op) == "ok",
              f"dist-probe: gloo on CUDA tensors, {op}: {gloo[0].get(op)}")
    check(nccl.get("backend") == "nccl" and all(nccl[op] == "ok" for op in dc.PROBE_OPS),
          f"dist-probe: NCCL at world 1 {nccl}")


def phase_dist(torch, MODEL_CONFIGS):
    """dist-probe, dist-train and dist-sample: one world of two gloo ranks
    on the one card (NCCL refuses two ranks on one device), CUDA tensors,
    first probes the collectives (the dist-probe phase). dist-train:
    the bf16 200_p4 model, every drop rate 0, B=16 a step, 1 + 3 steps on
    each layout of ``DIST_LAYOUTS`` (tensor- and pipeline-parallel ones
    built as the trainer builds them), every step held to the one-process
    step on the same batches within ``DIST_TRAIN_TOL`` (the update's
    largest gap within the train check's, scaled by the steps taken),
    launches exact, ms/step and peak memory a rank reported (two ranks
    share the card: no speed is claimed), the pipe layout's gathered
    checkpoint read back into a one-process model, a traced step of each
    sequence-parallel layout attributed to its ``sp/`` scopes. dist-sample:
    the float32 model, ``ddim_sample`` at k=20 over 8 rows on each layout
    of ``DIST_SAMPLE_LAYOUTS`` against the one-process call on the same
    start. Then dist-serve, dist-probe-sp and dist-fleet in the same world
    (:func:`phase_dist_serve`, :func:`phase_dist_probe_sp`,
    :func:`phase_dist_fleet`)."""
    import tempfile

    from ddim_cold_torch.tools import dist_cases as dc

    cfg = dict(MODEL_CONFIGS[MODEL], use_flash=True, seed=SEED, drop_rate=0.0,
               attn_drop_rate=0.0, drop_path_rate=0.0)
    lr = 0.005 * 16 / 512
    trace_dir = os.path.join(TRACE_DIR, "dist")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_ckpt_")
    t0 = time.perf_counter()
    gloo, train, sample, served, probed, fleet = dc.run_world(
        [("probe", {"ops": dc.PROBE_OPS[:-1]}),
         ("card_train", dict(layouts=DIST_LAYOUTS, model_cfg=dict(cfg, dtype=torch.bfloat16),
                             warm=DIST_WARM, steps=DIST_STEPS, batch=16, seed=SEED + 5,
                             lr=lr, total_steps=TRAIN_TOTAL_STEPS, trace_dir=trace_dir,
                             microbatches=DIST_MICROBATCHES, checkpoint_dir=ckpt_dir,
                             model_extra=DIST_MOE, moe_aux_weight=MOE_AUX_WEIGHT,
                             dispatch=DIST_DISPATCH)),
         ("card_sample", dict(layouts=DIST_SAMPLE_LAYOUTS, model_cfg=cfg, n=DIST_SAMPLE_N,
                              k=K, seed=SEED + 6)),
         dist_serve_case(cfg),
         ("card_probe", dict(model_cfg=cfg, n=PROBE_SP_N, layers=PROBE_SP_LAYERS,
                             control=PROBE_SP_CONTROL, seed=SEED + 9)),
         # last: it creates and destroys the groups of three replicas
         ("card_fleet", dict(model_cfg=cfg, bucket=FLEET_MESH_BUCKET,
                             configs=[c for _, c, _ in DIST_FLEET], fault=FLEET_MESH_FAULT,
                             fault_config=1, seed=SEED + 10, rows=FLEET_MESH_ROWS))],
        2, device="cuda", backend="gloo", timeout_s=1000)
    shutil.rmtree(trace_dir, ignore_errors=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    phase_dist_probe(torch, gloo)
    depth = MODEL_CONFIGS[MODEL]["depth"]
    launches = {}
    for name, spec, mode in DIST_LAYOUTS:
        check_dist_train(name, spec, mode, train, depth, DIST_STEPS, lr, wall)
        r0 = train[0][name]
        if name == "pipe":
            cp = r0.get("checkpoint") or {}
            emit({"phase": "dist-train", "layout": name, "checkpoint": cp,
                  "tol_max_gap_lr": MAX_UPDATE_GAP_LR * (DIST_WARM + DIST_STEPS)})
            check(bool(cp) and cp["keys"] == cp["one_process_keys"]
                  and cp["max_gap_lr"] <= MAX_UPDATE_GAP_LR * (DIST_WARM + DIST_STEPS),
                  f"dist-train pipe: the gathered checkpoint against one process {cp}")
        if mode is not None:
            scopes = r0.get("attrib", {})
            emit({"phase": "attrib", "capture": f"dist-train {name} step (rank 0)",
                  "coverage": r0.get("attrib_coverage"), "scopes": scopes})
            names = (("sp/ring_exchange",) if mode == "ring"
                     else ("sp/all_to_all_gather", "sp/all_to_all_scatter"))
            for scope in names:
                check(scopes.get(scope, {}).get("events", 0) > 0,
                      f"dist-train {name}: no device work under {scope} ({scopes})")
        launches[f"dist-train {name} (a rank)"] = r0["launches"]
    for name, spec, mode in DIST_SAMPLE_LAYOUTS:
        r0, r1 = sample[0][name], sample[1][name]
        rec = {"phase": "dist-sample", "layout": name, "mesh": spec, "sp_mode": r0["sp_mode"],
               "model": MODEL, "dtype": "float32", "rows": DIST_SAMPLE_N, "k": K,
               "wall_s": [r0["wall_s"], r1["wall_s"]],
               "launches": [r0["launches"], r1["launches"]],
               "max_abs_err": r0["max_abs_err"], "tol": DIST_SAMPLE_TOL,
               "shape": r0["shape"], "finite": r0["finite"],
               "in_unit_range": r0["in_unit_range"]}
        emit(rec)
        check(r0["sp_mode"] == mode, f"dist-sample {name}: sp_mode {r0['sp_mode']}")
        check(r0["shape"] == [DIST_SAMPLE_N, 200, 200, 3] and r0["finite"]
              and r0["in_unit_range"], f"dist-sample {name}: {rec}")
        check(r0["max_abs_err"] <= DIST_SAMPLE_TOL,
              f"dist-sample {name}: |Δ| {r0['max_abs_err']} over {DIST_SAMPLE_TOL}")
        want = 0 if mode == "ring" else depth * 2000 // K
        check(r0["launches"] == want and r1["launches"] == want,
              f"dist-sample {name}: flash_fwd {rec['launches']}, expected {want}")
        launches[f"dist-sample {name} (a rank)"] = {"flash_fwd": r0["launches"]}
    launches.update(phase_dist_serve(served, MODEL_CONFIGS[MODEL]))
    launches.update(phase_dist_probe_sp(probed, depth))
    launches.update(phase_dist_fleet(fleet, depth))
    return launches


def phase_dist_probe_sp(ranks: list, depth: int) -> dict:
    """dist-probe-sp's checks: on each rank the whole (B, H, N+1, N+1)
    weights of every probed layer within ``PROBE_SP_TOL`` of the
    one-process probe, rows summing to 1, the control above the limit,
    and the sequence-parallel call's launches: flash_fwd once a block
    before the probed layer (Ulysses, a rank's heads), none for the probed
    layer's dense weights. Returns each layer's launches on a rank."""
    out = {}
    for rank, res in enumerate(ranks):
        for layer, rec in res["layers"].items():
            before = layer % depth
            emit({"phase": "dist-probe-sp", "rank": rank, "layer": layer, "model": MODEL,
                  "dtype": "float32", "rows": PROBE_SP_N, "sp_mode": res["sp_mode"],
                  **rec, "tol": PROBE_SP_TOL,
                  "speed": "two ranks share one card: no speed claimed"})
            check(rec["shape"] == [PROBE_SP_N, 4, 2501, 2501],
                  f"dist-probe-sp rank {rank} layer {layer}: shape {rec['shape']}")
            check(rec["max_abs_err"] <= PROBE_SP_TOL and rec["row_sum_err"] <= 1e-3,
                  f"dist-probe-sp rank {rank} layer {layer}: |Δ| {rec['max_abs_err']}, "
                  f"row sums {rec['row_sum_err']}")
            if "control_err" in rec:
                check(rec["control_err"] > PROBE_SP_TOL,
                      f"dist-probe-sp rank {rank}: the control {rec['control_err']} "
                      f"is not above {PROBE_SP_TOL}")
            check(rec["launches"]["flash_fwd"] == before
                  and sum(rec["launches"].values()) == before,
                  f"dist-probe-sp rank {rank} layer {layer}: launches {rec['launches']}")
            if rank == 0:
                out[f"dist-probe-sp layer {layer} (a rank)"] = rec["launches"]
    return out


def phase_dist_fleet(ranks: list, depth: int) -> dict:
    """dist-fleet's checks on the two ranks' results of ``card_fleet``:
    every row within ``DIST_SERVE_TOL`` of its config's one-process call at
    its dispatch shape; the fault realized once and the sp ticket hedged
    (r0 → r1); r0 retired and its replacement spawned and warmed on both
    ranks; each rank's launches, from after the initial warmups to the
    drain, exactly depth × forwards × the config's kernels for each served
    batch and for the replacement's warmup; zero programs after warmup on
    every replica of both ranks; the follower's batches per replica rank
    0's dispatches; no fleet thread and no group left on either rank.
    Returns the launches on a rank."""
    from ddim_cold_torch.serve import SamplerConfig

    r0, r1 = ranks
    want = {}
    for _, kw, per_layer in DIST_FLEET:
        layers = depth * _forwards(SamplerConfig(**kw), 2000)
        for name, n in per_layer.items():  # two served batches + r2's warmup
            want[name] = want.get(name, 0) + 3 * n * layers
    want = {name: want.get(name, 0) for name in r0["launches"]}
    follow = r1["follow"]
    served = r0["served"]
    lat = sorted(rec["latency_s"] for rec in served)
    emit({"phase": "dist-fleet", "model": MODEL, "dtype": "float32",
          "bucket": FLEET_MESH_BUCKET, "rows": FLEET_MESH_ROWS,
          "configs": [label for label, _, _ in DIST_FLEET],
          "warmup_s": r0["warmup_s"], "serve_s": r0["serve_s"], "wall_s": r0["wall_s"],
          "img_per_sec": FLEET_MESH_ROWS * len(served) / r0["serve_s"],
          "p50_s": lat[len(lat) // 2], "latency_s": [rec["latency_s"] for rec in served],
          "hedges": r0["hedges"], "replaced": r0["replaced"],
          "retired_before_drain": r0["retired"], "health": r0["health"],
          "launches": [r0["launches"], r1["launches"]], "expected": want,
          "warm_launches_follower": r1["warm_launches"],
          "follower_order": follow["order"],
          "groups": [[r["groups_before"], r["groups_after"]] for r in ranks],
          "threads_after": [r0["threads_after"], r1["threads_after"]],
          "speed": "two ranks share one card: no speed claimed",
          "backend": "gloo (two ranks, one card)"})
    for rec in served:
        label = DIST_FLEET[rec["config"]][0]
        emit({"phase": "dist-fleet", "config": label, **rec, "tol": DIST_SERVE_TOL})
        check(rec["error"] is None and rec["shape"] == [FLEET_MESH_ROWS, 200, 200, 3]
              and rec["finite"] and rec["in_unit_range"], f"dist-fleet {label}: {rec}")
        err = rec.get("max_abs_err", math.inf)
        check(err <= DIST_SERVE_TOL["float {data: 2}"],
              f"dist-fleet {label}: |Δ| {err} over {DIST_SERVE_TOL['float {data: 2}']}")
    check(r0["hedges"] == 1 and [rec["realized"] for rec in served[:3]] == [0, 1, 0],
          f"dist-fleet: hedges {r0['hedges']}, faults {[r['realized'] for r in served]}")
    h = r0["health"]
    check(r0["replaced"] and r0["retired"] == 1 and h["replicas_spawned"] == 3
          and h["failed"] == 0, f"dist-fleet: replacement {h}, retired {r0['retired']}")
    check([tuple(o) for o in follow["order"]] == [
        ("spawn", "r0"), ("warm", "r0"), ("spawn", "r1"), ("warm", "r1"), ("close", "r0"),
        ("spawn", "r2"), ("warm", "r2"), ("close", "r1"), ("close", "r2"), ("stop", "")],
          f"dist-fleet: the follower's lifecycle {follow['order']}")
    check(h["programs_after_warmup"] == 0
          and all(rep["error"] is None and rep["follow"]["new_programs"] == 0
                  and rep["follow"]["failed_batches"] == 0
                  for rep in follow["replicas"].values()),
          f"dist-fleet: programs after warmup or follower errors {follow['replicas']}")
    check({rid: rep["follow"]["batches"] for rid, rep in follow["replicas"].items()}
          == h["dispatches"], f"dist-fleet: follower batches against {h['dispatches']}")
    check(r0["launches"] == want and r1["launches"] == want,
          f"dist-fleet: launches {r0['launches']}, {r1['launches']}; expected {want}")
    for rank, r in enumerate(ranks):
        check(r["groups_after"] == r["groups_before"] and r["threads_after"] == [],
              f"dist-fleet rank {rank}: groups {r['groups_before']} -> "
              f"{r['groups_after']}, threads {r['threads_after']}")
    return {"dist-fleet (a rank)": r0["launches"]}


def dist_train_launches(name: str, spec: dict, mode, depth: int, steps: int) -> int:
    """Each flash kernel's launches a rank over ``steps`` training steps:
    one a block a microbatch the rank's stage runs (a tensor-parallel rank
    on its own heads, Ulysses on its heads' share); the ring none."""
    if mode == "ring":
        return 0
    pipe = spec.get("pipe", 1)
    micro = DIST_MICROBATCHES.get(name, 2 * pipe) if pipe > 1 else 1
    return depth // pipe * micro * steps


def check_dist_train(name: str, spec: dict, mode, train: list, depth: int, steps: int,
                     lr: float, wall: float) -> None:
    """Emit and check one dist-train layout's record: every rank's launches
    exact (:func:`dist_train_launches`), every rank's whole parameters
    after the steps rank 0's, each step's loss, ‖g‖ and update
    against the one-process step within ``DIST_TRAIN_TOL`` and the update's
    largest gap within ``MAX_UPDATE_GAP_LR`` a step. A layout of
    ``DIST_DISPATCH`` runs n steps a call: n times the launches, and each
    record (a call) held to the twin's n steps."""
    tol = DIST_TRAIN_TOL
    per_call = DIST_DISPATCH.get(name, 1)
    ranks = [r[name] for r in train]
    r0 = ranks[0]
    emit({"phase": "dist-train", "layout": name, "mesh": spec, "sp_mode": mode,
          "model": MODEL, "dtype": "bfloat16", "batch": 16, "lr": lr,
          "microbatches": DIST_MICROBATCHES.get(name),
          "backend": f"gloo ({len(ranks)} ranks, one card)", "warmup_steps": DIST_WARM,
          "steps": steps, "steps_per_dispatch": per_call,
          "ms_per_step": [[ms / per_call for ms in r["ms_per_step"]] for r in ranks],
          "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
          "local_params": [r["local_params"] for r in ranks],
          "local_moments": [r["local_moments"] for r in ranks],
          "launches": [r["launches"] for r in ranks], "per_step": r0["per_step"],
          "tol": tol, "tol_max_param_gap_lr_a_step": MAX_UPDATE_GAP_LR,
          "speed": "ranks share one card: no speed claimed", "world_s": wall})
    want = dist_train_launches(name, spec, mode, depth, steps) * per_call
    for rank, r in enumerate(ranks):
        check(all(n == want for n in r["launches"].values()),
              f"dist-train {name} rank {rank}: launches {r['launches']}, expected {want} each")
        # every rank applied the same update: its whole parameters, gathered,
        # are rank 0's bit for bit (a replica left behind shows here)
        check(r["param_sums"] == r0["param_sums"],
              f"dist-train {name} rank {rank}: parameters differ from rank 0's")
    for i, st in enumerate(r0["per_step"]):
        rel = {"loss": abs(st["loss"] - st["loss_one_process"]) / abs(st["loss_one_process"]),
               "grad_norm": abs(st["grad_norm"] - st["grad_norm_one_process"])
               / st["grad_norm_one_process"], "upd_rel": st["upd_rel"]}
        for key, val in rel.items():
            check(math.isfinite(val) and val <= tol[key],
                  f"dist-train {name} step {i}: {key} {val} over {tol[key]}")
        check(st["max_param_gap_lr"] <= MAX_UPDATE_GAP_LR * (i + 1) * per_call,
              f"dist-train {name} step {i}: param gap {st['max_param_gap_lr']} lr")


def phase_dist4(torch, MODEL_CONFIGS) -> dict:
    """dist-train-4: a world of four gloo ranks on the one card, CUDA
    tensors, the bf16 200_p4 model at every drop rate 0 on ``{pipe: 2,
    model: 2}`` (4 microbatches) and Ulysses ``{seq: 2, model: 2}``, 1 + 2
    steps of B=16 each held to the one-process step as dist-train's, every
    rank's launches exact. Returns each layout's launches on rank 0."""
    from ddim_cold_torch.tools import dist_cases as dc

    cfg = dict(MODEL_CONFIGS[MODEL], use_flash=True, seed=SEED, drop_rate=0.0,
               attn_drop_rate=0.0, drop_path_rate=0.0, dtype=torch.bfloat16)
    lr = 0.005 * 16 / 512
    t0 = time.perf_counter()
    (train,) = dc.run_world(
        [("card_train", dict(layouts=DIST4_LAYOUTS, model_cfg=cfg, warm=DIST_WARM,
                             steps=DIST4_STEPS, batch=16, seed=SEED + 8, lr=lr,
                             total_steps=TRAIN_TOTAL_STEPS,
                             microbatches=DIST_MICROBATCHES, model_extra=DIST_MOE,
                             moe_aux_weight=MOE_AUX_WEIGHT))],
        4, device="cuda", backend="gloo", timeout_s=500)
    wall = time.perf_counter() - t0
    depth = MODEL_CONFIGS[MODEL]["depth"]
    out = {}
    for name, spec, mode in DIST4_LAYOUTS:
        check_dist_train(name, spec, mode, train, depth, DIST4_STEPS, lr, wall)
        out[f"dist-train-4 {name} (a rank)"] = train[0][name]["launches"]
    return out


def dist_serve_case(cfg: dict) -> tuple:
    """dist-serve's rank case: the float32 200_p4 model of dist-sample."""
    return ("card_serve", dict(model_cfg=cfg, bucket=DIST_SAMPLE_N,
                               configs=[c for _, c, _ in DIST_SERVE], seed=SEED + 7))


def phase_dist_serve(ranks: list, model_cfg: dict) -> dict:
    """dist-serve's checks on the two ranks' results of ``dist_serve_case``:
    per config the rows against the one-process twin within
    ``DIST_SERVE_TOL``, each rank's launches exactly the config's
    layer-forwards times its ``DIST_SERVE`` kernels, shapes, finite, in
    [0, 1]; zero programs after warmup on both ranks; rank 1's ``follow()``
    report rank 0's batches. Returns each config's launches on a rank."""
    import types

    from ddim_cold_torch.serve import SamplerConfig

    r0, r1 = ranks
    depth = model_cfg["depth"]
    geometry = types.SimpleNamespace(depth=depth, total_steps=2000,
                                     num_patches=(200 // model_cfg["patch_size"]) ** 2)
    follow = r1["follow"]
    emit({"phase": "dist-serve", "model": MODEL, "dtype": "float32", "bucket": DIST_SAMPLE_N,
          "warmup_s": [r0["warmup_s"], r1["warmup_s"]], "sp_meshes": r0["sp_meshes"],
          "programs_after_warmup": [r0["programs_after_warmup"],
                                    r1["programs_after_warmup"]],
          "follow": follow, "backend": "gloo (two ranks, one card)"})
    check(r0["programs_after_warmup"] == 0 and r1["programs_after_warmup"] == 0
          and follow["new_programs"] == 0,
          f"dist-serve: programs after warmup {r0['programs_after_warmup']}, "
          f"{r1['programs_after_warmup']}")
    check(follow["batches"] == r0["stats"]["dispatches"] == len(DIST_SERVE)
          and follow["failed_batches"] == 0 and follow["programs"] == r0["stats"]["programs"],
          f"dist-serve: follow() {follow} against rank 0's {r0['stats']}")
    check(r0["sp_meshes"] == {2: {"data": 1, "seq": 2}},
          f"dist-serve: sp meshes {r0['sp_meshes']}")
    runs = {r["config"]: r["launches"] for r in r1["runs"]}
    shape_runs = {r["config"]: r["flash_shapes"] for r in r1["runs"]}
    out = {}
    for i, ((label, kw, per_layer), rec) in enumerate(zip(DIST_SERVE, r0["served"])):
        config = SamplerConfig(**kw)
        layers = (_cache_plan(geometry, config)[2] if config.cached
                  else depth * _forwards(config, 2000))
        want = {name: per_layer.get(name, 0) * layers for name in rec["launches"]}
        tol = DIST_SERVE_TOL[label]
        emit({"phase": "dist-serve", "config": label, "sp_mode": rec["sp_mode"],
              "k": config.k, "rows": [3, 5], "wall_s": rec["wall_s"],
              "img_per_sec": rec["img_per_sec"], "p50_s": rec["p50_s"],
              "speed": "two ranks share one card: no speed claimed",
              "launches": [rec["launches"], runs.get(i)], "expected": want,
              "max_abs_err": rec["max_abs_err"], "tol": tol})
        check(rec["batches"] == 1 and rec["failed_tickets"] == 0
              and rec["shapes"] == [[3, 200, 200, 3], [5, 200, 200, 3]]
              and rec["finite"] and rec["in_unit_range"], f"dist-serve {label}: {rec}")
        check(rec["max_abs_err"] <= tol,
              f"dist-serve {label}: |Δ| {rec['max_abs_err']} over {tol}")
        check(rec["launches"] == want and runs.get(i) == want,
              f"dist-serve {label}: launches {rec['launches']}, {runs.get(i)}; "
              f"expected {want}")
        if label in DIST_SERVE_SHAPES:
            shapes = [rec["flash_shapes"], shape_runs.get(i)]
            emit({"phase": "dist-serve", "config": label, "flash_shapes": shapes})
            check(all(s == DIST_SERVE_SHAPES[label] for s in shapes),
                  f"dist-serve {label}: flash_fwd shapes {shapes}, expected "
                  f"{DIST_SERVE_SHAPES[label]}")
        if config.sp_degree > 1:
            mode = "ring" if config.sp_mode == "ring" else "ulysses"
            check(rec["sp_mode"] == mode, f"dist-serve {label}: sp_mode {rec['sp_mode']}")
        out[f"dist-serve {label} (a rank)"] = rec["launches"]
    return out


def _dist_yaml(data_root: str, **keys) -> str:
    """``20220822_200px.yaml``'s keys on the synthetic folder, one epoch, no
    warm start or snapshots, and ``keys``."""
    here = os.path.dirname(os.path.abspath(__file__))
    lines = []
    with open(os.path.join(here, "20220822_200px.yaml")) as f:
        for line in f:
            key = line.split(":", 1)[0].strip()
            if key in ("snapshot_epochs", "initializing", *keys):
                continue
            if key == "dataStorage":
                line = (f"dataStorage : [{json.dumps(os.path.join(data_root, 'train'))}, "
                        f"{json.dumps(os.path.join(data_root, 'val'))}]\n")
            elif key == "epoch":
                line = "epoch : [0,1]\n"
            lines.append(line)
    return "".join(lines) + "".join(f"{k} : {json.dumps(v)}\n" for k, v in keys.items())


def phase_dist_cli(torch, data_root: str):
    """``python -m ddim_cold_torch train`` as three children at once on
    train-run's images: ``mesh: {data: 1, seq: 1}, sp_mode: ulysses`` (an
    NCCL world of one, one epoch: the log's process-group line, the epoch
    line, loadable checkpoints, and the flash kernels launched by its
    training through Ulysses and its evaluation, exactly); ``num_gpus: 2``
    (clamped to the one card with JAX's log line, trains the epoch); and
    ``mesh: {data: 2}`` (JAX's error, no training)."""
    import tempfile

    from ddim_cold_torch.utils import checkpoint as ckpt

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    runs = {"mesh": dict(mesh={"data": 1, "seq": 1}, sp_mode="ulysses"),
            "clamp": dict(num_gpus=2), "too-big": dict(mesh={"data": 2})}
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_cli_")
    procs = {}
    t0 = time.perf_counter()
    for name, keys in runs.items():
        with open(os.path.join(work, f"{name}.yaml"), "w") as f:
            f.write(_dist_yaml(data_root, **keys))
        procs[name] = subprocess.Popen([sys.executable, "-c", RESUME_CHILD, name], cwd=work,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True, env=env)
    done = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=400)
        child = {}
        for line in out.splitlines():
            if line.startswith('{"child"'):
                child = json.loads(line)["child"]
        done[name] = (proc.returncode, child, err, time.perf_counter() - t0)
    steps = NATIVE_TRAIN // 16
    depth = 6
    recs = {}
    for name, (rc, child, err, wall) in done.items():
        run_dir = os.path.join(work, "Saved_Models", name + "flower200_diffusion")
        log_path = os.path.join(run_dir, "train.log")
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        last = os.path.join(run_dir, "lastepoch.ckpt")
        final = ckpt.load_checkpoint(last) if os.path.isfile(last) else {}
        best = os.path.join(run_dir, "bestloss.ckpt")
        recs[name] = rec = {
            "phase": "dist-cli", "run": name, "keys": runs[name], "returncode": rc,
            "wall_s": wall, "epochs": [(e, loss) for e, loss, _ in _epoch_lines(log)],
            "log_lines": [ln for ln in log.splitlines()
                          if ln.startswith(("process group", "requested"))],
            "lastepoch": (final.get("epoch"), final.get("steps")),
            "bestloss_loads": os.path.isfile(best) and bool(ckpt.load_checkpoint(best)),
            "launches": {k: n for k, n in child.get("launches", {}).items() if n},
            "peak_mem_gib": child.get("peak_mem_gib"), "stderr_tail": err[-400:]}
        emit(rec)
    m = recs["mesh"]
    check(m["returncode"] == 0, f"dist-cli mesh: exit {m['returncode']}: {m['stderr_tail']}")
    check(m["log_lines"] == ["process group: nccl, 1 ranks, mesh {'data': 1, 'seq': 1}, "
                             "sp_mode ulysses"], f"dist-cli mesh: {m['log_lines']}")
    check([e for e, _ in m["epochs"]] == [0] and m["lastepoch"] == (0, steps)
          and m["bestloss_loads"], f"dist-cli mesh: epochs {m['epochs']}, "
          f"lastepoch {m['lastepoch']}, bestloss loads {m['bestloss_loads']}")
    want = {"flash_fwd": depth * (steps + RUN_VAL_BATCHES), "flash_bwd_dq": depth * steps,
            "flash_bwd_dkv": depth * steps}
    check(m["launches"] == want, f"dist-cli mesh: launches {m['launches']}, expected {want}")
    c = recs["clamp"]
    check(c["returncode"] == 0 and c["log_lines"] == [
        "requested 2 devices, only 1 visible — clamping"] and c["lastepoch"] == (0, steps),
        f"dist-cli clamp: {c}")
    b = recs["too-big"]
    check(b["returncode"] not in (0, None)
          and "config.mesh {'data': 2} needs 2 devices, only 1 visible" in b["stderr_tail"]
          and not b["epochs"], f"dist-cli too-big: {b}")
    shutil.rmtree(work, ignore_errors=True)
    return {"dist-cli mesh": m["launches"]}


def phase_probe_xla(torch, fa):
    """The model's two oracles at 200_p4 with bf16 weights: the attention
    probe of the flash model against the dense model's at layers 0, 2 and
    −1 (B=2; layer 0 bit for bit, later layers within PROBE_TV of
    total-variation per row; every row summing to 1 within 1e-3; two
    controls above PROBE_TV: the dense model's layer 1 against its layer 2,
    and the flash model's layer −1 on other images), and the
    blockwise route (``use_flash="xla"``) at B=8 against the flash model
    within ``phase_forward``'s limit, with no kernel launched; the xla
    route's time beside the flash forward's (the plain route's time, not a
    yardstick)."""
    from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT

    cfg = MODEL_CONFIGS[MODEL]
    models = {route: DiffusionViT(**cfg, dtype=torch.bfloat16, use_flash=route, seed=SEED)
              for route in (True, False, "xla")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    H, W = cfg["img_size"]
    x = torch.randn((8, H, W, 3), generator=gen, device="cuda")
    t = torch.randint(0, 2000, (8,), generator=gen, device="cuda")
    probes = {}
    with torch.inference_mode():
        for layer in (0, 2, -1):
            a = models[True](x[:2], t[:2], return_attention_layer=layer)
            b = models[False](x[:2], t[:2], return_attention_layer=layer)
            tv = 0.5 * (a.float() - b.float()).abs().sum(-1).max().item()
            rows = (a.float().sum(-1) - 1).abs().max().item()
            probes[str(layer)] = {"shape": list(a.shape), "bitwise": torch.equal(a, b),
                                  "max_row_tv": tv, "max_row_sum_err": rows}
        controls = {
            "dense layer 1 vs layer 2": (models[False](x[:2], t[:2], return_attention_layer=1),
                                         models[False](x[:2], t[:2], return_attention_layer=2)),
            "flash layer -1, other images": (
                models[True](x[2:4], t[2:4], return_attention_layer=-1),
                models[False](x[:2], t[:2], return_attention_layer=-1))}
        controls = {k: 0.5 * (a.float() - b.float()).abs().sum(-1).max().item()
                    for k, (a, b) in controls.items()}
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        out_xla = models["xla"](x, t)
        torch.cuda.synchronize()
        xla_launches = {k: n for k, n in fa.LAUNCHES.items() if n}
        out_flash = models[True](x, t)
        err = (out_xla - out_flash).abs().max().item()
        xla_ms = time_ms(torch, lambda: models["xla"](x, t), reps=5, warm=1)
        flash_ms = time_ms(torch, lambda: models[True](x, t), reps=5, warm=1)
    rec = {"phase": "probe-xla", "model": MODEL, "dtype": "bfloat16", "probe_batch": 2,
           "probes": probes, "probe_tv_limit": PROBE_TV, "control_max_row_tv": controls,
           "xla_batch": 8,
           "xla_block_kv": 512, "max_abs_err_xla_vs_flash": err,
           "tol": FWD_TOL["bfloat16"], "xla_launches": xla_launches,
           "xla_ms": xla_ms, "flash_ms": flash_ms}
    emit(rec)
    N = (H // cfg["patch_size"]) * (W // cfg["patch_size"]) + 1
    for layer, p in probes.items():
        check(p["shape"] == [2, cfg["num_heads"], N, N], f"probe {layer} shape {p['shape']}")
        check(p["max_row_sum_err"] <= 1e-3, f"probe {layer} rows sum off by "
                                            f"{p['max_row_sum_err']}")
        check(p["bitwise"] if layer == "0" else p["max_row_tv"] <= PROBE_TV,
              f"probe {layer}: {p}")
    for name, tv in controls.items():
        check(tv > PROBE_TV, f"probe control {name}: row TV {tv} within {PROBE_TV}")
    check(math.isfinite(err) and err <= FWD_TOL["bfloat16"],
          f"xla route vs flash forward: {err}")
    check(not xla_launches, f"xla route launched {xla_launches}")
    del models
    torch.cuda.empty_cache()


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


#: tuning: timed launches a candidate after the warm one
TUNING_ITERS = 10


def phase_tuning(torch, qk) -> None:
    """tuning: ``ops/tuning.py``'s sweeps on the card at 200_p4 B=8 (M =
    20,008 rows) in bfloat16 w8a8, the fused attention's ``block_q`` and
    the fused Mlp's ``block_m``: every candidate's device ms, max |Δ| to its
    plain version at the same block (the sweeps raise past
    ``quant.trunk_error_limit``) and shared bytes; the static pick in the
    space and equal to the model's default; the default block's time beside
    the kernel phase's w8a16 (the table's rows 1 and 2) and w8a8 times. No
    pick is committed: the table stays empty."""
    from ddim_cold_torch.models import MODEL_CONFIGS
    from ddim_cold_torch.ops import tuning

    cfg = MODEL_CONFIGS[MODEL]
    n = (cfg["img_size"][0] // cfg["patch_size"]) * (cfg["img_size"][1] // cfg["patch_size"]) + 1
    c, h, rows = cfg["embed_dim"], cfg["num_heads"], 8
    t0 = time.perf_counter()
    sweeps = (
        ("fused_trunk", "block_q",
         tuning.autotune_attn(rows, n, c, h, torch.bfloat16, mode="w8a8",
                              iters=TUNING_ITERS),
         tuning.pick_attn(n, c, h, torch.int8, compute_dtype=torch.bfloat16)[0],
         tuning.attn_blocks(n, c, h, torch.int8, device="cuda")[0]),
        ("mlp_fused", "block_m",
         tuning.autotune_mlp(rows * n, c, c, torch.bfloat16, mode="w8a8",
                             iters=TUNING_ITERS),
         tuning.pick_mlp(rows * n, c, c, c, torch.int8, compute_dtype=torch.bfloat16),
         tuning.mlp_block_m(c, c, torch.int8, device="cuda")))
    for kernel, key, recs, pick, default in sweeps:
        for r in recs:
            emit({"phase": "tuning", "kernel": kernel, "model": MODEL, "rows": rows,
                  "dtype": "bfloat16", "mode": "w8a8", key: r[key], "ms": r["ms"],
                  "max_abs_err": r["max_abs_err"],
                  "max_err_over_limit": r["max_err_over_limit"],
                  "smem_bytes": r["smem_bytes"]})
            check(r["within_limit"], f"tuning {kernel} {key}={r[key]} over its limit")
        blocks = sorted(r[key] for r in recs)
        at_default = [r["ms"] for r in recs if r[key] == default]
        emit({"phase": "tuning", "kernel": kernel, "candidates": blocks,
              "fastest_first": [r[key] for r in recs], "static_pick": pick,
              "default": default, "default_ms": at_default[0] if at_default else None,
              "kernel_phase_ms": {m: qk[(kernel, "200_p4", "bfloat16", m)]["ms"]
                                  for m in ("pallas", "w8a8")},
              "device_kind": tuning._local_device_kind("cuda"),
              "committed_rows": len(tuning.TUNED_BLOCKS)})
        check(pick in blocks and pick == default,
              f"tuning {kernel}: static pick {pick} not the default {default} in {blocks}")
    check(not tuning.TUNED_BLOCKS, f"tuning: rows committed {tuning.TUNED_BLOCKS}")
    emit({"phase": "tuning", "seconds": time.perf_counter() - t0})


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
    """One more batch of a quantized or fused config traced by
    ``utils/profiling.trace``: device time by kernel and the device's idle
    share; each of the config's kernels (``per_layer``: launches a
    layer-forward) launched exactly depth × steps times that; then the
    trace attributed to the port's scopes."""
    from ddim_cold_torch.utils import profiling

    ticket = eng.submit(seed=SEED + 8, n=8, config=config)
    log_dir = os.path.join(TRACE_DIR, f"quant-{config.quant}-{config.fused}")
    with profiling.trace(log_dir) as prof:
        t0 = time.perf_counter()
        report = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticket.result(timeout=900)
    kinds = {k: [] for k in QUANT_KERNELS + ("gemm", "other")}
    for e in _device_spans(prof):
        kinds[_kind_of(e.name, QUANT_KERNELS)].append((e.time_range.start, e.time_range.end))
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
    forwards = steps * (report["rows"] + report["padded_rows"])
    attribute_capture(torch, prof, log_dir, f"serve {rec['config']}",
                      serve_scope_costs(model, forwards, config.quant, config.fused),
                      {name: n * model.depth * steps for name, n in per_layer.items()},
                      rec["idle_share"], floor=True)


def _moe_forward(model, x, t):
    """``model``'s forward and its banks' routing statistics."""
    records = []
    out = model(x, t, losses=records)
    return out, records


def phase_moe(torch, fa, serve, DiffusionViT, MODEL_CONFIGS, serve_report) -> dict:
    """The Switch-MoE model family at full width (200_p4, E = 4, cf 1.25,
    both dispatches): (1) the float32 forward at B=8 on the card against the
    port's CPU forward on the same weights, einsum against index on the
    card (TF32 off), each block's dropped-token share; (2) an ``Engine``
    over the bf16 einsum model serving 8 one-row requests at k=20 in one
    batch: flash_fwd depth × 100, every row bit for bit the direct
    ``ddim_sample`` at the bucket shape, no program after warmup, img/s and
    p50 beside the float serve phase's; (3) bf16 training at B=16, every
    drop rate 0, ``moe_aux_weight`` 0.01, 2 warm-up and 5 timed steps per
    dispatch: loss and aux finite, each flash kernel depth a step, ms/step
    and peak memory. Returns each path's launches."""
    from ddim_cold_torch.models import moe
    from ddim_cold_torch.ops import degrade, quant, sampling
    from ddim_cold_torch.serve.batching import plan_batches
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = dict(MODEL_CONFIGS[MODEL], use_flash=True, seed=SEED, **MOE)
    depth = cfg["depth"]
    n_tok = (cfg["img_size"][0] // cfg["patch_size"]) ** 2 + 1
    launches: dict = {}

    # (1) forward: card against CPU, einsum against index
    gen = torch.Generator().manual_seed(SEED + 20)
    H, W = cfg["img_size"]
    x = torch.randn((MOE_FWD_BATCH, H, W, 3), generator=gen)
    t = torch.randint(0, 2000, (MOE_FWD_BATCH,), generator=gen)
    card = {d: DiffusionViT(**cfg, moe_dispatch=d) for d in moe.DISPATCHES}
    out, stats = {}, {}
    with torch.inference_mode():
        for d, m in card.items():
            _zero((fa.LAUNCHES, quant.LAUNCHES))
            out[d], stats[d] = _moe_forward(m, x.cuda(), t.cuda())
            torch.cuda.synchronize()
            launches[f"moe forward {d}"] = _counts(fa, quant)
        cpu = DiffusionViT(**cfg, moe_dispatch="index", device="cpu")
        cpu.load_state_dict(card["einsum"].state_dict(), strict=True)
        t0 = time.perf_counter()
        ref, ref_stats = _moe_forward(cpu, x, t)
        cpu_s = time.perf_counter() - t0
    del cpu
    err = float((out["einsum"].cpu() - ref).abs().max())
    gap = float((out["einsum"] - out["index"]).abs().max())
    same_routing = all(
        torch.equal(a.routed.cpu(), b.routed) and torch.equal(a.kept.cpu(), b.kept)
        for a, b in zip(stats["einsum"], ref_stats))
    dropped = [1.0 - float(s.kept.sum() / s.count) for s in stats["einsum"]]
    rec = {"phase": "moe", "part": "forward", "model": MODEL, **MOE,
           "capacity": moe.capacity(n_tok, MOE["moe_capacity_factor"], MOE["num_experts"]),
           "dtype": "float32", "batch": MOE_FWD_BATCH, "max_abs_err_card_vs_cpu": err,
           "tol": MOE_FWD_TOL, "routing_equal_card_vs_cpu": same_routing,
           "max_abs_einsum_vs_index": gap, "dropped_share_by_block": dropped,
           "tokens_by_expert_by_block": [s.routed.tolist() for s in stats["einsum"]],
           "aux": float(moe.mean_load_balance(stats["einsum"])),
           "cpu_forward_s": cpu_s, "launches": launches["moe forward einsum"]}
    emit(rec)
    check(all(o.shape == (MOE_FWD_BATCH, H, W, 3) and bool(torch.isfinite(o).all())
              for o in out.values()), "moe forward: shape and finite")
    check(same_routing, "moe forward: the card routes otherwise than the CPU")
    check(err <= MOE_FWD_TOL, f"moe forward: card vs CPU {err} over {MOE_FWD_TOL}")
    check(gap <= MOE_FWD_TOL, f"moe forward: einsum vs index {gap} over {MOE_FWD_TOL}")
    for d in moe.DISPATCHES:
        check(launches[f"moe forward {d}"].get("flash_fwd") == depth
              and sum(launches[f"moe forward {d}"].values()) == depth,
              f"moe forward {d}: launches {launches[f'moe forward {d}']}")
    del card, out, ref
    torch.cuda.empty_cache()

    # (2) serving
    model = DiffusionViT(**cfg, dtype=torch.bfloat16)
    eng = serve.Engine(model, buckets=(MOE_SERVE_N,))
    config = serve.SamplerConfig(k=K)
    serve.warmup(eng, [config])
    programs = eng.stats["programs"]
    reqs = tuple((300 + i, 1) for i in range(MOE_SERVE_N))
    _zero((fa.LAUNCHES, quant.LAUNCHES))                   # main path starts here
    tickets = {s: eng.submit(seed=s, n=n, config=config) for s, n in reqs}
    report = eng.run()
    torch.cuda.synchronize()
    served = _counts(fa, quant)           # ... and ends here
    launches["moe serve"] = served
    pending = [serve.Request(config=config, n=n, key=s, ticket=tickets[s]) for s, n in reqs]
    bitwise = _rows_bitwise(torch, model, sampling, reqs,
                            plan_batches(pending, (MOE_SERVE_N,)))
    expected = depth * len(range(model.total_steps - 1, 0, -K))
    rec = {"phase": "moe", "part": "serve", "model": MODEL, **MOE, "dtype": "bfloat16",
           "moe_dispatch": "einsum", "k": K, "requests": len(reqs),
           "batches": report["batches"], "wall_s": report["wall_s"],
           "img_per_sec": report["img_per_sec"], "p50_latency_s": report["latency"]["p50_s"],
           "float_serve_img_per_sec": serve_report["img_per_sec"],
           "float_serve_p50_latency_s": serve_report["latency"]["p50_s"],
           "programs_after_warmup": eng.stats["programs"] - programs,
           "launches": served, "expected_flash_fwd": expected,
           "rows_bitwise": sum(bitwise.values())}
    emit(rec)
    check(report["batches"] == 1 and report["failed_tickets"] == 0,
          f"moe serve: {report['batches']} batches, {report['failed_tickets']} failed")
    check(served.get("flash_fwd") == expected and sum(served.values()) == expected,
          f"moe serve: launches {served}, expected flash_fwd {expected}")
    check(rec["programs_after_warmup"] == 0, "moe serve: a program after warmup")
    check(rec["rows_bitwise"] == len(reqs), f"moe serve: bitwise rows {bitwise}")
    del eng, model
    torch.cuda.empty_cache()

    # (3) training, each dispatch
    prepare = degrade.make_cold_prepare(200, max_step=7, chain=True)
    host = _cold_batches(MOE_TRAIN_WARM + MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, SEED + 21)
    lr = 0.005 * MOE_TRAIN_BATCH / 512
    for d in moe.DISPATCHES:
        model = DiffusionViT(**cfg, moe_dispatch=d, dtype=torch.bfloat16, drop_rate=0.0,
                             attn_drop_rate=0.0, drop_path_rate=0.0)
        state = create_train_state(model, lr, TRAIN_TOTAL_STEPS)
        step = make_train_step(model, prepare=prepare, moe_aux_weight=MOE_AUX_WEIGHT)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rec_loss = torch.tensor(5.0, device="cuda")
        state, _, rec_loss = _run_steps(torch, step, state, host[:MOE_TRAIN_WARM], gen,
                                        rec_loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero((fa.LAUNCHES, quant.LAUNCHES))               # main path starts here
        t0 = time.perf_counter()
        state, loss, rec_loss = _run_steps(torch, step, state, host[MOE_TRAIN_WARM:], gen,
                                           rec_loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trained = _counts(fa, quant)      # ... and ends here
        launches[f"moe train {d}"] = trained
        peak = torch.cuda.max_memory_allocated() / 2**30
        base, tt = host[-1]
        with torch.inference_mode():
            noisy, _, tt = prepare((torch.from_numpy(base).cuda(), torch.from_numpy(tt).cuda()),
                                   gen)
            _, records = _moe_forward(model, noisy, tt)
        aux = float(moe.mean_load_balance(records))
        rec = {"phase": "moe", "part": "train", "model": MODEL, **MOE, "moe_dispatch": d,
               "dtype": "bfloat16", "batch": MOE_TRAIN_BATCH, "lr": lr,
               "moe_aux_weight": MOE_AUX_WEIGHT, "warmup_steps": MOE_TRAIN_WARM,
               "steps": MOE_TRAIN_STEPS, "ms_per_step": wall / MOE_TRAIN_STEPS * 1e3,
               "img_per_sec": MOE_TRAIN_BATCH * MOE_TRAIN_STEPS / wall,
               "peak_mem_gib": peak, "final_loss": loss.item(), "aux": aux,
               "dropped_share_by_block": [1.0 - float(s.kept.sum() / s.count)
                                          for s in records],
               "launches": trained}
        emit(rec)
        check(math.isfinite(rec["final_loss"]) and math.isfinite(aux),
              f"moe train {d}: loss {rec['final_loss']}, aux {aux}")
        want = {k: depth * MOE_TRAIN_STEPS for k in ("flash_fwd", "flash_bwd_dq",
                                                     "flash_bwd_dkv")}
        check({k: n for k, n in trained.items() if n} == want,
              f"moe train {d}: launches {trained}, expected {want}")
        del model, state, step
        torch.cuda.empty_cache()
    emit({"phase": "moe", "part": "done", "seconds": time.perf_counter() - t_phase})
    return launches


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
    phase_tuning(torch, qk)
    model = phase_forward(torch, DiffusionViT, MODEL_CONFIGS)
    eng, config, serve_launches, serve_report = phase_serve(torch, model, fa, serve)
    profile_report = phase_profile(torch, eng, config)
    gc.collect()  # what the earlier phases left to the collector is not serve-chaos's
    before = torch.cuda.memory_allocated()
    chaos_launches = phase_serve_chaos(torch, model, fa, serve, eng, config, serve_report)
    check_released(torch, "serve-chaos", before)
    del eng
    gc.collect()
    drop_cublas_workspaces(torch)
    before = torch.cuda.memory_allocated()
    fleet_launches = phase_serve_fleet(torch, model, fa, serve, MODEL_CONFIGS)
    drop_cublas_workspaces(torch)
    check_released(torch, "serve-fleet", before)
    phase_quant_forward(torch, DiffusionViT, MODEL_CONFIGS, quant)
    eng, qconfigs, quant_launches = phase_serve_quant(torch, model, fa, quant, serve)
    for config, (_, per_layer) in zip(qconfigs, SERVE_QUANT):
        phase_profile_quant(torch, eng, config, per_layer, model)
    del eng
    edit_launches = phase_serve_edit(torch, model, fa, quant, serve, DiffusionViT,
                                     MODEL_CONFIGS)
    cache_launches = phase_serve_cache(torch, model, fa, quant, serve)
    new_paths = {**phase_fid(torch, model, fa, quant, serve),
                 **phase_distill(torch, model, fa, quant, serve)}
    del model
    torch.cuda.empty_cache()
    new_paths.update(phase_moe(torch, fa, serve, DiffusionViT, MODEL_CONFIGS, serve_report))
    phase_train_check(torch, fa)
    train_model, state, step, batch, gen, train_launches = phase_train(torch, fa)
    phase_train_profile(torch, train_model, state, step, batch, gen)
    del train_model, state, step
    new_paths.update(phase_train_dispatch(torch, fa))
    phase_train_nan(torch)
    data_root, tier = phase_native(torch)
    remat_launches = phase_train_remat(torch, fa)
    run_work, run_dir = phase_train_run(torch, data_root, tier)
    new_paths.update(phase_cli(torch, fa, quant, run_dir, data_root, profile_report))
    shutil.rmtree(run_work, ignore_errors=True)
    dist_launches = phase_dist(torch, MODEL_CONFIGS)  # dist-serve's too
    dist_launches.update(phase_dist4(torch, MODEL_CONFIGS))
    dist_launches.update(phase_dist_cli(torch, data_root))
    shutil.rmtree(data_root, ignore_errors=True)
    phase_probe_xla(torch, fa)

    fwd = records[("200_p4_b16", "bfloat16")]
    lines = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ddim_cold_torch/csrc/flash_fwd.cu",
        "replaces": "ddim_cold_tpu/ops/flash_attention.py:79",
        "launches": train_launches["flash_fwd"],
        "launches_by_path": {"train": train_launches["flash_fwd"],
                             "train-remat": remat_launches["flash_fwd"],
                             "serve": serve_launches, **chaos_launches,
                             **fleet_launches,
                             **{f"serve quant={q},fused={f}": n["flash_fwd"]
                                for (q, f), n in quant_launches.items()},
                             **{f"serve-edit {label}": n["flash_fwd"]
                                for label, n in edit_launches.items() if n["flash_fwd"]},
                             **{f"serve-cache {label}": n["flash_fwd"]
                                for label, n in cache_launches.items() if n["flash_fwd"]},
                             **{label: n["flash_fwd"]
                                for label, n in new_paths.items() if n["flash_fwd"]},
                             **{label: n["flash_fwd"]
                                for label, n in dist_launches.items() if n["flash_fwd"]}},
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
                                 "train-remat": remat_launches[name],
                                 **{label: n[name] for label, n in new_paths.items()
                                    if n[name]},
                                 **{label: n[name] for label, n in dist_launches.items()
                                    if n.get(name)}},
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
        by_path.update({label: n[name] for label, n in dist_launches.items()
                        if n.get(name)})
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
