"""Diffusion schedules (numpy, host-side): the port's own copy.

Counterpart of ``ddim_cold_tpu/ops/schedule.py``, copied for the functions
the DDIM, few-step and cold samplers and the step cache use, so the port
never imports the JAX package. The tables are byte-for-byte the JAX
package's (tests pin it).

The reference's signal-level schedule is

    alpha_bar(t) = 1 - sqrt((t + 1) / T)            [+ 1e-5 on the *current* step only]

with the +1e-5 applied to ``alpha_t`` (the current noise level) but NOT to
``alpha_tk`` (the DDIM jump target). The asymmetry changes sampler outputs
and is replicated exactly. All values are computed in float64 on the host
and handed to the sampler as per-step scalars.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

#: epsilon added to the *current* alpha only (reference ViT.py:232)
ALPHA_EPS = 1e-5


def alpha_bar(t, total_steps: int, eps: float = 0.0):
    """Signal level ᾱ(t) = 1 − √((t+1)/T) + eps, on ints, floats or arrays."""
    t = np.asarray(t, dtype=np.float64)
    return 1.0 - np.sqrt((t + 1.0) / float(total_steps)) + eps


def forward_noise_alpha(t_start: int, total_steps: int) -> float:
    """ᾱ used when forward-noising an image to level ``t_start``:
    ``1 − √(t_start/T)``, with no +1 (reference ViT_draft2drawing.py:395)."""
    return 1.0 - math.sqrt(t_start / float(total_steps))


def ddim_time_sequence(total_steps: int, k: int, t_start: int | None = None) -> np.ndarray:
    """The reverse-process visit order t = t_start, t_start−k, …, > 0
    (``range(T-1, 0, -k)``, reference ViT.py:226); t_start defaults to T−1."""
    if t_start is None:
        t_start = total_steps - 1
    return np.arange(t_start, 0, -k, dtype=np.int64)


class DDIMCoefficients(NamedTuple):
    """Per-step affine coefficients of the reference's DDIM update
    ``x' = cx·x + cx0·x̂0 (+ cz·z)``, float32 arrays of shape (n_steps,),
    plus the int32 time sequence fed to the model."""

    t_seq: np.ndarray  # (n,) int32 — model conditioning step at each iteration
    cx: np.ndarray  # (n,) float32 — coefficient on the current noisy image
    cx0: np.ndarray  # (n,) float32 — coefficient on the clamped x0 prediction
    cz: np.ndarray  # (n,) float32 — σ_t on fresh noise (all-zero when eta=0)


def ddim_coefficients(total_steps: int, k: int, t_start: int | None = None,
                      eta: float = 0.0) -> DDIMCoefficients:
    """Precompute the affine DDIM-update coefficients for a k-strided schedule.

    When ``t+1−k < 0`` the argument of the target's square root is clamped to
    0 (ᾱ → 1: jump straight to the clean image). ``eta`` > 0 is the DDIM
    paper's stochastic interpolation (arXiv:2010.02502 eq. 16); η=0 keeps the
    reference's exact arithmetic and operation order.
    """
    t_seq = ddim_time_sequence(total_steps, k, t_start)
    T = float(total_steps)
    cx = np.empty(len(t_seq), dtype=np.float64)
    cx0 = np.empty(len(t_seq), dtype=np.float64)
    cz = np.zeros(len(t_seq), dtype=np.float64)
    for i, t in enumerate(t_seq):
        a_t = 1.0 - math.sqrt((t + 1.0) / T) + ALPHA_EPS
        a_tk = 1.0 - math.sqrt(max(t + 1.0 - k, 0.0) / T)
        if eta == 0.0:
            # d = √((1−a_tk)/a_tk) − √((1−a_t)/a_t)
            d = math.sqrt((1.0 - a_tk) / a_tk) - math.sqrt((1.0 - a_t) / a_t)
            s = math.sqrt(a_tk)
            # x' = s·x/√a_t + s·d·noise ;  noise = x/√(1−a_t) − √a_t/√(1−a_t)·x0
            cx[i] = s / math.sqrt(a_t) + s * d / math.sqrt(1.0 - a_t)
            cx0[i] = -s * d * math.sqrt(a_t) / math.sqrt(1.0 - a_t)
        else:
            # x' = √a_tk·x0 + √(1−a_tk−σ²)·ε + σ·z,  ε = (x−√a_t·x0)/√(1−a_t)
            sigma = eta * math.sqrt((1.0 - a_tk) / (1.0 - a_t)) * math.sqrt(
                max(1.0 - a_t / a_tk, 0.0))
            ce = math.sqrt(max(1.0 - a_tk - sigma * sigma, 0.0)) / math.sqrt(
                1.0 - a_t)
            cx[i] = ce
            cx0[i] = math.sqrt(a_tk) - ce * math.sqrt(a_t)
            cz[i] = sigma
    return DDIMCoefficients(
        t_seq=t_seq.astype(np.int32),
        cx=cx.astype(np.float32),
        cx0=cx0.astype(np.float32),
        cz=cz.astype(np.float32),
    )


def fewstep_time_sequence(total_steps: int, steps: int,
                          t_start: int | None = None) -> np.ndarray:
    """Visit order for a ``steps``-evaluation few-step sampler: the
    evenly-spaced levels t_j = round(t_start · (steps − j) / steps),
    j = 0..steps−1 (t_start defaults to T−1, the full-noise start).

    Unlike :func:`ddim_time_sequence` (a fixed stride k whose step COUNT
    falls out of T), here the step COUNT is the knob — k∈{1,2,4} distilled
    students run exactly ``steps`` model evaluations. The proportional
    construction makes halving self-consistent: every other entry of the
    2s-step sequence IS the s-step sequence (round(t·(2s−2j)/(2s)) =
    round(t·(s−j)/s)), which is what lets progressive distillation
    (:mod:`ddim_cold_torch.train.distill`) target "two teacher steps = one student step"
    without schedule drift across halvings.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if t_start is None:
        t_start = total_steps - 1
    if not 1 <= t_start < total_steps:
        raise ValueError(
            f"t_start must be in [1, {total_steps - 1}], got {t_start}")
    if t_start < steps:
        raise ValueError(
            f"t_start={t_start} < steps={steps}: the rounded levels would "
            "collide — fewer steps or a later start")
    t_seq = np.array([round(t_start * (steps - j) / steps)
                      for j in range(steps)], dtype=np.int64)
    return t_seq


def fewstep_coefficients(total_steps: int, steps: int,
                         t_start: int | None = None,
                         eta: float = 0.0) -> DDIMCoefficients:
    """Affine update coefficients along a :func:`fewstep_time_sequence`.

    Step j jumps t_j → t_{j+1} (the NEXT visited level, not t_j − k), with
    the reference's exact per-step arithmetic and ALPHA_EPS asymmetry; the
    FINAL step jumps to the clean image (ᾱ = 1), where the update
    degenerates to x' = x̂₀ identically — so its row is pinned to
    (cx, cx0, cz) = (0, 1, 0) exactly rather than computed through the
    affine form, whose algebraic cancellation (1/√a_t − 1/√a_t) is exact
    on paper but not in float. The sampler (ops/sampling.py
    ``ddim_sample_fewstep``) exploits exactly this: the last model
    evaluation runs OUTSIDE the loop as a bare forward.
    """
    t_seq = fewstep_time_sequence(total_steps, steps, t_start)
    T = float(total_steps)
    cx = np.zeros(steps, dtype=np.float64)
    cx0 = np.zeros(steps, dtype=np.float64)
    cz = np.zeros(steps, dtype=np.float64)
    for j, t in enumerate(t_seq):
        a_t = 1.0 - math.sqrt((t + 1.0) / T) + ALPHA_EPS
        if j == steps - 1:
            cx[j], cx0[j], cz[j] = 0.0, 1.0, 0.0  # jump-to-clean: x' = x̂₀
            continue
        a_tk = 1.0 - math.sqrt((t_seq[j + 1] + 1.0) / T)
        if eta == 0.0:
            d = math.sqrt((1.0 - a_tk) / a_tk) - math.sqrt((1.0 - a_t) / a_t)
            s = math.sqrt(a_tk)
            cx[j] = s / math.sqrt(a_t) + s * d / math.sqrt(1.0 - a_t)
            cx0[j] = -s * d * math.sqrt(a_t) / math.sqrt(1.0 - a_t)
        else:
            sigma = eta * math.sqrt((1.0 - a_tk) / (1.0 - a_t)) * math.sqrt(
                max(1.0 - a_t / a_tk, 0.0))
            ce = math.sqrt(max(1.0 - a_tk - sigma * sigma, 0.0)) / math.sqrt(
                1.0 - a_t)
            cx[j] = ce
            cx0[j] = math.sqrt(a_tk) - ce * math.sqrt(a_t)
            cz[j] = sigma
    return DDIMCoefficients(
        t_seq=t_seq.astype(np.int32),
        cx=cx.astype(np.float32),
        cx0=cx0.astype(np.float32),
        cz=cz.astype(np.float32),
    )


def cold_time_sequence(levels: int = 6) -> np.ndarray:
    """Cold-diffusion visit order t = levels..1 (reference ViT_draft2drawing.py:271)."""
    return np.arange(levels, 0, -1, dtype=np.int32)


#: step-cache branch ids (ops/step_cache.py): one per reverse step, computed
#: on the host like the DDIM coefficients above; the refresh/reuse pattern is
#: static, so a sampler branches on it in Python with no device sync
CACHE_REFRESH = 0  # full forward, (re)populate the block-delta cache
CACHE_REUSE_REAR = 1  # skip the REAR trunk half, apply its cached delta
CACHE_REUSE_FRONT = 2  # skip the FRONT trunk half, apply its cached delta
CACHE_REUSE_ALL = 1  # ("full" mode) skip the whole trunk, apply both deltas
CACHE_REUSE_TOKEN = 1  # ("token" mode) recompute only the top-k changed tokens


def cache_branch_sequence(n_steps: int, cache_interval: int,
                          cache_mode: str = "delta") -> np.ndarray:
    """Per-step refresh/reuse branch ids for the step-cached samplers.

    Step i refreshes iff ``i % cache_interval == 0`` (step 0 always: the
    cache starts empty); every other step reuses. ``cache_mode`` picks what
    a reuse step skips:

    * ``"delta"`` — the Δ-DiT front/rear split (arXiv:2406.01125): reuse
      steps of the early (high-noise) half skip the rear trunk half
      (CACHE_REUSE_REAR), those of the late half the front (CACHE_REUSE_FRONT);
    * ``"full"`` — reuse steps skip the whole trunk (CACHE_REUSE_ALL);
    * ``"adaptive"`` — the same array as ``"delta"``: the static worst case
      of the error-gated sampler, whose drift gate may turn a reuse step
      back into a refresh (ops/step_cache.py);
    * ``"token"`` — reuse steps recompute only the top-k changed tokens
      (CACHE_REUSE_TOKEN, JiT arXiv:2603.10744).

    ``cache_interval <= 1`` returns all-refresh (caching off; the samplers
    then bypass the cache entirely)."""
    if cache_mode not in ("delta", "full", "adaptive", "token"):
        raise ValueError(
            "cache_mode must be one of 'delta', 'full', 'adaptive', 'token', "
            f"got {cache_mode!r}")
    branch = np.zeros(n_steps, dtype=np.int32)
    if cache_interval <= 1:
        return branch
    idx = np.arange(n_steps)
    reuse = (idx % cache_interval) != 0
    if cache_mode == "full":
        branch[reuse] = CACHE_REUSE_ALL
    elif cache_mode == "token":
        branch[reuse] = CACHE_REUSE_TOKEN
    else:  # "delta" and its error-gated form "adaptive" share the pattern
        early = idx < (n_steps + 1) // 2
        branch[reuse & early] = CACHE_REUSE_REAR
        branch[reuse & ~early] = CACHE_REUSE_FRONT
    return branch
