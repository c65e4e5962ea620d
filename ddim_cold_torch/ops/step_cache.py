"""Training-free DDIM step caching: reuse transformer block deltas across
adjacent sampler steps (Δ-DiT, arXiv:2406.01125), with an error-gated and a
token-level variant (JiT, arXiv:2603.10744).

Counterpart of ``ddim_cold_tpu/ops/step_cache.py``. Adjacent reverse steps
feed the ViT nearly the same activations, so the displacement a contiguous
run of residual blocks adds to the token stream (``tokens_out −
tokens_in``, the cumulative block delta) barely moves between steps. A
*refresh* step runs the whole model and caches those deltas; a *reuse*
step skips the blocks and adds the cached delta instead
(``DiffusionViT.forward``'s hooks). Four modes:

* ``"delta"``    — reuse steps skip the rear trunk half in the early
  (high-noise) half of the schedule and the front half in the late one;
* ``"full"``     — reuse steps skip the whole trunk;
* ``"adaptive"`` — ``"delta"`` plus a drift gate: a reuse step becomes a
  refresh when ``max_rows ‖x − x_ref‖² / (‖x_ref‖² + ε)`` reaches the
  threshold, ``x_ref`` being the sampler state at the last refresh. The
  reduction is a batch max, so padding rows that replicate a real row
  (the engine pads adaptive batches so) leave it unchanged; τ = 0
  refreshes every step, τ = ∞ never fires (the static ``"delta"`` run);
* ``"token"``    — reuse steps run the trunk on the ``token_k`` most-changed
  tokens only and scatter them into the cached stream; ``token_k = N+1``
  is the plain forward.

The refresh/reuse pattern is a static host-side table
(``schedule.cache_branch_sequence``), so the static modes branch in Python
and never synchronise with the device. The adaptive gate's decision is a
device value the host must read to pick the next launches: one
synchronisation per reuse step of the static table (a static refresh step
needs none), counted in :data:`GATE_SYNCS`.

Under a mesh each process caches its own rows (:func:`shard_cache`), and a
sequence-parallel model's cache holds its own token block; the adaptive
gate's batch max then spans the data ranks.

The cache is a tuple of tensors allocated once (:func:`init_cache`) and
written in place: a refresh ``copy_``s the new deltas into it, a token
reuse scatters its live rows into it. A serving loop can therefore keep one
allocation per batch shape, and every address stays fixed across steps.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

from ddim_cold_torch.ops import schedule
from ddim_cold_torch.parallel import mesh as pmesh

#: the cache tuple, by mode:
#:   "delta"/"full": (delta_front, delta_rear), each (B, N+1, E) model dtype
#:   "adaptive":     (delta_front, delta_rear, x_ref), x_ref (B, H, W, C) f32
#:   "token":        (ref_in, trunk_delta), each (B, N+1, E) model dtype
Cache = tuple

#: denominator guard of the normalized drift (f32; far below any real
#: ‖x_ref‖² of an image-shaped state, there for the zero cache)
DRIFT_EPS = 1e-6

#: host reads of the adaptive gate's decision (one per reuse step of the
#: static table), the only device synchronisation of a cached sampler
GATE_SYNCS: collections.Counter = collections.Counter()


class CacheSpec(NamedTuple):
    """Static description of one cached-sampling run."""

    depth: int  # model trunk depth
    split: int  # front half = blocks [0, split), rear = [split, depth)
    mode: str  # "delta" | "full" | "adaptive" | "token"
    interval: int  # refresh stride (1 = caching disabled)
    branches: tuple  # per-step branch ids (static schedule)
    threshold: float = 0.0  # "adaptive": drift level that forces a refresh
    token_k: int = 0  # "token": tokens recomputed per reuse step (incl. CLS)
    n_tokens: int = 0  # "token": total tokens N+1

    @property
    def n_steps(self) -> int:
        return len(self.branches)


def enabled(cache_interval: Optional[int]) -> bool:
    """True when the interval turns caching on. ``<= 1`` is the exact
    sampler, which the callers run without the cache at all."""
    return cache_interval is not None and cache_interval > 1


def cache_spec(depth: int, n_steps: int, cache_interval: int,
               cache_mode: str = "delta",
               split: Optional[int] = None,
               threshold: Optional[float] = None,
               token_k: Optional[int] = None,
               n_tokens: Optional[int] = None) -> CacheSpec:
    """The static spec of a run of ``n_steps`` reverse steps, validated as
    the JAX package validates it.

    ``split`` defaults to ``depth // 2``; the model needs ≥ 2 blocks.
    ``cache_mode="adaptive"`` requires ``threshold`` ≥ 0;
    ``cache_mode="token"`` requires ``token_k`` in [1, n_tokens] and
    ``n_tokens`` (the model's N+1). Each knob is refused outside its mode."""
    if depth < 2:
        raise ValueError(f"step caching needs depth >= 2 blocks, got {depth}")
    if split is None:
        split = depth // 2
    if not (1 <= split < depth):
        raise ValueError(f"split {split} must lie in [1, {depth})")
    if cache_mode == "adaptive":
        if threshold is None or not (float(threshold) >= 0.0):
            raise ValueError(
                "cache_mode='adaptive' needs a drift threshold >= 0, got "
                f"{threshold!r}")
    elif threshold is not None:
        raise ValueError(
            f"threshold only applies to cache_mode='adaptive' (got mode "
            f"{cache_mode!r} with threshold {threshold!r})")
    if cache_mode == "token":
        if n_tokens is None or n_tokens < 2:
            raise ValueError(
                f"cache_mode='token' needs the model's n_tokens (N+1) >= 2, "
                f"got {n_tokens!r}")
        if token_k is None or not (1 <= token_k <= n_tokens):
            raise ValueError(
                f"cache_mode='token' needs token_k in [1, {n_tokens}], got "
                f"{token_k!r}")
    elif token_k is not None or n_tokens is not None:
        raise ValueError(
            f"token_k/n_tokens only apply to cache_mode='token' (got mode "
            f"{cache_mode!r})")
    branches = schedule.cache_branch_sequence(n_steps, cache_interval, cache_mode)
    return CacheSpec(depth=depth, split=int(split), mode=cache_mode,
                     interval=int(cache_interval),
                     branches=tuple(int(b) for b in branches),
                     threshold=float(threshold or 0.0),
                     token_k=int(token_k or 0), n_tokens=int(n_tokens or 0))


def init_cache(n: int, n_tokens: int, embed_dim: int, dtype,
               mode: str = "delta", img_shape: Optional[tuple] = None,
               device=None) -> Cache:
    """A zero cache on ``device``. Every schedule's step 0 refreshes (the
    adaptive gate too), so the zeros are never read: a cache left by an
    earlier run is as good. ``mode="adaptive"`` adds the float32 ``x_ref``
    and needs ``img_shape`` = (H, W, C)."""
    pair = tuple(torch.zeros((n, n_tokens, embed_dim), dtype=dtype, device=device)
                 for _ in range(2))
    if mode != "adaptive":
        return pair
    if img_shape is None:
        raise ValueError("init_cache(mode='adaptive') needs img_shape=(H, W, C)")
    return pair + (torch.zeros((n, *img_shape), dtype=torch.float32, device=device),)


def shard_cache(cache: Cache, mesh) -> Cache:
    """This rank's rows of ``cache`` along the mesh's ``data`` axis (the
    sample batch's placement, ``sampling.ddim_sample(mesh=)``): each process
    carries the cache of its own rows. Copies, so the whole batch's buffers
    are not kept alive."""
    if mesh is None:
        return cache
    return tuple(pmesh.shard_rows(a, mesh).clone() for a in cache)


def adaptive_gate(x: torch.Tensor, cache: Cache, branch: int, spec: CacheSpec,
                  group=None):
    """The ``"adaptive"`` error gate: the branch to take at a step whose
    static id is ``branch``. Returns ``(idx, drift)``, ``idx`` a Python int
    and ``drift`` the device scalar. A static refresh stays one without
    reading the drift (step 0's stale ``x_ref`` is never consulted); a
    reuse step reads the comparison ``drift >= threshold`` (in float32, as
    JAX compares) once, the one synchronisation, and refreshes if it holds.
    ``>=`` makes τ = 0 refresh every step. The drift is computed per row,
    ‖x − x_ref‖² / (‖x_ref‖² + ε), and reduced with max over the batch:
    with ``group`` (the data ranks of a mesh, each holding its rows) over
    the whole batch, so every rank takes the same branch."""
    x_ref = cache[2]
    dims = tuple(range(1, x_ref.ndim))
    num = (x.float() - x_ref).square().sum(dims)
    d = (num / (x_ref.square().sum(dims) + DRIFT_EPS)).max()
    if group is not None:
        d = pmesh.all_reduce_max(d, group)
    if branch == schedule.CACHE_REFRESH:
        return branch, d
    GATE_SYNCS["adaptive_gate"] += 1
    fire = bool((d >= spec.threshold).item())
    return (schedule.CACHE_REFRESH if fire else branch), d


def apply_step_tel(model, x: torch.Tensor, t_vec: torch.Tensor, branch: int,
                   cache: Cache, spec: CacheSpec, group=None):
    """:func:`apply_step` with the step's telemetry: returns ``(x0_raw,
    cache, idx, drift)``, ``idx`` the branch actually taken (after the gate
    in adaptive mode) and ``drift`` the gate's device scalar (a float32 0
    in the modes that compute none). The images are those of
    :func:`apply_step`."""
    if spec.mode == "adaptive":
        idx, d = adaptive_gate(x, cache, branch, spec, group)
    else:
        idx, d = branch, torch.zeros((), dtype=torch.float32, device=x.device)
    return (*_run_branch(model, x, t_vec, idx, cache, spec), idx, d)


def apply_step(model, x: torch.Tensor, t_vec: torch.Tensor, branch: int,
               cache: Cache, spec: CacheSpec, group=None):
    """One cache-aware model evaluation: the step's static ``branch`` (from
    ``spec.branches``), folded through the drift gate in adaptive mode
    (``group``: :func:`adaptive_gate`'s). Returns ``(x0_raw, cache)``; the
    cache is the same tuple, updated in place."""
    if spec.mode == "adaptive" and branch != schedule.CACHE_REFRESH:
        branch, _ = adaptive_gate(x, cache, branch, spec, group)
    return _run_branch(model, x, t_vec, branch, cache, spec)


def _run_branch(model, x, t_vec, branch: int, cache: Cache, spec: CacheSpec):
    """The forward of branch ``branch`` (JAX's ``lax.switch`` bodies,
    step_cache.py:237-310), writing a refresh's new cache into ``cache``."""
    depth, split = spec.depth, spec.split
    if spec.mode == "token":
        if branch == schedule.CACHE_REFRESH:
            x0, fresh = model(x, t_vec, capture_tokens=True)
            for buf, new in zip(cache, fresh):
                buf.copy_(new)
            return x0, cache
        x0, _ = model(x, t_vec, token_cache=cache, token_k=spec.token_k)
        return x0, cache
    if branch == schedule.CACHE_REFRESH:
        x0, deltas = model(x, t_vec, capture_split=split)
        for buf, new in zip(cache, deltas):
            buf.copy_(new)
        if spec.mode == "adaptive":
            cache[2].copy_(x)
        return x0, cache
    if spec.mode == "full":
        skip, delta = (0, depth), cache[0] + cache[1]
    elif branch == schedule.CACHE_REUSE_REAR:
        skip, delta = (split, depth), cache[1]
    else:  # CACHE_REUSE_FRONT
        skip, delta = (0, split), cache[0]
    return model(x, t_vec, skip_blocks=skip, block_delta=delta), cache


def blocks_run(spec: CacheSpec, branch: int) -> int:
    """How many trunk blocks a step of branch ``branch`` (as taken) runs —
    the count of each per-block kernel it launches. A token reuse runs all
    of them, at ``token_k`` tokens."""
    if branch == schedule.CACHE_REFRESH or spec.mode == "token":
        return spec.depth
    if spec.mode == "full":
        return 0
    return spec.split if branch == schedule.CACHE_REUSE_REAR else spec.depth - spec.split


def flops_saved_fraction(spec: CacheSpec) -> float:
    """Fraction of the run's BLOCK compute the schedule skips (embed, head
    and the schedule itself excluded): the analytic ceiling on the speed-up's
    compute term. For ``"adaptive"`` the gate-never-fires ceiling; for
    ``"token"`` a reuse step still runs ``token_k`` of ``n_tokens`` tokens,
    so it saves the complementary share of the linear-in-tokens cost."""
    if not spec.branches:
        return 0.0
    saved = 0.0
    for b in spec.branches:
        if b == schedule.CACHE_REFRESH:
            continue
        if spec.mode == "full":
            saved += 1.0  # the whole trunk skipped
        elif spec.mode == "token":
            saved += 1.0 - spec.token_k / spec.n_tokens
        elif b == schedule.CACHE_REUSE_REAR:
            saved += (spec.depth - spec.split) / spec.depth
        else:  # CACHE_REUSE_FRONT
            saved += spec.split / spec.depth
    return saved / len(spec.branches)
