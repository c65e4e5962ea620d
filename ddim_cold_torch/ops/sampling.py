"""Samplers: the k-strided DDIM loop, the few-step, cold and inpaint loops,
and their guided entry points.

Counterpart of the samplers of ``ddim_cold_tpu/ops/sampling.py``, uncached
and step-cached:

* ``ddim_sample``      ← reference ``sampler`` (ViT.py:220-237)
* ``ddim_sample(..., return_sequence=True)`` ← ``diffusion_sequence`` (ViT.py:239-256)
* ``cold_sample``      ← ``cold_sampler`` (ViT_draft2drawing.py:259-309)
* ``ddim_sample_fewstep`` ← the JAX package's few-step (distilled-student) sampler
* ``ddim_inpaint``     ← the JAX package's inpainting loop (``_ddim_inpaint_impl``)
* ``sample_from``      ← the draft2drawing inner loop (ViT_draft2drawing.py:394-408)
* ``slerp`` / ``interp_states`` / ``slerp_interpolate`` ← the interpolation
  app (ViT_draft2drawing.py:422-476)
* ``forward_noise``    ← ``√(1−ᾱ)·ε + √ᾱ·x`` (ViT_draft2drawing.py:395-396)

Each reverse step is affine in (x, x̂0) with coefficients precomputed on the
host (:mod:`ddim_cold_torch.ops.schedule`), so a step is one model forward,
a clamp and elementwise torch work, with no host synchronisation inside the
loop (no ``.item()``, no copies to the host; the adaptive cache's gate is
the one exception, below): the whole loop enqueues asynchronously on the
device and can later be captured in a CUDA graph. It runs under
``torch.inference_mode()``: no autograd history is recorded.

Randomness comes from explicit ``torch.Generator``s living on the sampling
device; they cannot reproduce JAX's bits, so parity with the JAX package
runs through ``x_init``. A sampler draws its fresh start from ``generator``
and the per-step noise of η > 0 from a second stream,
``fold_in(generator, NOISE_STREAM)``, as JAX folds its key.

``mesh`` (a ``DeviceMesh`` of :mod:`ddim_cold_torch.parallel`, one process
per device; ``ddim_sample``, ``ddim_sample_fewstep``, ``sample_from`` and
``cold_sample`` take it, as JAX's do, and ``ddim_inpaint``, which the
serving engine runs on a mesh): every rank takes the whole start (the
same ``generator`` seed or ``x_init`` on each), runs its rows of the mesh's
``data`` axis (a model from ``models.sp_clone`` on the mesh also splits its
tokens over ``seq``), and returns the whole batch, gathered, as JAX returns
a global array. The noise of η > 0 is drawn for the whole batch and sliced,
so no row depends on the mesh; the step cache holds the rank's rows
(``step_cache.shard_cache``), and the adaptive gate's max and a w8a8
model's per-tensor activation scale (``quant.act_scale_over``) span the
data ranks.

``cache_interval`` > 1 runs a sampler through the step cache
(:mod:`ddim_cold_torch.ops.step_cache`): each step's model evaluation takes
its branch of the static refresh/reuse table, and the cache tensors are
updated in place. The static modes add no host synchronisation; adaptive
mode reads its gate once per reuse step. The ``_*_cached_impl`` functions
take the cache as an argument and return ``(images, cache)``, so a serving
loop can hand one allocation from batch to batch; the public samplers make
a zero cache per call. ``cache_interval=1`` runs the plain loop, bit for
bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ddim_cold_torch.obs.device import StepTelemetry
from ddim_cold_torch.ops import quant, schedule, step_cache
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.utils import profiling
from ddim_cold_torch.utils.platform import resolve_device

#: the stream η > 0 draws its per-step noise from (JAX ``fold_in(rng, 0xD1F)``)
NOISE_STREAM = 0xD1F
_MASK64 = (1 << 64) - 1


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on ``generator``'s device whose seed is a function of
    ``generator``'s seed and ``data`` alone (splitmix64 of the pair), so two
    streams folded from one request seed are independent and reproducible,
    like ``jax.random.fold_in``. The given generator is not advanced."""
    z = (generator.initial_seed() * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return torch.Generator(device=generator.device).manual_seed(z ^ (z >> 31))


def _sampling_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = model.device
    if dev.type != have.type or (dev.index is not None and dev.index != have.index):
        raise ValueError(f"model lives on {have}, sampling asked for {dev}")
    return have


def as_batch(x, dev) -> torch.Tensor:
    """A private float32 copy of an (n, H, W, C) or (H, W, C) array or
    tensor on ``dev``, as a batch: the caller's array survives the call."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=dev, dtype=torch.float32, copy=True)
    else:
        x = torch.from_numpy(np.array(x, np.float32)).to(dev)
    return x[None] if x.ndim == 3 else x


def fresh_start(model, generator: Optional[torch.Generator], n: int, device,
                what: str = "ddim_sample") -> torch.Tensor:
    """A fresh N(0, 1) start of ``n`` images drawn from ``generator`` on
    ``device``: the plain, few-step and inpaint samplers' start, and the
    engine's for a seeded request (one definition for both paths)."""
    if generator is None:
        raise ValueError(f"{what} needs either generator or x_init")
    H, W = model.img_size
    return torch.randn((n, H, W, model.in_chans), generator=generator,
                       device=device, dtype=torch.float32)


class _Rows(NamedTuple):
    """This rank's rows ``[lo, lo + n_local)`` of an ``n``-row batch split
    over a mesh's ``data`` axis (``group`` None when the axis has one rank)."""

    n: int
    lo: int
    n_local: int
    group: object


def _data_rows(mesh, n: int) -> Optional[_Rows]:
    """This rank's rows of an ``n``-row batch on ``mesh`` (None: no mesh).
    The batch must divide over the data axis, as JAX's placement needs."""
    if mesh is None:
        return None
    parts = pmesh.data_axis_size(mesh)
    if n % parts:
        raise ValueError(f"batch of {n} rows does not divide over the 'data' "
                         f"axis ({parts})")
    b = n // parts
    return _Rows(n=n, lo=pmesh.axis_index(mesh, "data") * b, n_local=b,
                group=mesh.get_group("data") if parts > 1 else None)


def _take(x: torch.Tensor, rows: Optional[_Rows]) -> torch.Tensor:
    return x if rows is None else x[rows.lo:rows.lo + rows.n_local]


def _gather(out: torch.Tensor, rows: Optional[_Rows], dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``out`` (batch along ``dim``), in order."""
    if rows is None or rows.group is None:
        return out
    return pmesh.gather_cat(out, rows.group, dim)


def _noise(x: torch.Tensor, generator, rows: Optional[_Rows]) -> torch.Tensor:
    """Per-step N(0, 1) noise for ``x``: drawn for the whole batch and
    sliced to this rank's rows under a mesh."""
    shape = x.shape if rows is None else (rows.n, *x.shape[1:])
    z = torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)
    return _take(z, rows)


def _x0(model, x: torch.Tensor, t: int, group=None) -> torch.Tensor:
    """One model evaluation at level ``t``, clamped to [−1, 1]. Every
    uncached sampler's model call comes through here, under the
    ``sampler/model`` scope (the JAX samplers' ``profiling.scope`` sites);
    ``group``: the data ranks holding the batch's other rows."""
    with profiling.scope("sampler/model"), quant.act_scale_over(group):
        x0 = model(x, _t_vec(x, t))
    return x0.clamp(-1.0, 1.0)


def _t_vec(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)


def _images(x0: Optional[torch.Tensor], frames: Optional[list]) -> torch.Tensor:
    """[−1, 1] → [0, 1]: the last x̂0, or the whole trajectory."""
    if frames is not None:
        return (torch.stack(frames) + 1.0) / 2.0
    return (x0 + 1.0) / 2.0


class _Cached:
    """The x̂0 of step i through the step cache: ``spec``'s branch i, the
    cache updated in place; with ``telemetry``, each step's branch as taken
    and the gate's drift are kept (JAX's scanned ``(idx, drift)`` aux)."""

    def __init__(self, model, spec: step_cache.CacheSpec, cache, telemetry: bool = False,
                 group=None):
        self.model, self.spec, self.cache = model, spec, cache
        self.group = group  # the data ranks the adaptive gate reduces over
        self.taken = [] if telemetry else None
        self.drift = []

    def __call__(self, x: torch.Tensor, t: int, i: int) -> torch.Tensor:
        # every cached sampler's model call, under ``sampler/cached_step``
        # (JAX's cached steps, which nest no ``sampler/model`` inside)
        with profiling.scope("sampler/cached_step"), quant.act_scale_over(self.group):
            args = (self.model, x, _t_vec(x, t), self.spec.branches[i], self.cache,
                    self.spec, self.group)
            if self.taken is None:
                x0, self.cache = step_cache.apply_step(*args)
            else:
                x0, self.cache, idx, drift = step_cache.apply_step_tel(*args)
                self.taken.append(idx)
                self.drift.append(drift)
        return x0.clamp(-1.0, 1.0)

    def telemetry(self) -> StepTelemetry:
        """The run's aux: ``branch`` an int32 numpy array (the host knows
        it), ``drift`` a float32 tensor on the sampling device."""
        return StepTelemetry(branch=np.asarray(self.taken, dtype=np.int32),
                             drift=torch.stack(self.drift))


def _evaluator(model, cached: Optional[_Cached], rows: Optional[_Rows] = None):
    """The x̂0 of step i: the plain clamped forward, or the cached one
    (``rows``: x is these rows of the batch)."""
    if cached is not None:
        return cached
    group = rows and rows.group
    return lambda x, t, i: _x0(model, x, t, group)


def _ddim_loop(model, x: torch.Tensor, coeffs, noise: Optional[torch.Generator],
               sequence: bool, known=None, mask=None, cached: Optional[_Cached] = None,
               rows: Optional[_Rows] = None):
    """The affine DDIM steps of ``coeffs`` from ``x``; with ``mask``, the
    known pixels of each clamped x̂0 are re-projected from ``known`` before
    the update (``x̂0 ← m·known + (1−m)·x̂0``); with ``cached``, step i's
    x̂0 comes through the step cache; ``rows``: x is these rows of the
    batch (the noise is the batch's, sliced). Returns the last state, the
    last x̂0 (None for an empty schedule) and, with ``sequence``, the
    frames: the start, then every x̂0."""
    evaluate = _evaluator(model, cached, rows)
    frames = [x] if sequence else None
    x0 = None
    for i, (t, c1, c2, cz) in enumerate(zip(coeffs.t_seq.tolist(), coeffs.cx.tolist(),
                                            coeffs.cx0.tolist(), coeffs.cz.tolist())):
        x0 = evaluate(x, t, i)
        if mask is not None:
            x0 = mask * known + (1.0 - mask) * x0
        x_next = c1 * x + c2 * x0
        if cz:
            x_next = x_next + cz * _noise(x, noise, rows)
        x = x_next
        if sequence:
            frames.append(x0)
    return x, x0, frames


def _cached_spec(model, n_steps: int, cache_interval: int, cache_mode: str,
                 cache_threshold, cache_tokens) -> step_cache.CacheSpec:
    """The one place a sampler builds its spec: the model supplies the token
    count of ``"token"`` mode, and ``step_cache.cache_spec`` validates the
    knobs of each mode."""
    return step_cache.cache_spec(
        model.depth, n_steps, cache_interval, cache_mode,
        threshold=cache_threshold, token_k=cache_tokens,
        n_tokens=(model.num_patches + 1) if cache_mode == "token" else None)


def _make_cache(model, x_init: torch.Tensor, mode: str = "delta",
                mesh=None) -> step_cache.Cache:
    """A zero cache for a batch like ``x_init`` (the whole batch), on its
    device: this rank's rows under ``mesh``, the model's token rows (its
    block under sequence parallelism)."""
    cache = step_cache.init_cache(x_init.shape[0], model.local_tokens,
                                  model.embed_dim, model.dtype, mode=mode,
                                  img_shape=tuple(x_init.shape[1:]),
                                  device=x_init.device)
    return step_cache.shard_cache(cache, mesh)


def _check_schedule(x0, model, k, t_start) -> None:
    if x0 is None:
        raise ValueError(f"empty schedule: total_steps={model.total_steps}, "
                         f"k={k}, t_start={t_start}")


@torch.inference_mode()
def _ddim_cached_impl(model, x_init: torch.Tensor, noise: Optional[torch.Generator],
                      cache0: step_cache.Cache, *, k: int, t_start: Optional[int],
                      eta: float, cache_interval: int, cache_mode: str,
                      cache_threshold=None, cache_tokens=None, sequence: bool,
                      known=None, mask=None, telemetry: bool = False,
                      rows: Optional[_Rows] = None):
    """The step-cached DDIM loop: JAX's ``_ddim_cached_impl``; with
    ``known`` and ``mask`` its ``_ddim_inpaint_cached_impl`` (the projection
    applied to the clamped x̂0 after the cache branch); with ``telemetry``
    its ``_ddim_cached_tel_impl``. ``x_init`` is the loop's own start (not
    copied) and ``noise`` the η > 0 noise stream; ``rows``: x_init is these
    rows of the batch. Returns ``(images, cache)``, with ``telemetry``
    ``(images, cache, StepTelemetry)``."""
    coeffs = schedule.ddim_coefficients(model.total_steps, k, t_start, eta)
    spec = _cached_spec(model, len(coeffs.t_seq), cache_interval, cache_mode,
                        cache_threshold, cache_tokens)
    cached = _Cached(model, spec, cache0, telemetry, rows and rows.group)
    _, x0, frames = _ddim_loop(model, x_init, coeffs, noise, sequence, known, mask,
                               cached, rows)
    _check_schedule(x0, model, k, t_start)
    if telemetry:
        return _images(x0, frames), cached.cache, cached.telemetry()
    return _images(x0, frames), cached.cache


@torch.inference_mode()
def ddim_sample(model, generator: Optional[torch.Generator] = None, *,
                k: int = 10, n: int = 128, x_init=None,
                t_start: Optional[int] = None, return_sequence: bool = False,
                eta: float = 0.0, device=None, cache_interval: int = 1,
                cache_mode: str = "delta", cache_threshold: Optional[float] = None,
                cache_tokens: Optional[int] = None, telemetry: bool = False,
                mesh=None):
    """k-strided DDIM sampling; returns images in [0, 1], NHWC float32.

    Pass ``generator`` (a fresh N(0, 1) start of ``n`` images, reference
    ViT.py:224) or ``x_init`` (an (n, H, W, C) encoded start, array or
    tensor; never modified). ``return_sequence=True`` returns the
    (n_steps+1, n, H, W, C) trajectory: the start, then every x̂0. ``eta`` >
    0 is stochastic DDIM and draws per-step noise from
    ``fold_in(generator, NOISE_STREAM)``, so it requires ``generator``.
    ``device`` (None means ``"cuda"``) must be the model's device.

    ``cache_interval`` > 1 samples through the step cache: every
    ``cache_interval``-th step refreshes it, the steps between reuse it as
    ``cache_mode`` says ("delta", "full", "adaptive" with the drift gate
    ``cache_threshold``, "token" with ``cache_tokens`` live tokens; see
    :mod:`~ddim_cold_torch.ops.step_cache`). ``telemetry=True`` (cached and
    last-only) returns ``(images, StepTelemetry)``: per step, the branch
    taken and the adaptive gate's drift; the images are those of
    ``telemetry=False``, bit for bit. ``mesh``: data-parallel (and, with a
    ``sp_clone``d model, sequence-parallel) sampling, see the module.
    """
    dev = _sampling_device(model, device)
    if eta and generator is None:
        raise ValueError("eta > 0 draws per-step noise — pass generator")
    if telemetry:
        if return_sequence:
            raise ValueError("telemetry=True is last-only — previews and "
                             "telemetry are separate products")
        if not step_cache.enabled(cache_interval):
            raise ValueError("telemetry=True needs the cached sampler "
                             "(cache_interval > 1)")
    x = (fresh_start(model, generator, n, dev) if x_init is None
         else as_batch(x_init, dev))
    rows = _data_rows(mesh, x.shape[0])
    noise = fold_in(generator, NOISE_STREAM) if eta else None
    dim = 1 if return_sequence else 0
    if step_cache.enabled(cache_interval):
        out = _ddim_cached_impl(
            model, _take(x, rows), noise, _make_cache(model, x, cache_mode, mesh), k=k,
            t_start=t_start, eta=eta, cache_interval=cache_interval,
            cache_mode=cache_mode, cache_threshold=cache_threshold,
            cache_tokens=cache_tokens, sequence=return_sequence,
            telemetry=telemetry, rows=rows)
        images = _gather(out[0], rows, dim)
        return (images, out[2]) if telemetry else images
    coeffs = schedule.ddim_coefficients(model.total_steps, k, t_start, eta)
    _, x0, frames = _ddim_loop(model, _take(x, rows), coeffs, noise, return_sequence,
                               rows=rows)
    _check_schedule(x0, model, k, t_start)
    # the sample is the LAST x̂0 prediction (reference ViT.py:236)
    return _gather(_images(x0, frames), rows, dim)


@torch.inference_mode()
def ddim_inpaint(model, x_init, known, mask, *, k: int = 10,
                 t_start: Optional[int] = None, eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 return_sequence: bool = False, device=None,
                 cache_interval: int = 1, cache_mode: str = "delta",
                 cache_threshold: Optional[float] = None,
                 cache_tokens: Optional[int] = None, mesh=None) -> torch.Tensor:
    """DDIM from ``x_init`` with the known pixels re-projected after every
    clamp (JAX ``_ddim_inpaint_impl``): ``known`` is the reference image in
    [−1, 1], ``mask`` an (n, H, W, 1) batch of {0, 1} (1 = known). The
    output is the LAST projected x̂0, so its known pixels are
    ``(known + 1) / 2`` bit for bit, at every cache setting (the projection
    follows the cache branch); the projection is per row, and a padding row
    (mask 0) passes through it untouched. ``return_sequence`` returns the
    start and every projected x̂0. ``eta`` > 0 draws its per-step noise from
    ``generator`` itself (the caller's noise stream). The ``cache_*``
    options and ``mesh`` are :func:`ddim_sample`'s (the known image and the
    mask are split over the data axis with x, as the JAX engine places
    them)."""
    dev = _sampling_device(model, device)
    if eta and generator is None:
        raise ValueError("eta > 0 draws per-step noise — pass generator")
    x = as_batch(x_init, dev)
    rows = _data_rows(mesh, x.shape[0])
    known = _take(torch.as_tensor(known).to(device=dev, dtype=torch.float32), rows)
    mask = _take(torch.as_tensor(mask).to(device=dev, dtype=torch.float32), rows)
    dim = 1 if return_sequence else 0
    if step_cache.enabled(cache_interval):
        out = _ddim_cached_impl(
            model, _take(x, rows), generator, _make_cache(model, x, cache_mode, mesh),
            k=k, t_start=t_start, eta=eta, cache_interval=cache_interval,
            cache_mode=cache_mode, cache_threshold=cache_threshold,
            cache_tokens=cache_tokens, sequence=return_sequence, known=known,
            mask=mask, rows=rows)[0]
        return _gather(out, rows, dim)
    coeffs = schedule.ddim_coefficients(model.total_steps, k, t_start, eta)
    _, x0, frames = _ddim_loop(model, _take(x, rows), coeffs, generator, return_sequence,
                               known, mask, rows=rows)
    _check_schedule(x0, model, k, t_start)
    return _gather(_images(x0, frames), rows, dim)


@torch.inference_mode()
def _fewstep_cached_impl(model, x_init: torch.Tensor, noise: Optional[torch.Generator],
                         cache0, *, steps: int, t_start: Optional[int], eta: float,
                         cache_interval: int = 1, cache_mode: str = "delta",
                         cache_threshold=None, cache_tokens=None, sequence: bool,
                         rows: Optional[_Rows] = None):
    """The few-step loop (JAX ``_fewstep_impl``), through the step cache
    when ``cache0`` is given (``_fewstep_cached_impl``): the first steps−1
    evaluations take branches 0..steps−2 of the table, the final bare
    forward its last. ``rows`` as in :func:`_ddim_cached_impl`. Returns
    ``(images, cache)``; ``cache0=None`` is the plain loop (cache None)."""
    coeffs = schedule.fewstep_coefficients(model.total_steps, steps, t_start, eta)
    cached = None
    if cache0 is not None:
        cached = _Cached(model, _cached_spec(model, steps, cache_interval, cache_mode,
                                             cache_threshold, cache_tokens), cache0,
                         group=rows and rows.group)
    head = schedule.DDIMCoefficients(*(a[:-1] for a in coeffs))
    x, _, frames = _ddim_loop(model, x_init, head, noise, sequence, cached=cached,
                              rows=rows)
    # the jump to the clean image
    x0 = _evaluator(model, cached, rows)(x, int(coeffs.t_seq[-1]), steps - 1)
    if frames is not None:
        frames.append(x0)
    return _images(x0, frames), (cached.cache if cached else None)


@torch.inference_mode()
def ddim_sample_fewstep(model, generator: Optional[torch.Generator] = None, *,
                        steps: int, n: int = 128, x_init=None,
                        t_start: Optional[int] = None,
                        return_sequence: bool = False, eta: float = 0.0,
                        device=None, cache_interval: int = 1,
                        cache_mode: str = "delta",
                        cache_threshold: Optional[float] = None,
                        cache_tokens: Optional[int] = None,
                        mesh=None) -> torch.Tensor:
    """Few-step DDIM sampling: exactly ``steps`` model evaluations along the
    proportional ``schedule.fewstep_time_sequence`` (the distilled-student
    serving path, k ∈ {1, 2, 4}); returns images in [0, 1].

    The last jump targets the clean image, where the update is x' = x̂0
    exactly (``schedule.fewstep_coefficients``), so the final evaluation
    runs outside the loop as a bare forward and ``steps=1`` is one forward.
    ``generator``/``x_init``/``t_start``/``return_sequence``/``eta``,
    ``mesh`` and the ``cache_*`` options behave as in :func:`ddim_sample`.
    """
    dev = _sampling_device(model, device)
    if eta and generator is None:
        raise ValueError("eta > 0 draws per-step noise — pass generator")
    x = (fresh_start(model, generator, n, dev,
                     "ddim_sample_fewstep") if x_init is None
         else as_batch(x_init, dev))
    rows = _data_rows(mesh, x.shape[0])
    noise = fold_in(generator, NOISE_STREAM) if eta else None
    cache0 = (_make_cache(model, x, cache_mode, mesh)
              if step_cache.enabled(cache_interval) else None)
    out = _fewstep_cached_impl(
        model, _take(x, rows), noise, cache0, steps=steps, t_start=t_start, eta=eta,
        cache_interval=cache_interval, cache_mode=cache_mode,
        cache_threshold=cache_threshold, cache_tokens=cache_tokens,
        sequence=return_sequence, rows=rows)[0]
    return _gather(out, rows, 1 if return_sequence else 0)


@torch.inference_mode()
def _cold_cached_impl(model, x_init: torch.Tensor, cache0, *, levels: int,
                      return_sequence: bool, cache_interval: int = 1,
                      cache_mode: str = "delta", cache_threshold=None,
                      cache_tokens=None, rows: Optional[_Rows] = None):
    """The cold loop (naive Algorithm 1, x ← clamp(f(x, t)) for t = levels,
    …, 1), through the step cache when ``cache0`` is given (JAX
    ``_cold_cached_impl``; ``rows`` as in :func:`_ddim_cached_impl`).
    Returns ``(images, cache)``."""
    cached = None
    if cache0 is not None:
        cached = _Cached(model, _cached_spec(model, levels, cache_interval, cache_mode,
                                             cache_threshold, cache_tokens), cache0,
                         group=rows and rows.group)
    evaluate = _evaluator(model, cached, rows)
    x = x_init
    frames = [x] if return_sequence else None
    for i, t in enumerate(schedule.cold_time_sequence(levels).tolist()):
        # the reference's DDIM-style correction is present upstream only as
        # commented-out code (ViT_draft2drawing.py:275-285)
        x = evaluate(x, t, i)
        if return_sequence:
            frames.append(x)
    return _images(x, frames), (cached.cache if cached else None)


@torch.inference_mode()
def cold_sample(model, generator: Optional[torch.Generator] = None, *,
                n: int = 49, levels: int = 6, x_init=None,
                return_sequence: bool = False, device=None,
                cache_interval: int = 1, cache_mode: str = "delta",
                cache_threshold: Optional[float] = None,
                cache_tokens: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Cold-diffusion sampling (naive Algorithm 1): x ← clamp(f(x, t)) for
    t = levels, …, 1; returns images in [0, 1].

    The default start is one N(0, 1) colour per sample broadcast over the
    image (reference ViT_draft2drawing.py:264, the fully downsampled state);
    ``levels`` defaults to 6 = log2(64). ``x_init`` starts from a
    caller-provided degraded state at level ``levels`` instead (the
    super-resolution workload's upsampled low-res input).
    ``return_sequence`` returns the start and every prediction; ``mesh``
    and the ``cache_*`` options are :func:`ddim_sample`'s.
    """
    dev = _sampling_device(model, device)
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if x_init is None:
        x = cold_init(model, generator, n, dev)
    else:
        x = as_batch(x_init, dev)
    rows = _data_rows(mesh, x.shape[0])
    cache0 = (_make_cache(model, x, cache_mode, mesh)
              if step_cache.enabled(cache_interval) else None)
    out = _cold_cached_impl(model, _take(x, rows), cache0, levels=levels,
                            return_sequence=return_sequence,
                            cache_interval=cache_interval, cache_mode=cache_mode,
                            cache_threshold=cache_threshold,
                            cache_tokens=cache_tokens, rows=rows)[0]
    return _gather(out, rows, 1 if return_sequence else 0)


def cold_init(model, generator: Optional[torch.Generator], n: int,
              device) -> torch.Tensor:
    """``cold_sample``'s default start: one N(0, 1) colour per sample,
    drawn as an (n, 1, 1, C) batch and broadcast over the image."""
    if generator is None:
        raise ValueError("cold_sample needs either generator or x_init")
    H, W = model.img_size
    color = torch.randn((n, 1, 1, model.in_chans), generator=generator,
                        device=device, dtype=torch.float32)
    return color.expand(n, H, W, model.in_chans).contiguous()


def forward_noise(generator: torch.Generator, img: torch.Tensor, t_start: int,
                  total_steps: int = 2000) -> torch.Tensor:
    """Encode a clean image to noise level ``t_start``; ᾱ = 1 − √(t_start/T)
    (no +1, matching the draft2drawing app). ``generator`` lives on img's
    device."""
    alpha = schedule.forward_noise_alpha(t_start, total_steps)
    eps = torch.randn(img.shape, generator=generator, device=img.device,
                      dtype=img.dtype)
    return math.sqrt(alpha) * img + math.sqrt(1.0 - alpha) * eps


def sample_from(model, x_init, t_start: int, k: int = 10, eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                return_sequence: bool = False, device=None,
                cache_interval: int = 1, cache_mode: str = "delta",
                cache_threshold: Optional[float] = None,
                cache_tokens: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Guided sampling: DDIM-denoise an encoded image from level ``t_start``
    (a prefix-truncated :func:`ddim_sample`, its ``cache_*`` options and
    ``mesh`` too)."""
    return ddim_sample(model, generator, x_init=x_init, t_start=t_start, k=k,
                       eta=eta, return_sequence=return_sequence, device=device,
                       cache_interval=cache_interval, cache_mode=cache_mode,
                       cache_threshold=cache_threshold, cache_tokens=cache_tokens,
                       mesh=mesh)


def slerp(a: torch.Tensor, b: torch.Tensor, frac) -> torch.Tensor:
    """Spherical interpolation between two (batches of) latents; ``frac``
    broadcasts against the leading axes, so a (F, 1, 1, 1, 1) fraction
    vector against (N, H, W, C) endpoints gives all F interpolants at once.
    The sin denominator is guarded, and parallel endpoints fall back to the
    linear mix."""
    frac = torch.as_tensor(frac, dtype=a.dtype, device=a.device)
    flat_a = a.reshape(a.shape[0], -1) if a.ndim > 1 else a[None]
    flat_b = b.reshape(b.shape[0], -1) if b.ndim > 1 else b[None]
    cos = (flat_a * flat_b).sum(-1) / (
        torch.linalg.vector_norm(flat_a, dim=-1) * torch.linalg.vector_norm(flat_b, dim=-1))
    theta_shape = (a.shape[:1] + (1,) * (a.ndim - 1)) if a.ndim > 1 else ()
    theta = torch.arccos(cos.clamp(-1.0, 1.0)).reshape(theta_shape)
    sin = torch.sin(theta)
    # the untaken branch must carry no 0/0 near parallel endpoints
    safe_sin = torch.where(sin < 1e-6, torch.ones_like(sin), sin)
    wa = torch.sin((1.0 - frac) * theta) / safe_sin
    wb = torch.sin(frac * theta) / safe_sin
    lin = (1.0 - frac) * a + frac * b
    return torch.where(sin < 1e-6, lin, wa * a + wb * b)


def interp_states(generator: torch.Generator, img_a, img_b, n_interp: int,
                  t_start: int, total_steps: int = 2000) -> torch.Tensor:
    """The slerp-mixed encodings :func:`slerp_interpolate` decodes: both
    endpoints forward-noised to ``t_start`` in one draw from ``generator``
    (independent noise per endpoint, as the reference's two draws,
    ViT_draft2drawing.py:442-443), then ``n_interp`` great-circle fractions
    between the two encodings, on ``generator``'s device. Row i depends only
    on (seed, endpoints, n_interp), never on its batchmates."""
    dev = generator.device
    batch = torch.stack([torch.as_tensor(img, dtype=torch.float32).to(dev)
                         for img in (img_a, img_b)])
    noisy = forward_noise(generator, batch, t_start, total_steps)
    frac = torch.linspace(0.0, 1.0, n_interp, device=dev).reshape(-1, 1, 1, 1, 1)
    return slerp(noisy[0][None], noisy[1][None], frac)[:, 0]


def slerp_interpolate(model, generator: torch.Generator, img_a, img_b, *,
                      n_interp: int = 8, t_start: int = 1800, k: int = 10,
                      eta: float = 0.0, return_sequence: bool = False,
                      device=None) -> torch.Tensor:
    """Latent interpolation: encode both images to ``t_start``, slerp
    ``n_interp`` fractions between the encodings and DDIM-decode each;
    returns (n_interp, H, W, C) in [0, 1]. η > 0 decodes stochastically from
    ``fold_in(generator, 1)``, so the encoding and decoding noise stay
    independent (JAX ``fold_in(rng, 1)``)."""
    _sampling_device(model, device)
    mixed = interp_states(generator, img_a, img_b, n_interp, t_start,
                          model.total_steps)
    return sample_from(model, mixed, t_start=t_start, k=k, eta=eta,
                       generator=fold_in(generator, 1),
                       return_sequence=return_sequence, device=device)
