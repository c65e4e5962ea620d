"""FID — Fréchet Inception Distance, and the quality guards built on it
(counterpart of ``ddim_cold_tpu/eval/fid.py``).

* :class:`ActivationStats` — streaming (count, Σx, Σxxᵀ) in float64 numpy;
  memory is O(d²) whatever the sample count.
* :func:`frechet_distance` — ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2(Σ₁Σ₂)^½), the square
  root through symmetric eigensolves (numpy ``eigh``; no scipy).
* :func:`make_feature_fn` / :func:`compute_fid` / :func:`fid_between` —
  images in [0, 1] → bilinear resize to 299×299 → [−1, 1] → InceptionV3
  pool3 features (:mod:`ddim_cold_torch.eval.inception`) → statistics →
  distance.
* The guards: paired exact-vs-changed streams from the same starts under
  one extractor — :func:`cached_sampler_guard` (the step cache),
  :func:`quantized_sampler_guard` (the int8 trunk),
  :func:`distilled_sampler_guard` (a few-step student) — and
  :func:`superres_consistency_guard` (served super-resolution contains its
  input, bit for bit).

Where the JAX functions take a ``(model, params)`` pair the port takes a
model holding its weights, and where they take an ``rng`` key the port
takes a ``torch.Generator`` on the sampling device: batch b's streams draw
from ``sampling.fold_in(generator, b)``, the same start for both streams
of a pair. ``device`` (None means ``"cuda"``) is where the extractor runs
and must be the model's device; without CUDA it raises unless the caller
asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ddim_cold_torch.data.resize import nearest_indices
from ddim_cold_torch.eval import inception
from ddim_cold_torch.utils.platform import resolve_device

#: the ``extractor`` entry of a guard's report
_PROXY = ("seeded random-init proxy (paired streams, same extractor — "
          "distance is meaningful, absolute FID scale is not)")
#: the stream the inpaint guard's ``known`` batch is drawn from (JAX
#: ``fold_in(sub, 0xFACE)``)
KNOWN_STREAM = 0xFACE


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class ActivationStats:
    """Streaming mean/covariance of feature activations."""

    dim: int
    count: int = 0
    _sum: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    _outer: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self._sum is None:
            self._sum = np.zeros(self.dim, np.float64)
        if self._outer is None:
            self._outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats) -> None:
        """Add an (N, dim) batch (numpy, or a tensor on any device)."""
        feats = np.asarray(_host(feats), np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) features, got {feats.shape}")
        self.count += feats.shape[0]
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats

    def merge(self, other: "ActivationStats") -> "ActivationStats":
        """Combine two accumulators (e.g. per-host shards)."""
        if other.dim != self.dim:
            raise ValueError("dimension mismatch")
        out = ActivationStats(self.dim)
        out.count = self.count + other.count
        out._sum = self._sum + other._sum
        out._outer = self._outer + other._outer
        return out

    @property
    def mean(self) -> np.ndarray:
        if self.count < 1:
            raise ValueError("no samples accumulated")
        return self._sum / self.count

    @property
    def cov(self) -> np.ndarray:
        """Unbiased (N−1) covariance — matches np.cov / pytorch-fid."""
        if self.count < 2:
            raise ValueError("need ≥2 samples for covariance")
        mu = self.mean
        return (self._outer - self.count * np.outer(mu, mu)) / (self.count - 1)


def _sqrtm_psd(mat: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Symmetric-PSD matrix square root via eigh (negative eigenvalues from
    round-off are clamped to 0)."""
    w, v = np.linalg.eigh(mat)
    return (v * np.sqrt(np.clip(w, eps, None))) @ v.T


def trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr((Σ₁Σ₂)^½) computed stably as tr((Σ₁^½ Σ₂ Σ₁^½)^½): the inner
    matrix is symmetric PSD, so everything stays in real symmetric
    eigensolves."""
    s1h = _sqrtm_psd(np.asarray(sigma1, np.float64))
    inner = s1h @ np.asarray(sigma2, np.float64) @ s1h
    inner = (inner + inner.T) / 2.0
    w = np.linalg.eigvalsh(inner)
    return float(np.sqrt(np.clip(w, 0.0, None)).sum())


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """d²((μ₁,Σ₁), (μ₂,Σ₂)) = ‖μ₁−μ₂‖² + tr(Σ₁) + tr(Σ₂) − 2·tr((Σ₁Σ₂)^½)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = float(((mu1 - mu2) ** 2).sum())
    return diff + float(np.trace(sigma1) + np.trace(sigma2)) \
        - 2.0 * trace_sqrt_product(sigma1, sigma2)


def fid_from_stats(a: ActivationStats, b: ActivationStats) -> float:
    return frechet_distance(a.mean, a.cov, b.mean, b.cov)


# ---------------------------------------------------------------------------
# feature extraction pipeline
# ---------------------------------------------------------------------------

def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC → (N, size, size, C) as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, and antialiasing (the triangle kernel widened by
    the scale) where an axis shrinks."""
    x = images.permute(0, 3, 1, 2)
    shrink = x.shape[2] > size or x.shape[3] > size
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=shrink)
    return x.permute(0, 2, 3, 1)


def make_feature_fn(model=None, variables=None, *, device=None) -> tuple[Callable, int]:
    """Returns ``(feature_fn, dim)`` where ``feature_fn(images_01)`` maps a
    [0,1] NHWC batch (any resolution; numpy or a tensor) to (N, 2048)
    float32 pool3 features on ``device`` (None means ``"cuda"``).

    With no arguments, uses the seeded random-init extractor
    (:func:`inception.init_variables`) — a valid metric space for guards
    and regression tracking but NOT comparable to published FID numbers;
    pass a state_dict from :func:`inception.load_torch_inception` for
    those, or one carried over from the JAX package
    (:func:`inception.inception_state_dict_from_flax`). Passing only
    ``variables`` loads them into a new ``InceptionV3Features()``; a model
    without variables is an error (random init would silently corrupt the
    metric).
    """
    dev = resolve_device(device)
    if variables is None:
        if model is not None:
            raise ValueError(
                "inception model given without variables — refusing to pair "
                "real weights' architecture with random init")
        model, variables = inception.init_variables(0)
    elif model is None:
        model = inception.InceptionV3Features()
    model.load_state_dict(variables, strict=True)
    model.to(dev)

    @torch.inference_mode()
    def feature_fn(images_01):
        x = torch.as_tensor(images_01).to(device=dev, dtype=torch.float32)
        x = resize_bilinear(x.clamp(0.0, 1.0), inception.INCEPTION_SIZE)
        x = x * 2.0 - 1.0  # the FID-inception normalization (mean=std=0.5)
        return model(x.permute(0, 3, 1, 2).contiguous())

    return feature_fn, inception.FEATURE_DIM


def stats_for_batches(batches: Iterable, feature_fn: Callable,
                      dim: int = inception.FEATURE_DIM) -> ActivationStats:
    """Accumulate activation statistics over an iterable of [0,1] NHWC batches."""
    stats = ActivationStats(dim)
    for batch in batches:
        stats.update(feature_fn(batch))
    return stats


def fid_between(real_batches: Iterable, fake_batches: Iterable, model=None,
                variables=None, *, device=None) -> float:
    """End-to-end FID between two streams of [0,1] image batches."""
    feature_fn, dim = make_feature_fn(model, variables, device=device)
    real = stats_for_batches(real_batches, feature_fn, dim)
    fake = stats_for_batches(fake_batches, feature_fn, dim)
    return fid_from_stats(real, fake)


def _batches(n_samples: int, sample_batch: int):
    """``(b, keep)`` per sampler batch: every batch is a full
    ``sample_batch`` (one program shape); the surplus rows of the last one
    are dropped before they reach the statistics."""
    b, remaining = 0, n_samples
    while remaining > 0:
        keep = min(sample_batch, remaining)
        yield b, keep
        b, remaining = b + 1, remaining - keep


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _extractor(inception_variables) -> str:
    return "canonical" if inception_variables is not None else _PROXY


def compute_fid(
    model,
    real_batches: Iterable,
    *,
    generator: torch.Generator,
    n_samples: int = 1024,
    sample_batch: int = 64,
    k: int = 20,
    inception_model=None,
    inception_variables=None,
    sampler: Optional[Callable] = None,
    cache_interval: int = 1,
    cache_mode: str = "delta",
    cache_threshold: Optional[float] = None,
    cache_tokens: Optional[int] = None,
    device=None,
) -> float:
    """FID of a diffusion model's samples against a real-image stream.

    Samples are drawn with ``ops.sampling.ddim_sample`` at stride ``k`` (the
    north-star metric path: 200px, k=20) unless a custom ``sampler(generator,
    n) → [0,1] images`` is given. ``cache_*`` pass through to the sampler's
    step cache (ops/step_cache.py); the default interval=1 is the exact
    sampler.
    """
    from ddim_cold_torch.ops import sampling

    feature_fn, dim = make_feature_fn(inception_model, inception_variables,
                                      device=device)
    real = stats_for_batches(real_batches, feature_fn, dim)
    fake = ActivationStats(dim)
    for b, keep in _batches(n_samples, sample_batch):
        sub = sampling.fold_in(generator, b)
        imgs = (sampler(sub, sample_batch) if sampler is not None
                else sampling.ddim_sample(model, sub, k=k, n=sample_batch,
                                          cache_interval=cache_interval,
                                          cache_mode=cache_mode,
                                          cache_threshold=cache_threshold,
                                          cache_tokens=cache_tokens, device=device))
        fake.update(feature_fn(imgs)[:keep])
    return fid_from_stats(real, fake)


def inpaint_known(generator: torch.Generator, n: int, model) -> torch.Tensor:
    """The inpaint guard's known batch for one sampler batch: uniform
    [−1, 1] images drawn from ``fold_in(generator, KNOWN_STREAM)``."""
    from ddim_cold_torch.ops import sampling

    H, W = model.img_size
    g = sampling.fold_in(generator, KNOWN_STREAM)
    u = torch.rand((n, H, W, model.in_chans), generator=g, device=g.device)
    return u * 2.0 - 1.0


def cached_sampler_guard(
    model,
    *,
    generator: torch.Generator,
    n_samples: int = 256,
    sample_batch: int = 64,
    k: int = 20,
    cache_interval: int = 2,
    cache_mode: str = "full",
    cache_threshold: Optional[float] = None,
    cache_tokens: Optional[int] = None,
    task: str = "sample",
    mask=None,
    inception_model=None,
    inception_variables=None,
    device=None,
) -> dict:
    """Quality guard for the step-cached sampler (ops/step_cache.py): the
    Fréchet distance between the EXACT and CACHED samplers' output streams
    drawn from the same starts, under one extractor.

    A paired exact-vs-cached distance isolates the cache's own
    distributional shift (exactly 0 when the cache is harmless, and it
    needs no real images or canonical extractor weights), where two
    FID-vs-real numbers would bury a small shift under the shared real-set
    term. With no ``inception_variables`` the extractor is the seeded
    random-init proxy (:func:`make_feature_fn`): both streams go through the
    same extractor and only their distance is reported.

    ``cache_threshold``/``cache_tokens`` pass through to the adaptive/token
    modes (see ``ddim_sample``). ``task`` selects the guarded workload:
    ``"sample"`` (plain generation) or ``"inpaint"``, which pairs the exact
    and step-cached ``workloads.inpaint`` over the same known images (a
    fresh uniform [−1,1] batch per sampler batch, :func:`inpaint_known`) and
    ``mask`` (default: top half known).

    Returns a dict with ``fid_exact_vs_cached``, ``max_abs_pixel_delta``
    (worst per-pixel divergence across every paired batch) and the sampler
    configuration, ready to land in a bench record.
    """
    from ddim_cold_torch import workloads
    from ddim_cold_torch.ops import sampling

    if task not in ("sample", "inpaint"):
        raise ValueError(f"cached_sampler_guard task must be 'sample' or "
                         f"'inpaint', got {task!r}")
    feature_fn, dim = make_feature_fn(inception_model, inception_variables,
                                      device=device)
    exact, cached = ActivationStats(dim), ActivationStats(dim)
    H, W = model.img_size
    if task == "inpaint" and mask is None:
        mask = np.zeros((H, W), np.float32)
        mask[: H // 2] = 1.0
    cache = dict(cache_interval=cache_interval, cache_mode=cache_mode,
                 cache_threshold=cache_threshold, cache_tokens=cache_tokens)
    max_delta = 0.0
    for b, keep in _batches(n_samples, sample_batch):
        sub = lambda: sampling.fold_in(generator, b)  # noqa: E731
        if task == "inpaint":
            known = inpaint_known(sub(), sample_batch, model)
            imgs_e = workloads.inpaint(model, sub(), known, mask, k=k, device=device)
            imgs_c = workloads.inpaint(model, sub(), known, mask, k=k, device=device,
                                       **cache)
        else:
            imgs_e = sampling.ddim_sample(model, sub(), k=k, n=sample_batch,
                                          device=device)
            imgs_c = sampling.ddim_sample(model, sub(), k=k, n=sample_batch,
                                          device=device, **cache)
        max_delta = max(max_delta, _max_abs(imgs_e, imgs_c))
        exact.update(feature_fn(imgs_e)[:keep])
        cached.update(feature_fn(imgs_c)[:keep])
    return {
        "fid_exact_vs_cached": round(float(fid_from_stats(exact, cached)), 4),
        "max_abs_pixel_delta": round(max_delta, 6),
        "n_samples": n_samples,
        "k": k,
        "task": task,
        **cache,
        "extractor": _extractor(inception_variables),
    }


def quantized_sampler_guard(
    model,
    *,
    generator: torch.Generator,
    n_samples: int = 256,
    sample_batch: int = 64,
    k: int = 20,
    quant: str = "xla",
    cache_interval: int = 1,
    cache_mode: str = "full",
    quantized_state_dict=None,
    inception_model=None,
    inception_variables=None,
    device=None,
) -> dict:
    """Quality guard for the int8 trunk (ops/quant.py), the shape of
    :func:`cached_sampler_guard`: the Fréchet distance between the EXACT
    float and the QUANTIZED samplers' output streams from the same starts
    under one extractor — 0 when quantization is harmless, and the
    acceptance bound ("shift ≤ 0.5") reads directly off it.

    ``model`` is the float model; the quantized side runs
    ``model.clone(quant=quant)`` (the caller's ``fused`` kept) over
    ``quant.quantize_state_dict(model.state_dict())`` (pass
    ``quantized_state_dict`` to reuse a state built elsewhere, e.g. the
    serving engine's). ``cache_interval`` > 1 also routes the quantized
    stream through the step cache, measuring the COMPOSED shift
    (quantization × block reuse). ``quant.calibrate``'s worst layer rides
    the report, so a bad distance is attributable to a layer.
    """
    from ddim_cold_torch.ops import quant as quant_mod
    from ddim_cold_torch.ops import sampling

    float_state = model.state_dict()
    qmodel = model.clone(quant=quant)
    qmodel.load_state_dict(quantized_state_dict if quantized_state_dict is not None
                           else quant_mod.quantize_state_dict(float_state), strict=True)
    feature_fn, dim = make_feature_fn(inception_model, inception_variables,
                                      device=device)
    exact, quantized = ActivationStats(dim), ActivationStats(dim)
    max_delta = 0.0
    for b, keep in _batches(n_samples, sample_batch):
        imgs_e = sampling.ddim_sample(model, sampling.fold_in(generator, b), k=k,
                                      n=sample_batch, device=device)
        imgs_q = sampling.ddim_sample(qmodel, sampling.fold_in(generator, b), k=k,
                                      n=sample_batch, cache_interval=cache_interval,
                                      cache_mode=cache_mode, device=device)
        max_delta = max(max_delta, _max_abs(imgs_e, imgs_q))
        exact.update(feature_fn(imgs_e)[:keep])
        quantized.update(feature_fn(imgs_q)[:keep])
    cal = quant_mod.calibrate(float_state)
    worst = (max(cal.items(), key=lambda kv: kv[1]["max_abs_err"])
             if cal else (None, None))
    return {
        "fid_exact_vs_quant": round(float(fid_from_stats(exact, quantized)), 4),
        "max_abs_pixel_delta": round(max_delta, 6),
        "n_samples": n_samples,
        "k": k,
        "quant": quant,
        "quant_rev": quant_mod.QUANT_REV,
        "cache_interval": cache_interval,
        "cache_mode": cache_mode,
        "calibration_worst_layer": worst[0],
        "calibration_max_abs_err": (None if worst[1] is None
                                    else round(worst[1]["max_abs_err"], 8)),
        "extractor": _extractor(inception_variables),
    }


def distilled_sampler_guard(
    model,
    student,
    *,
    generator: torch.Generator,
    steps: int,
    n_samples: int = 256,
    sample_batch: int = 64,
    k: int = 20,
    cache_interval: int = 1,
    cache_mode: str = "full",
    inception_model=None,
    inception_variables=None,
    device=None,
) -> dict:
    """Quality guard for few-step distilled serving (train/distill.py +
    ``SamplerConfig(steps=k, student=True)``), the shape of
    :func:`quantized_sampler_guard`: the Fréchet distance between the
    TEACHER ``model``'s k-strided stream (``ddim_sample``) and the
    ``student`` model's ``steps``-evaluation stream
    (``ddim_sample_fewstep``) from the same starts under one extractor, so
    a latency win bought by cutting k cannot silently buy a quality loss.

    ``cache_interval`` > 1 routes the STUDENT stream through the step
    cache (distillation × block reuse). Teacher and student outputs differ
    by design: ``max_abs_pixel_delta`` is reported, and the Fréchet shift
    is the metric.
    """
    from ddim_cold_torch.ops import sampling

    feature_fn, dim = make_feature_fn(inception_model, inception_variables,
                                      device=device)
    teacher, distilled = ActivationStats(dim), ActivationStats(dim)
    max_delta = 0.0
    for b, keep in _batches(n_samples, sample_batch):
        imgs_t = sampling.ddim_sample(model, sampling.fold_in(generator, b), k=k,
                                      n=sample_batch, device=device)
        imgs_s = sampling.ddim_sample_fewstep(student, sampling.fold_in(generator, b),
                                              steps=steps, n=sample_batch,
                                              cache_interval=cache_interval,
                                              cache_mode=cache_mode, device=device)
        max_delta = max(max_delta, _max_abs(imgs_t, imgs_s))
        teacher.update(feature_fn(imgs_t)[:keep])
        distilled.update(feature_fn(imgs_s)[:keep])
    return {
        "fid_teacher_vs_student": round(float(fid_from_stats(teacher, distilled)), 4),
        "max_abs_pixel_delta": round(max_delta, 6),
        "n_samples": n_samples,
        "k": k,
        "steps": steps,
        "cache_interval": cache_interval,
        "cache_mode": cache_mode,
        "extractor": _extractor(inception_variables),
    }


def superres_consistency_guard(outputs, low_res) -> dict:
    """Editing-quality guard for served super-resolution: the delivered
    output must still CONTAIN its input — nearest-downsampling the output
    (the floor-index convention, i.e. sampling the static anchor pixels)
    must reproduce the low-res input bit-exactly, in the engine's [0, 1]
    delivery space against the task's [−1, 1] input space
    (``(low_res + 1) / 2``).

    The raw cold scan does not guarantee this, so callers run
    ``workloads.superres_project`` on the delivered batch first; the guard
    then proves the convention stack end to end: the nearest-index math,
    the value mapping, and (served) that every row was projected against
    ITS OWN request's input — a row swap, a bucket-padding leak, or a
    resampled index table all break bit-exactness.

    Host numpy (tensors are copied to the host). Returns ``{"bit_exact",
    "max_abs_delta", "anchor_pixels"}``.
    """
    out = np.asarray(_host(outputs), np.float32)
    low = np.asarray(_host(low_res), np.float32)
    if out.ndim == 3:
        out = out[None]
    if low.ndim == 3:
        low = low[None]
    iy = nearest_indices(low.shape[1], out.shape[1])
    ix = nearest_indices(low.shape[2], out.shape[2])
    down = out[:, iy[:, None], ix[None, :], :]
    target = (low + 1.0) / 2.0
    return {
        "bit_exact": bool(np.array_equal(down, target)),
        "max_abs_delta": round(float(np.max(np.abs(down - target))), 6),
        "anchor_pixels": int(down[0, ..., 0].size),
    }
