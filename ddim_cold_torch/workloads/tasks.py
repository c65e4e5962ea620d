"""The guided-editing tasks: each one an (init state, schedule suffix,
per-step constraint) triple over the samplers of ``ops/sampling.py``.

Counterpart of ``ddim_cold_tpu/workloads/tasks.py``. Every task in
:data:`EDIT_TASKS` is two things at once:

* a **direct function** here (``inpaint``, ``super_resolve``,
  ``draft_to_drawing``, ``interpolate``): the single-call form, composing
  the samplers the way the reference apps do (ViT_draft2drawing.py);
* a **served product**: a :class:`~ddim_cold_torch.serve.batching.SamplerConfig`
  with ``task=<name>`` submitted through ``Engine``, which coalesces into the
  same buckets, warmup and quant variants as plain sampling, bitwise equal
  to the direct call for the same seed at the same dispatch shape.

The init functions (:func:`draft_init`, :func:`interp_init`,
:func:`superres_init`) are the single definition both paths use: the direct
functions and ``serve/engine.py``'s ``_request_init`` call the same code.

| task       | sampler | init state                          | per-step constraint |
|------------|---------|-------------------------------------|---------------------|
| inpaint    | ddim    | fresh noise from the request seed   | x̂0 mask re-projection |
| superres   | cold    | nearest-upsampled low-res input     | none (cold loop)    |
| draft      | ddim    | ``forward_noise(draft, t_start)``   | none (suffix loop)  |
| interp     | ddim    | slerp of two encoded endpoints      | none (suffix loop)  |

The JAX functions take ``params`` and a ``jax.random`` key; here the model
holds its weights and a ``torch.Generator`` on the model's device takes the
key's place. Every task takes the step-cache options (``cache_interval``,
``cache_mode``, ``cache_threshold``, ``cache_tokens``) of its sampler.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddim_cold_torch.data.resize import nearest_indices
from ddim_cold_torch.ops import degrade, sampling

#: the served editing tasks; "sample" (plain generation) completes the
#: SamplerConfig ``task`` domain (serve/batching.py keeps its own literals)
EDIT_TASKS = ("inpaint", "superres", "draft", "interp")
TASKS = ("sample",) + EDIT_TASKS


# ---------------------------------------------------------------- inputs

def normalize_mask(mask, n: int, img_size) -> np.ndarray:
    """User mask → the engine/sampler contract: float32 (n, H, W, 1) of
    {0, 1} (1 = KNOWN pixel, preserved exactly; 0 = to be synthesized).

    Accepts (H, W), (H, W, 1), (n, H, W) or (n, H, W, 1); a single mask
    broadcasts over the batch. Values must be exactly binary: "known pixels
    bit-preserved" only means something for a hard projection, so soft
    masks are rejected rather than thresholded. Host-side numpy: the engine
    slices request rows out of this array.
    """
    H, W = img_size
    m = np.asarray(mask, np.float32)
    if m.ndim == 2:
        m = m[None, :, :, None]
    elif m.ndim == 3:
        m = m[None] if m.shape == (H, W, 1) else m[..., None]
    if m.ndim != 4 or m.shape[1:] != (H, W, 1):
        raise ValueError(
            f"mask must be (H, W), (H, W, 1), (n, H, W) or (n, H, W, 1) "
            f"for image size {(H, W)}, got shape {np.shape(mask)}")
    if m.shape[0] == 1 and n > 1:
        m = np.broadcast_to(m, (n, H, W, 1))
    if m.shape[0] != n:
        raise ValueError(f"mask batch {m.shape[0]} != request n {n}")
    if not np.isin(m, (0.0, 1.0)).all():
        raise ValueError(
            "mask must be binary {0, 1} — known pixels are re-projected "
            "EXACTLY, which a soft mask cannot mean")
    return np.ascontiguousarray(m)


# ----------------------------------------------------------- init functions

def draft_init(generator: torch.Generator, draft, t_start: int,
               total_steps: int = 2000) -> torch.Tensor:
    """Draft→drawing init: the sketch forward-noised to ``t_start``
    (reference ViT_draft2drawing.py:395), on ``generator``'s device; the
    task is then ``sample_from``. The noise is drawn at the draft's own
    (n, H, W, C), so the engine draws it at the request's n and slices."""
    return sampling.forward_noise(generator, sampling.as_batch(draft, generator.device),
                                  t_start, total_steps)


#: interp init: the slerp-mixed encodings of the endpoint pair, the exact
#: states ``slerp_interpolate`` decodes (one definition, ops/sampling.py)
interp_init = sampling.interp_states


def superres_init(low_res, size: int) -> np.ndarray:
    """Super-resolution init: the low-res input nearest-upsampled to the
    model's size, i.e. the cold-degraded full-size state D(x, level) of the
    unknown original (``ops/degrade.upsample_nearest``). Host numpy: it is a
    guided-start payload for ``Engine.submit(x_init=...)``."""
    return degrade.upsample_nearest(np.asarray(low_res, np.float32), size).numpy()


def superres_project(outputs, low_res) -> np.ndarray:
    """Data-consistency projection for super-resolution outputs: overwrite
    the nearest-downsample ANCHOR pixels of ``outputs`` (in [0, 1], the
    engine's delivery space) with the low-res input (in [−1, 1]), so that
    ``nearest-downsample(result) == (low_res + 1) / 2`` holds bit for bit.

    The cold loop replaces x wholesale with the clamped prediction each
    step, so the anchors of the raw output only track the input; this host
    finishing step makes the consistency exact. The anchor set is static
    (the floor-index convention) and per row, so it composes with any
    serving batch shape."""
    out = np.array(outputs, np.float32, copy=True)
    low = np.asarray(low_res, np.float32)
    if out.ndim == 3:
        out = out[None]
    if low.ndim == 3:
        low = low[None]
    iy = nearest_indices(low.shape[1], out.shape[1])
    ix = nearest_indices(low.shape[2], out.shape[2])
    out[:, iy[:, None], ix[None, :], :] = (low + 1.0) / 2.0
    return out


# --------------------------------------------------------- direct functions

def inpaint(model, generator: torch.Generator, known, mask, *, k: int = 10,
            t_start: Optional[int] = None, eta: float = 0.0,
            cache_interval: int = 1, cache_mode: str = "delta",
            cache_threshold: Optional[float] = None,
            cache_tokens: Optional[int] = None,
            return_sequence: bool = False, device=None) -> torch.Tensor:
    """Training-free inpainting: DDIM from fresh noise (drawn from
    ``generator`` at the known image's n) with per-step re-projection of the
    known pixels (``sampling.ddim_inpaint``). ``known`` is the reference image
    in [−1, 1]; ``mask`` selects the pixels to preserve (see
    :func:`normalize_mask`). The known pixels of the result are
    ``(known + 1) / 2`` bit for bit, at every cache setting. η > 0 draws
    its noise from ``fold_in(generator, NOISE_STREAM)``. Served form:
    ``SamplerConfig(task="inpaint")`` + ``submit(seed=, x_init=known, mask=)``."""
    dev = sampling._sampling_device(model, device)
    known = sampling.as_batch(known, dev)
    n = known.shape[0]
    m = torch.from_numpy(normalize_mask(mask, n, model.img_size)).to(dev)
    x_init = sampling.fresh_start(model, generator, n, dev, "inpaint")
    noise = sampling.fold_in(generator, sampling.NOISE_STREAM) if eta else None
    return sampling.ddim_inpaint(model, x_init, known, m, k=k, t_start=t_start,
                                 eta=eta, generator=noise,
                                 return_sequence=return_sequence, device=device,
                                 cache_interval=cache_interval, cache_mode=cache_mode,
                                 cache_threshold=cache_threshold,
                                 cache_tokens=cache_tokens)


def super_resolve(model, low_res, *, level: int, return_sequence: bool = False,
                  device=None, **later) -> torch.Tensor:
    """Training-free super-resolution: the low-res input IS the cold
    degradation at ``level`` (nearest-downsampling is the cold operator), so
    upsample it into the sampler's state space and run the cold loop from
    that level down. With a 1×1 input and the full level count this is
    exactly ``cold_sample``. Served form: ``SamplerConfig(sampler="cold",
    task="superres", levels=level)`` + ``submit(x_init=superres_init(...))``;
    :func:`superres_project` makes the result consistent with the input."""
    x_init = degrade.upsample_nearest(low_res, model.img_size[0])
    return sampling.cold_sample(model, x_init=x_init, levels=int(level),
                                return_sequence=return_sequence, device=device,
                                **later)


def draft_to_drawing(model, generator: torch.Generator, draft, *,
                     t_start: int = 1800, k: int = 10,
                     return_sequence: bool = False, device=None,
                     **later) -> torch.Tensor:
    """The reference's headline app (ViT_draft2drawing.py:394-408):
    forward-noise a rough draft to an intermediate ``t_start``, then DDIM
    back down; the sampler keeps the draft's layout and invents the detail.
    Served form: ``SamplerConfig(task="draft", t_start=)`` +
    ``submit(seed=, x_init=draft)``."""
    encoded = draft_init(generator, draft, t_start, model.total_steps)
    return sampling.sample_from(model, encoded, t_start, k=k,
                                return_sequence=return_sequence, device=device,
                                **later)


#: slerp interpolation as a task: the direct form is
#: ``ops/sampling.slerp_interpolate`` itself; the served form is
#: ``SamplerConfig(task="interp", t_start=)`` + ``submit(seed=,
#: x_init=np.stack([img_a, img_b]), n=n_interp)``.
interpolate = sampling.slerp_interpolate


# ------------------------------------------------------------ serve configs

def default_edit_configs(*, k: int = 10, t_start: int = 1800,
                         sr_level: int = 4, preview_every: int = 0) -> list:
    """One ready-to-warm SamplerConfig per editing task: the set a serving
    deployment passes to ``serve.warmup``. The serve import is lazy: this
    module stays below the serve layer."""
    from ddim_cold_torch.serve.batching import SamplerConfig

    return [
        SamplerConfig(task="inpaint", k=k, preview_every=preview_every),
        SamplerConfig(task="superres", sampler="cold", levels=sr_level,
                      preview_every=preview_every),
        SamplerConfig(task="draft", k=k, t_start=t_start,
                      preview_every=preview_every),
        SamplerConfig(task="interp", k=k, t_start=t_start,
                      preview_every=preview_every),
    ]
