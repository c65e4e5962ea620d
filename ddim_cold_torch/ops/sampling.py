"""Samplers: the k-strided DDIM loop and its guided entry points.

Counterpart of the deterministic core of ``ddim_cold_tpu/ops/sampling.py``:

* ``ddim_sample``      ← reference ``sampler`` (ViT.py:220-237)
* ``ddim_sample(..., return_sequence=True)`` ← ``diffusion_sequence`` (ViT.py:239-256)
* ``sample_from``      ← the draft2drawing inner loop (ViT_draft2drawing.py:394-408)
* ``forward_noise``    ← ``√(1−ᾱ)·ε + √ᾱ·x`` (ViT_draft2drawing.py:395-396)

Each reverse step is affine in (x, x̂0) with coefficients precomputed on the
host (:mod:`ddim_cold_torch.ops.schedule`), so the step body is one model
forward, a clamp and two multiply-adds, with no host synchronisation inside
the loop (no ``.item()``, no copies to the host): the whole loop enqueues
asynchronously on the device and can later be captured in a CUDA graph. It
runs under ``torch.inference_mode()``: no autograd history is recorded.

Randomness comes from an explicit ``torch.Generator`` living on the
sampling device; it cannot reproduce JAX's bits, so parity with the JAX
package runs through ``x_init``. The cached, few-step, cold, inpaint and
telemetry variants belong to later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ddim_cold_torch.ops import schedule
from ddim_cold_torch.utils.platform import resolve_device
from ddim_cold_torch.utils.slices import refuse_later

#: sampler options of the JAX ``ddim_sample`` that belong to later slices
_LATER = {
    "mesh": (None, "Queue 1 item 14 (data-parallel sampling)"),
    "cache_interval": (1, "Queue 1 item 8 (step cache)"),
    "cache_mode": ("delta", "Queue 1 item 8 (step cache)"),
    "cache_threshold": (None, "Queue 1 item 8 (adaptive cache)"),
    "cache_tokens": (None, "Queue 1 item 8 (token cache)"),
    "telemetry": (False, "Queue 1 item 8 (step telemetry)"),
}


def _sampling_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = model.device
    if dev.type != have.type or (dev.index is not None and dev.index != have.index):
        raise ValueError(f"model lives on {have}, sampling asked for {dev}")
    return have


def forward_noise(generator: torch.Generator, img: torch.Tensor, t_start: int,
                  total_steps: int = 2000) -> torch.Tensor:
    """Encode a clean image to noise level ``t_start``; ᾱ = 1 − √(t_start/T)
    (no +1, matching the draft2drawing app). ``generator`` lives on img's
    device."""
    alpha = schedule.forward_noise_alpha(t_start, total_steps)
    eps = torch.randn(img.shape, generator=generator, device=img.device,
                      dtype=img.dtype)
    return math.sqrt(alpha) * img + math.sqrt(1.0 - alpha) * eps


@torch.inference_mode()
def ddim_sample(model, generator: Optional[torch.Generator] = None, *,
                k: int = 10, n: int = 128, x_init=None,
                t_start: Optional[int] = None, return_sequence: bool = False,
                eta: float = 0.0, device=None, **later) -> torch.Tensor:
    """k-strided DDIM sampling; returns images in [0, 1], NHWC float32.

    Pass ``generator`` (a fresh N(0, 1) start of ``n`` images, reference
    ViT.py:224) or ``x_init`` (an (n, H, W, C) encoded start, array or
    tensor; never modified). ``return_sequence=True`` returns the
    (n_steps+1, n, H, W, C) trajectory: the start, then every x̂0. ``eta`` >
    0 is stochastic DDIM and draws per-step noise from ``generator``, which
    it then requires. ``device`` (None means ``"cuda"``) must be the
    model's device.
    """
    refuse_later(later, _LATER, "ddim_sample")
    dev = _sampling_device(model, device)
    if eta and generator is None:
        raise ValueError("eta > 0 draws per-step noise — pass generator")
    if x_init is None:
        if generator is None:
            raise ValueError("ddim_sample needs either generator or x_init")
        H, W = model.img_size
        x = torch.randn((n, H, W, model.in_chans), generator=generator,
                        device=dev, dtype=torch.float32)
    else:
        # a private float32 copy on the device: the caller's start survives
        x = torch.as_tensor(x_init).to(device=dev, dtype=torch.float32,
                                       copy=True)
    coeffs = schedule.ddim_coefficients(model.total_steps, k, t_start, eta)
    frames = [x] if return_sequence else None
    x0 = None
    for t, c1, c2, cz in zip(coeffs.t_seq.tolist(), coeffs.cx.tolist(),
                             coeffs.cx0.tolist(), coeffs.cz.tolist()):
        x0 = model(x, torch.full((x.shape[0],), t, dtype=torch.long,
                                 device=dev)).clamp(-1.0, 1.0)
        x_next = c1 * x + c2 * x0
        if eta:
            z = torch.randn(x.shape, generator=generator, device=dev,
                            dtype=x.dtype)
            x_next = x_next + cz * z
        x = x_next
        if return_sequence:
            frames.append(x0)
    if return_sequence:
        return (torch.stack(frames) + 1.0) / 2.0
    if x0 is None:
        raise ValueError(f"empty schedule: total_steps={model.total_steps}, "
                         f"k={k}, t_start={t_start}")
    # the sample is the LAST x̂0 prediction (reference ViT.py:236)
    return (x0 + 1.0) / 2.0


def sample_from(model, x_init, t_start: int, k: int = 10, eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                return_sequence: bool = False, device=None,
                **later) -> torch.Tensor:
    """Guided sampling: DDIM-denoise an encoded image from level ``t_start``
    (a prefix-truncated :func:`ddim_sample`)."""
    return ddim_sample(model, generator, x_init=x_init, t_start=t_start, k=k,
                       eta=eta, return_sequence=return_sequence, device=device,
                       **later)


def cold_sample(*args, **kwargs):
    """Cold-diffusion sampling: not ported yet."""
    raise NotImplementedError("cold_sample is ROADMAP.md Queue 1 item 4 "
                              "(what is left of the deterministic core)")


def ddim_sample_fewstep(*args, **kwargs):
    """Few-step (distilled-student) sampling: not ported yet."""
    raise NotImplementedError("ddim_sample_fewstep is ROADMAP.md Queue 1 item 9")
