"""Device-side cold degradation D(x, t) — the tensor twin of
data/resize.py's host pipeline (counterpart of ``ddim_cold_tpu/ops/degrade.py``).

Index math is identical to the host path (torch interpolate-nearest
convention: src = floor(dst · in/out)), so host-prepared training targets and
on-device degradations agree bit for bit. Down-then-up nearest resize
composes into a single gather per axis, ``idx[i] = down_idx[up_idx[i]]``;
the per-level tables stack into one ``(levels+1, size)`` index table on the
device and a per-sample ``t`` picks its row, so a batch is two gathers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddim_cold_torch.data.resize import nearest_indices


def _level_indices(size: int, level: int) -> np.ndarray:
    """Composed gather indices for one degradation level (2^level)."""
    target = max(int(np.floor(size / (2**level))), 1)
    down = nearest_indices(target, size)  # small ← big
    up = nearest_indices(size, target)  # big ← small
    return down[up]


@functools.lru_cache(maxsize=16)
def _tables(size: int, max_step: int, device: torch.device) -> torch.Tensor:
    """The ``(max_step+1, size)`` int64 index table, built once per device
    (a training step degrades twice; neither copies it to the device)."""
    table = np.stack([_level_indices(size, lv) for lv in range(max_step + 1)])
    return torch.from_numpy(table).to(device)


def cold_degrade(imgs: torch.Tensor, t: torch.Tensor, *, size: int,
                 max_step: int = 6) -> torch.Tensor:
    """D(x, t) for a batch: (B, H, W, C), per-sample int t ∈ [0, max_step].

    t=0 is the identity (the reference's D(x, 2^0) — two identity resizes,
    diffusion_loader.py:94-95 with t−1=0). A t outside [0, max_step] raises
    (the index table has no row for it).
    """
    idx = _tables(size, max_step, imgs.device)[t.to(imgs.device).long()]  # (B, size)
    B, H, W, C = imgs.shape
    rows = torch.gather(imgs, 1, idx[:, :, None, None].expand(B, size, W, C))
    return torch.gather(rows, 2, idx[:, None, :, None].expand(B, size, size, C))


def upsample_nearest(imgs, size: int) -> torch.Tensor:
    """Nearest-upsample (B, h, w, C) → (B, size, size, C), torch convention;
    an (h, w, C) image gains a batch axis. Arrays become float32 tensors on
    the CPU; tensors keep their device.

    The "up" half of the cold degradation on its own: for a low-res image
    ``lo = nearest-downsample(x, level)``, ``upsample_nearest(lo, size)`` IS
    ``cold_degrade(x, level)``, the degraded full-size state the cold
    sampler starts from. The super-resolution workload
    (``ddim_cold_torch.workloads``) lifts a user's low-res input into the
    sampler's state space with it; a constant-colour 1×1 input reproduces
    ``cold_sample``'s broadcast init exactly.
    """
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    if imgs.ndim == 3:
        imgs = imgs[None]
    iy = torch.from_numpy(nearest_indices(size, imgs.shape[1])).to(imgs.device)
    ix = torch.from_numpy(nearest_indices(size, imgs.shape[2])).to(imgs.device)
    return imgs[:, iy][:, :, ix]


def normalize_base(base: torch.Tensor) -> torch.Tensor:
    """Raw base image → float32 in [−1, 1] with the host pipeline's exact op
    order (÷255 then ·2−1, datasets._load_base) so a uint8-shipped batch is
    bit-identical to the host-normalized float path. Float input passes
    through (already normalized host-side)."""
    if base.dtype == torch.uint8:
        return base.float() / 255.0 * 2.0 - 1.0
    return base


def make_cold_prepare(size: int, max_step: int, chain: bool):
    """Batch corruption for the device-side cold data path.

    The host ships only ``(base, t)`` — one clean image per sample instead of
    the two degraded float copies — and this hook (train/step.py ``prepare``)
    rebuilds the exact host contract ``(D(x,t), D(x,t−1)|x₀, t)`` on the
    device. The degradation is a pure gather, so the result is bit-identical
    to the host pipeline. ``generator`` is unused: cold corruption is
    deterministic given (base, t).
    """

    def prepare(batch, generator=None):
        del generator
        base, t = batch
        x = normalize_base(base)
        t = t.to(x.device)
        noisy = cold_degrade(x, t, size=size, max_step=max_step)
        target = cold_degrade(x, t - 1, size=size, max_step=max_step) if chain else x
        return noisy, target, t

    return prepare


def make_gaussian_prepare(total_steps: int):
    """Gaussian forward-noising for the device-side data path (C13).

    The host ships ``(x₀, t)`` with t from the same Philox stream as the host
    pipeline (identical noising *schedule*); ε is drawn on the device from the
    step's ``torch.Generator`` under ᾱ(t) = 1 − √((t+1)/T) (reference
    diffusion_loader.py:52-54). The noise bits differ from the host path and
    from JAX's: statistically identical, not bit-identical.
    """

    def prepare(batch, generator: torch.Generator):
        base, t = batch
        x = normalize_base(base)
        t = t.to(x.device)
        alpha = 1.0 - torch.sqrt((t.float() + 1.0) / total_steps)
        alpha = alpha[:, None, None, None]
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=torch.float32)
        noisy = torch.sqrt(alpha) * x + torch.sqrt(1.0 - alpha) * noise
        return noisy, x, t

    return prepare
