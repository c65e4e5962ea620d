"""NumPy image resizing with torch ``F.interpolate`` conventions.

The reference resizes *tensors* through torchvision ``F.resize``
(diffusion_loader.py:48,81-82,89), which dispatches to ``torch.nn.functional
.interpolate``:

* **nearest**: source index = ``floor(dst * in/out)`` (asymmetric convention —
  NOT PIL's pixel-center rounding, and NOT jax.image.resize's half-pixel
  round). The cold degradation operator is built from this, so the convention
  is observable in training targets and must match bit-for-bit.
* **bilinear, antialias=False, align_corners=False**: half-pixel centers,
  ``src = (dst + 0.5)·scale − 0.5`` clamped at 0, 2-tap separable.

Pure NumPy (host data path); the device-side twin lives in
ops/degrade.py and is gather-based with identical index math. The port's
copy of ``ddim_cold_tpu/data/resize.py``, verbatim.
"""

from __future__ import annotations

import numpy as np


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """torch interpolate-nearest source indices: floor(i · in/out)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize of an (H, W, C) or (H, W) array, torch convention."""
    h, w = out_hw
    iy = nearest_indices(h, img.shape[0])
    ix = nearest_indices(w, img.shape[1])
    return img[iy][:, ix]


def _bilinear_weights(out_size: int, in_size: int):
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, None)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    return i0, i1, frac


def resize_bilinear(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize (align_corners=False, no antialias) of (H, W, C) float array."""
    h, w = out_hw
    y0, y1, fy = _bilinear_weights(h, img.shape[0])
    x0, x1, fx = _bilinear_weights(w, img.shape[1])
    img = img.astype(np.float32, copy=False)
    top = img[y0]  # (h, W, C)
    bot = img[y1]
    fy = fy[:, None, None] if img.ndim == 3 else fy[:, None]
    rows = top * (1 - fy) + bot * fy
    left = rows[:, x0]
    right = rows[:, x1]
    fx = fx[None, :, None] if img.ndim == 3 else fx[None, :]
    return left * (1 - fx) + right * fx


def cold_degrade(img: np.ndarray, level_scale: int, size: int) -> np.ndarray:
    """The cold-diffusion degradation D(x, s): nearest-downsample to
    ⌊size/s⌋ then nearest-upsample back (reference diffusion_loader.py:79-83).

    ``level_scale`` is 2^t; s=1 is the identity.
    """
    target = int(np.floor(size / level_scale))
    target = max(target, 1)
    small = resize_nearest(img, (target, target))
    return resize_nearest(small, (size, size))
