"""Dataset classes — host-side image pipeline (counterpart of
``ddim_cold_tpu/data/datasets.py``, which replaced diffusion_loader.py).

Both reference datasets keep their exact contracts: ``__getitem__(index,
t=None) → (noisy, target, t)`` with images float32 HWC in [−1, 1], and the
raw ``get_raw_batch(indices) → (base, t)`` for the device-side corruption
path (ops/degrade.py). File listings are sorted, and per-item randomness
(the step t, the Gaussian noise) comes from a Philox generator keyed by
(seed, epoch, index), so every sample — and every batch the loader builds —
is the one the JAX package builds from the same folder.

Decode tier: PIL (imported inside the decode function) then the reference's
bilinear resize in numpy. The JAX package's C++ decode tier
(``native/libddim_data.so``) is not ported yet: ``use_native=True`` raises,
naming its ROADMAP.md item. Decoded base images are cached in RAM while the
caching datasets of the process fit ``CACHE_BUDGET_BYTES`` (or as
``cache_images`` forces).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional, Sequence

import numpy as np

from ddim_cold_torch.data import resize

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

#: auto-enable the decoded-image cache while all caching datasets in the
#: process together fit in this budget (train + val both auto-enable)
CACHE_BUDGET_BYTES = 2 << 30
_cache_reserved = 0  # guarded-by: _cache_lock
_cache_lock = threading.Lock()

_NATIVE_ITEM = "Queue 1 item 11 (training: the native C++ decode tier)"


def _refuse_native(use_native: bool) -> None:
    if use_native:
        raise NotImplementedError(f"use_native=True is not ported yet: ROADMAP.md {_NATIVE_ITEM}")


def pil_loader(path: str):
    """Open an image file and force RGB (reference diffusion_loader.py:17-21).
    Decode failures re-raise with the path attached."""
    from PIL import Image

    with open(path, "rb") as f:
        try:
            return Image.open(f).convert("RGB")
        except Exception as e:  # noqa: BLE001 — re-raised below with the path attached
            e.args = (f"{path}: " + (str(e.args[0]) if e.args else repr(e)),
                      *e.args[1:])
            raise


def _list_images(root: str) -> list[str]:
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"dataset folder {root!r} does not exist — point the yaml's "
            "dataStorage at a folder of images")
    names = sorted(
        n for n in os.listdir(root) if os.path.splitext(n)[1].lower() in _IMG_EXTS)
    if not names:
        raise FileNotFoundError(f"no image files in {root!r}")
    return names


def _load_base(path: str, img_size: Sequence[int]) -> np.ndarray:
    """jpg → float32 HWC in [−1, 1]: to_tensor (÷255) → bilinear resize →
    ·2−1 (reference diffusion_loader.py:47-49 order)."""
    hw = (int(img_size[0]), int(img_size[1]))
    img = np.asarray(pil_loader(path), dtype=np.float32) / 255.0
    return resize.resize_bilinear(img, hw) * 2.0 - 1.0


class _BaseCache:
    """The decoded-base-image cache both dataset classes share: float32 HWC
    [−1, 1] entries keyed by index, decoded on first use."""

    def _init_cache(self, cache_images: Optional[bool], n_items: int,
                    img_size: Sequence[int]) -> None:
        global _cache_reserved
        est = n_items * int(img_size[0]) * int(img_size[1]) * 3 * 4
        with _cache_lock:
            if cache_images is None:  # the budget is process-wide
                cache_images = _cache_reserved + est <= CACHE_BUDGET_BYTES
            if cache_images:
                _cache_reserved += est
        self.cache_images = bool(cache_images)
        self._cache_reservation = est if self.cache_images else 0
        self._cache: dict[int, np.ndarray] = {}

    def __del__(self):
        global _cache_reserved
        res = getattr(self, "_cache_reservation", 0)
        if res:
            with _cache_lock:
                _cache_reserved -= res

    def _base(self, index: int) -> np.ndarray:
        """Decoded+resized float32 base image for one item, through the cache.
        Concurrent misses may both decode; the contents are identical."""
        hit = self._cache.get(index) if self.cache_images else None
        if hit is not None:
            return hit
        img = _load_base(os.path.join(self.root, self.imgList[index]), self.img_size)
        if self.cache_images:
            self._cache[index] = img
        return img

    def _raw_bases(self, indices: Sequence[int], pool=None) -> np.ndarray:
        """Stacked float32 bases for the device-corruption path, fanned over
        the loader's pool when given."""
        mapper = pool.map if pool is not None else map
        return np.stack(list(mapper(self._base, map(int, indices))))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.imgList)


class DiffusionDataset(_BaseCache):
    """Gaussian forward-noising dataset (reference diffusion_loader.py:24-58).

    ``__getitem__ → (x_t, x_0, t)`` with t ~ U[0, max_step) and
    x_t = √ᾱ·x0 + √(1−ᾱ)·ε under ᾱ = 1 − √((t+1)/T).
    """

    def __init__(self, root: str, imgSize: Sequence[int] = (32, 32), max_step: int = 2000,
                 seed: int = 0, use_native: bool = False,
                 cache_images: Optional[bool] = None):
        _refuse_native(use_native)
        self.root = root
        self.img_size = tuple(int(s) for s in imgSize)
        self.max_step = max_step
        self.seed = seed
        self.epoch = 0
        self.imgList = _list_images(root)
        self._init_cache(cache_images, len(self.imgList), self.img_size)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(np.random.SeedSequence([self.seed, self.epoch, index, 0xD1FF])))

    def _noise_for(self, index: int, img: np.ndarray, t: Optional[int]):
        """(t, x_t) from the per-(seed, epoch, index) Philox stream — t is
        drawn before the noise."""
        rng = self._rng(index)
        drawn = int(rng.integers(self.max_step))
        if t is None:
            t = drawn
        alpha = 1.0 - math.sqrt((t + 1) / self.max_step)
        noise = rng.standard_normal(img.shape).astype(np.float32)
        noisy = math.sqrt(alpha) * img + math.sqrt(1.0 - alpha) * noise
        return t, noisy.astype(np.float32)

    def __getitem__(self, index: int, t: Optional[int] = None):
        img = self._base(index)
        t, noisy = self._noise_for(index, img, t)
        return noisy, img.astype(np.float32), t

    def get_raw_batch(self, indices: Sequence[int], pool=None):
        """Device-side-corruption path: ``(x₀, t)`` — clean bases plus
        per-sample steps from the same Philox stream as the host path; the
        forward noising happens on the device (ops/degrade.
        make_gaussian_prepare)."""
        ts = np.asarray([int(self._rng(int(i)).integers(self.max_step))
                         for i in indices], np.int32)
        return self._raw_bases(indices, pool=pool), ts


class ColdDownSampleDataset(_BaseCache):
    """Cold (downsampling) degradation dataset (reference diffusion_loader.py:60-138).

    ``target_mode``:
      * ``"chain"`` (default — what the trainer uses, multi_gpu_trainer.py:5,59):
        returns ``(D(x,t), D(x,t−1), t)`` — one-level restoration targets.
      * ``"direct"`` (the ``_au`` paper variant, diffusion_loader.py:99-138):
        returns ``(D(x,t), x_0, t)`` — direct clean-image targets.

    max_step = log2(size) (6 for 64px, 7 for 200px); t ∈ [1, max_step]; the
    degradation is nearest-resize down to ⌊size/2^t⌋ then nearest back up,
    torch interpolate index convention (data/resize.py).
    """

    def __init__(self, root: str, imgSize: Sequence[int] = (32, 32),
                 target_mode: str = "chain", seed: int = 0, use_native: bool = False,
                 cache_images: Optional[bool] = None):
        _refuse_native(use_native)
        if imgSize[0] != imgSize[1]:
            raise ValueError("downsample dataset requires square images")
        if target_mode not in ("chain", "direct"):
            raise ValueError(f"unknown target_mode {target_mode!r}")
        self.root = root
        self.img_size = tuple(int(s) for s in imgSize)
        self.size = int(imgSize[0])
        self.max_step = int(np.log2(self.size))
        self.target_mode = target_mode
        self.seed = seed
        self.epoch = 0
        self.imgList = _list_images(root)
        self._init_cache(cache_images, len(self.imgList), self.img_size)

    def get_t(self, img: np.ndarray, level_scale: int) -> np.ndarray:
        """D(x, s) for s = 2^t (reference diffusion_loader.py:79-83)."""
        return resize.cold_degrade(img, level_scale, self.size)

    def _draw_t(self, index: int) -> int:
        rng = np.random.Generator(
            np.random.Philox(np.random.SeedSequence([self.seed, self.epoch, index, 0xC01D])))
        return int(rng.integers(self.max_step)) + 1  # t ∈ [1, max_step]

    def __getitem__(self, index: int, t: Optional[int] = None):
        if t is None:
            t = self._draw_t(index)
        img = self._base(index)
        noisy = self.get_t(img, 2**t)
        target = self.get_t(img, 2 ** (t - 1)) if self.target_mode == "chain" else img
        return noisy.astype(np.float32), target.astype(np.float32), t

    def get_raw_batch(self, indices: Sequence[int], pool=None):
        """Device-side-corruption path: ``(base, t)`` — the clean decoded
        bases plus the per-sample steps, with no host degradation; the train
        step rebuilds ``(D(x,t), target, t)`` on the device with bit-identical
        gathers (ops/degrade.make_cold_prepare). ``t`` comes from the same
        per-(seed, epoch, index) stream as the host path."""
        ts = np.asarray([self._draw_t(int(i)) for i in indices], np.int32)
        return self._raw_bases(indices, pool=pool), ts
