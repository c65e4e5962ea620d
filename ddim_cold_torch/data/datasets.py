"""Dataset classes — host-side image pipeline (counterpart of
``ddim_cold_tpu/data/datasets.py``, which replaced diffusion_loader.py).

Both reference datasets keep their exact contracts: ``__getitem__(index,
t=None) → (noisy, target, t)`` with images float32 HWC in [−1, 1], the batch
fast path ``get_batch(indices) → (noisy, target, t)`` (None sends the loader
to the per-item path), and the raw ``get_raw_batch(indices) → (base, t)``
for the device-side corruption path (ops/degrade.py). File listings are
sorted, and per-item randomness (the step t, the Gaussian noise) comes from
a Philox generator keyed by (seed, epoch, index), so every sample — and
every batch the loader builds — is the one the JAX package builds from the
same folder.

Decode tiers, as in JAX: with ``use_native`` (the default) the C++ library
(``data/native.py``) decodes, resizes and degrades in its own threads; a
file it rejects (a format other than jpg/png, a PNG with alpha or 16 bits,
a corrupt file) goes through PIL (imported inside :func:`pil_loader`) and
the reference's bilinear resize in numpy, for that file alone. Both tiers
give the same bytes. Decoded bases are cached in RAM while the caching
datasets of the process fit ``CACHE_BUDGET_BYTES`` (or as ``cache_images``
forces); a dataset whose every file is exactly ``imgSize`` stores and ships
raw uint8 pixels (``_BaseCache``), found by reading the files' headers
with PIL (float32 mode when PIL is missing).

:data:`PIL_DECODES` counts the files decoded by PIL (one site,
:func:`pil_loader`), so a caller can show that the native tier took every
file.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ddim_cold_torch.data import native, resize

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

#: auto-enable the decoded-image cache while all caching datasets in the
#: process together fit in this budget (train + val both auto-enable)
CACHE_BUDGET_BYTES = 2 << 30
#: skip the uint8 header probe (→ float32 mode) above this many files
U8_PROBE_MAX_FILES = 100_000
_cache_reserved = 0  # guarded-by: _cache_lock
_cache_lock = threading.Lock()

#: files decoded by the PIL tier, counted in :func:`pil_loader`
PIL_DECODES: collections.Counter = collections.Counter()
_PIL_LOCK = threading.Lock()

def pil_loader(path: str):
    """Open an image file and force RGB (reference diffusion_loader.py:17-21).
    PIL is the last decode tier, so its failures are terminal: they re-raise
    with the path attached."""
    from PIL import Image

    with _PIL_LOCK:
        PIL_DECODES["files"] += 1
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


def _load_base(path: str, img_size: Sequence[int], use_native: bool = True) -> np.ndarray:
    """jpg → float32 HWC in [−1, 1]: to_tensor (÷255) → bilinear resize →
    ·2−1 (reference diffusion_loader.py:47-49 order), through the native
    decoder when it takes the file, else PIL and numpy."""
    hw = (int(img_size[0]), int(img_size[1]))
    if use_native:
        out = native.load_base(path, hw)
        if out is not None:
            return out
    img = np.asarray(pil_loader(path), dtype=np.float32) / 255.0
    return resize.resize_bilinear(img, hw) * 2.0 - 1.0


class _BaseCache:
    """The decoded-base-image cache both dataset classes share.

    Entries are keyed by index and stored raw-preferred: uint8 RGB when the
    dataset is uniform (every file decodes at exactly ``img_size``: no
    resize, 4× less RAM, and the uint8 transfer path ships these bytes to
    the device), float32 HWC [−1, 1] otherwise. ``_normalize`` converts on
    read with the host pipeline's op order, so both forms are
    interchangeable. Concurrent misses may both decode; the contents are
    identical (the native and PIL tiers are bit-exact)."""

    def _probe_uniform_u8(self) -> bool:
        """True when every file's header size equals img_size (raw uint8
        storage and transfer apply). Decided per dataset, never per batch,
        and only with the native tier's ``ddim_decode_batch`` (the only
        source of u8 entries), and headers read by PIL (False without it).
        The first header short-circuits a dataset that needs resizing;
        above U8_PROBE_MAX_FILES the probe is skipped."""
        if not (self.use_native and native.has_decode_batch()):
            return False
        if len(self.imgList) > U8_PROBE_MAX_FILES:
            return False
        try:
            from PIL import Image
        except ImportError:  # no header reader: float32 mode, still exact
            return False
        want = (int(self.img_size[1]), int(self.img_size[0]))  # PIL is (w, h)

        def ok(name: str) -> bool:
            try:
                with Image.open(os.path.join(self.root, name)) as im:
                    return im.size == want
            except Exception:  # noqa: BLE001 — any failure means "probe says no"
                return False

        if not ok(self.imgList[0]):
            return False
        with ThreadPoolExecutor(8) as pool:  # chunked: a mismatch bails early
            for lo in range(1, len(self.imgList), 1024):
                if not all(pool.map(ok, self.imgList[lo:lo + 1024])):
                    return False
        return True

    def _init_cache(self, cache_images: Optional[bool], n_items: int,
                    img_size: Sequence[int]) -> None:
        global _cache_reserved
        self._uniform_u8 = self._probe_uniform_u8()
        est = n_items * int(img_size[0]) * int(img_size[1]) * 3 * (
            1 if self._uniform_u8 else 4)
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

    @staticmethod
    def _normalize(entry: np.ndarray) -> np.ndarray:
        """uint8 entry → float32 [−1,1] with ``_load_base``'s op order (÷255
        then ·2−1); float entries pass through."""
        if entry.dtype == np.uint8:
            return (entry.astype(np.float32) / 255.0) * 2.0 - 1.0
        return entry

    def _load_raw(self, path: str) -> np.ndarray:
        """One file through PIL, raw-preferred: uint8 when it decodes at
        exactly img_size, else the float [−1,1] resize pipeline."""
        img = pil_loader(path)
        if (img.height, img.width) == tuple(self.img_size):
            return np.asarray(img, dtype=np.uint8)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return resize.resize_bilinear(arr, tuple(self.img_size)) * 2.0 - 1.0

    def _base(self, index: int) -> np.ndarray:
        """Decoded+resized float32 base image for one item, through the cache."""
        hit = self._cache.get(index) if self.cache_images else None
        if hit is not None:
            return self._normalize(hit)
        if self.use_native:
            return self._normalize(self._raw_entries([index], num_threads=1)[0])
        img = _load_base(os.path.join(self.root, self.imgList[index]), self.img_size,
                         use_native=False)
        if self.cache_images:
            self._cache[index] = img
        return img

    def _raw_entries(self, indices: Sequence[int], num_threads: int,
                     pool=None) -> list[np.ndarray]:
        """Cache entries (u8 or f32) for a batch. Misses fill in three
        tiers: the C++ u8 decode (exact-size files, uniform datasets only) →
        the C++ f32 decode+resize (never in u8 mode: a runtime failure must
        not flip the pinned batch dtype) → PIL per file, fanned over
        ``pool``."""
        missing = ([i for i in indices if int(i) not in self._cache]
                   if self.cache_images else list(indices))
        got: dict[int, np.ndarray] = {}
        if missing:
            paths = [os.path.join(self.root, self.imgList[int(i)]) for i in missing]
            if self._uniform_u8:
                res = native.decode_batch(paths, self.img_size, num_threads=num_threads)
                if res is not None:
                    u8, failed = res
                    for j, i in enumerate(missing):
                        if not failed[j]:
                            got[int(i)] = u8[j]
            left = [(j, int(i)) for j, i in enumerate(missing) if int(i) not in got]
            if left and not self._uniform_u8:
                res = native.base_batch([paths[j] for j, _ in left], self.img_size,
                                        num_threads=num_threads)
                if res is not None:
                    f32, failed = res
                    for k, (_, i) in enumerate(left):
                        if not failed[k]:
                            got[i] = f32[k]
                left = [(j, i) for j, i in left if i not in got]
            if left:  # formats native rejects → PIL
                mapper = pool.map if pool is not None else map
                for (j, i), entry in zip(
                        left, mapper(self._load_raw, [paths[j] for j, _ in left])):
                    got[i] = entry
            if self.cache_images:
                # copies: the entries are views into the batch buffers
                self._cache.update({k: v.copy() for k, v in got.items()})
        if self.cache_images:
            return [self._cache[int(i)] for i in indices]
        return [got[int(i)] for i in indices]

    def _raw_bases(self, indices: Sequence[int], num_threads: int,
                   pool=None) -> np.ndarray:
        """Stacked bases for the device-corruption path, dtype pinned per
        dataset: uint8 for uniform datasets, float32 [−1,1] otherwise."""
        if self.use_native:
            entries = self._raw_entries(indices, num_threads, pool=pool)
        else:  # per item through the cache, fanned over the loader's pool
            mapper = pool.map if pool is not None else map
            entries = list(mapper(self._base, map(int, indices)))
        if self._uniform_u8:
            bad = [int(i) for i, e in zip(indices, entries) if e.dtype != np.uint8]
            if bad:
                raise RuntimeError(
                    f"dataset pinned uint8 but indices {bad[:8]} decoded to a "
                    "different dtype — files mutated after the header probe; "
                    "rebuild the dataset or reopen it to re-probe")
            return np.stack(entries)
        return np.stack([self._normalize(e) for e in entries])

    def _bases_for(self, indices: Sequence[int], num_threads: int,
                   pool=None) -> np.ndarray:
        """Batch of float32 [−1,1] bases (the host-degrade contract)."""
        return np.stack([self._normalize(e)
                         for e in self._raw_entries(indices, num_threads, pool=pool)])

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
                 seed: int = 0, use_native: bool = True,
                 cache_images: Optional[bool] = None):
        self.root = root
        self.img_size = tuple(int(s) for s in imgSize)
        self.max_step = max_step
        self.seed = seed
        self.use_native = use_native
        self.epoch = 0
        self.imgList = _list_images(root)
        self._init_cache(cache_images, len(self.imgList), self.img_size)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(np.random.SeedSequence([self.seed, self.epoch, index, 0xD1FF])))

    def _noise_for(self, index: int, img: np.ndarray, t: Optional[int]):
        """(t, x_t) from the per-(seed, epoch, index) Philox stream — t is
        drawn before the noise, so both decode tiers see the same draws."""
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

    def get_raw_batch(self, indices: Sequence[int], num_threads: int = 8, pool=None):
        """Device-side-corruption path: ``(x₀, t)`` — clean bases (uint8 for
        a uniform dataset) plus per-sample steps from the same Philox stream
        as the host path; the forward noising happens on the device
        (ops/degrade.make_gaussian_prepare)."""
        ts = np.asarray([int(self._rng(int(i)).integers(self.max_step))
                         for i in indices], np.int32)
        return self._raw_bases(indices, num_threads, pool=pool), ts

    def get_batch(self, indices: Sequence[int], num_threads: int = 8, pool=None):
        """Batch fast path: decode+resize in C++ threads (through the cache),
        noise in numpy; collated ``(noisy, target, t)``, or None (native
        off) for the loader's per-item path. ``pool`` fans the PIL tier."""
        if not self.use_native:
            return None
        base = self._bases_for(indices, num_threads, pool=pool)
        noisy = np.empty_like(base)
        ts = np.empty(len(base), np.int32)
        for j, i in enumerate(indices):
            ts[j], noisy[j] = self._noise_for(int(i), base[j], None)
        return noisy, base, ts


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
                 target_mode: str = "chain", seed: int = 0, use_native: bool = True,
                 cache_images: Optional[bool] = None):
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
        self.use_native = use_native
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

    def _degrade_pair(self, img: np.ndarray, t: int):
        """(D(x,t), target) from a decoded base (numpy nearest-resize)."""
        noisy = self.get_t(img, 2**t)
        target = self.get_t(img, 2 ** (t - 1)) if self.target_mode == "chain" else img
        return noisy.astype(np.float32), target.astype(np.float32)

    def _pil_item(self, index: int, t: int):
        img = _load_base(os.path.join(self.root, self.imgList[index]), self.img_size,
                         use_native=False)
        return (*self._degrade_pair(img, t), t)

    def __getitem__(self, index: int, t: Optional[int] = None):
        if t is None:
            t = self._draw_t(index)
        if self.cache_images:  # cached base + numpy degrade
            return (*self._degrade_pair(self._base(index), t), t)
        if self.use_native:  # decode → resize → degrade in one C++ call
            res = native.cold_item(os.path.join(self.root, self.imgList[index]),
                                   self.size, t, self.target_mode == "chain")
            if res is not None:
                return res[0], res[1], t
        return self._pil_item(index, t)

    def get_batch(self, indices: Sequence[int], num_threads: int = 8, pool=None):
        """Batch fast path: decode, resize, degrade and collate in C++
        threads (the decode through the cache when it is on); failed slots
        redone through PIL with the same t. ``(noisy, target, t)``, or None
        (native off, or no file of the batch native) for the loader's
        per-item path. ``pool`` fans the PIL tier."""
        if not self.use_native:
            return None
        ts = [self._draw_t(int(i)) for i in indices]
        chain = self.target_mode == "chain"
        if self.cache_images:
            base = self._bases_for(indices, num_threads, pool=pool)
            pair = native.cold_pair_batch(base, ts, chain, num_threads=num_threads)
            if pair is None:
                pair = [np.stack(p) for p in zip(*(self._degrade_pair(base[j], ts[j])
                                                   for j in range(len(ts))))]
            return pair[0], pair[1], np.asarray(ts, np.int32)
        paths = [os.path.join(self.root, self.imgList[int(i)]) for i in indices]
        res = native.cold_batch(paths, ts, self.size, chain, num_threads=num_threads)
        if res is None:
            return None
        noisy, target, failed = res
        if failed.all():  # nothing native in this batch → per-item path
            return None
        for j, i in enumerate(indices):
            if failed[j]:
                noisy[j], target[j], _ = self._pil_item(int(i), ts[j])
        return noisy, target, np.asarray(ts, np.int32)

    def get_raw_batch(self, indices: Sequence[int], num_threads: int = 8, pool=None):
        """Device-side-corruption path: ``(base, t)`` — the clean decoded
        bases (uint8 for a uniform dataset) plus the per-sample steps, with
        no host degradation; the train step rebuilds ``(D(x,t), target, t)``
        on the device with bit-identical gathers
        (ops/degrade.make_cold_prepare). ``t`` comes from the same
        per-(seed, epoch, index) stream as the host path."""
        ts = np.asarray([self._draw_t(int(i)) for i in indices], np.int32)
        return self._raw_bases(indices, num_threads, pool=pool), ts
