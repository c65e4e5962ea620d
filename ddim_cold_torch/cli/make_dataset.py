"""``python -m ddim_cold_torch make-dataset``: the deterministic
surrogate-flowers dataset (a copy of the JAX package's committed recipe,
``scripts/make_dataset.py``, with PIL imported inside :func:`write_split`).

The reference trained on 64px Oxford Flowers (512 train / 85 val batches at
effective batch 32); without network access the real dataset cannot be
fetched, so this is the recipe for a procedural surrogate of the same scale
and spirit: radially symmetric "flowers" (petal lobes with veins and a
speckled centre disc) over smooth gradient backgrounds. Their coarse
structure survives a downsampled view while veins, speckle and JPEG grain
do not — the signal the cold downsample-restoration task needs.

Every pixel is a pure function of (seed, split, index), so for the same
``--seed``, ``--size``, ``--train`` and ``--val`` every file is byte for
byte the JAX recipe's. ``--out`` (default ``OxfordFlowers``) is relative to
the working directory.

    python -m ddim_cold_torch make-dataset --out OxfordFlowers            # full scale
    python -m ddim_cold_torch make-dataset --out d --train 64 --val 32    # smoke
"""

from __future__ import annotations

import argparse
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

#: reference dataset scale: 512 train / 85 val batches @ effective batch 32
TRAIN_N = 512 * 32
VAL_N = 85 * 32


def _unit_grid(size: int):
    ax = (np.arange(size) + 0.5) / size
    return np.meshgrid(ax, ax, indexing="xy")  # x (cols), y (rows) in [0,1]


def generate_image(rng: np.random.Generator, size: int = 64) -> np.ndarray:
    """One surrogate flower, uint8 (size, size, 3)."""
    x, y = _unit_grid(size)

    # background: diagonal blend of two muted colors + low-frequency waves
    c0 = rng.uniform(0.15, 0.75, 3)
    c1 = rng.uniform(0.15, 0.75, 3)
    ang = rng.uniform(0, 2 * np.pi)
    ramp = (np.cos(ang) * x + np.sin(ang) * y + 1.0) / 2.0
    img = ramp[..., None] * c0 + (1.0 - ramp[..., None]) * c1
    for _ in range(2):
        fx, fy = rng.uniform(1.5, 4.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * fx * x + ph[0]) * np.sin(
            2 * np.pi * fy * y + ph[1])
        img += 0.08 * wave[..., None] * (rng.uniform(-1, 1, 3))

    # one or two green-ish leaf blobs behind the flower
    for _ in range(rng.integers(1, 3)):
        lx, ly = rng.uniform(0.15, 0.85, 2)
        lr = rng.uniform(0.12, 0.22)
        d2 = ((x - lx) ** 2 + (y - ly) ** 2) / lr**2
        mask = np.exp(-d2 * 1.8)
        leaf = np.array([rng.uniform(0.05, 0.2), rng.uniform(0.35, 0.6),
                         rng.uniform(0.08, 0.25)])
        img = img * (1 - mask[..., None]) + leaf * mask[..., None]

    # flower geometry: petal lobes r(θ) with a sharpness exponent
    cx, cy = rng.uniform(0.35, 0.65, 2)
    n_pet = int(rng.integers(5, 13))
    base_r = rng.uniform(0.22, 0.34)
    sharp = rng.uniform(0.8, 2.5)
    phase = rng.uniform(0, 2 * np.pi)
    dx, dy = x - cx, y - cy
    r = np.sqrt(dx * dx + dy * dy)
    th = np.arctan2(dy, dx)
    lobes = np.abs(np.cos(n_pet / 2.0 * th + phase)) ** sharp
    petal_r = base_r * (0.45 + 0.55 * lobes)
    petal = np.clip((petal_r - r) / (0.035 * base_r / 0.28), 0.0, 1.0)  # soft edge

    pc_in = rng.uniform(0.45, 1.0, 3)   # color near the center
    pc_out = rng.uniform(0.25, 1.0, 3)  # color at the petal tips
    radial = np.clip(r / np.maximum(petal_r, 1e-6), 0, 1)
    pc = pc_in + (pc_out - pc_in) * radial[..., None]
    # veins: fine angular stripes that fade toward the rim (high-freq detail
    # destroyed by downsampling — the restoration target)
    veins = 0.5 + 0.5 * np.sin((3 * n_pet) * th + 2 * phase)
    pc = pc * (1.0 - 0.18 * (veins * (1 - radial))[..., None])
    img = img * (1 - petal[..., None]) + pc * petal[..., None]

    # center disc with speckle
    disc_r = base_r * rng.uniform(0.22, 0.38)
    disc = np.clip((disc_r - r) / (0.3 * disc_r), 0, 1)
    dc = rng.uniform(0.0, 1.0) * np.array([1.0, 0.85, 0.2]) + rng.uniform(0, 0.15, 3)
    speck = rng.random((size, size))
    dc_px = dc[None, None, :] * (0.75 + 0.25 * speck[..., None])
    img = img * (1 - disc[..., None]) + dc_px * disc[..., None]

    # mild sensor-ish noise so val/train aren't noiseless manifolds
    img += rng.normal(0.0, 0.01, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_split(out_dir: str, split: str, n: int, size: int, seed: int,
                quality: int = 92, threads: int = 16) -> None:
    from PIL import Image

    d = os.path.join(out_dir, split)
    os.makedirs(d, exist_ok=True)

    def one(i: int):
        # seed sequence keyed by (seed, split, i): order/parallelism-invariant
        # (crc32, not hash() — str hashing is salted per process)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, zlib.crc32(split.encode()), i]))
        img = generate_image(rng, size)
        Image.fromarray(img).save(os.path.join(d, f"{split}_{i:06d}.jpg"),
                                  quality=quality)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(n)))


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch make-dataset")
    ap.add_argument("--out", default="OxfordFlowers")
    ap.add_argument("--train", type=int, default=TRAIN_N)
    ap.add_argument("--val", type=int, default=VAL_N)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20220822)
    args = ap.parse_args(list(argv))
    out = os.path.join(base_dir, args.out) if base_dir else args.out
    write_split(out, "train", args.train, args.size, args.seed)
    write_split(out, "val", args.val, args.size, args.seed)
    print(f"wrote {args.train} train + {args.val} val {args.size}px jpgs to {args.out}/")
    return 0
