"""Image grid rendering and the output-path helper of the commands
(counterpart of ``ddim_cold_tpu/utils/image.py``).

``save_grid`` tiles images into one PNG with PIL, in place of the
reference's matplotlib ImageGrid figures (ViT.py:283-305). ``get_next_path``
is the reference's intent with its infinite loop fixed (ViT.py:307-313
never increments ``i``). PIL is imported inside ``save_grid`` only.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float HWC → uint8."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _host(images) -> np.ndarray:
    """An array or a tensor (any device) as a numpy array, in one copy."""
    if hasattr(images, "detach"):
        return images.detach().float().cpu().numpy()
    return np.asarray(images)


def save_grid(images, path: str, *, nrows: int, ncols: int, pad: int = 2) -> str:
    """Tile (N, H, W, C) images in [0,1] (an array, or a tensor on any
    device, moved to the host once) into an nrows×ncols grid PNG."""
    from PIL import Image

    images = _host(images)
    n, h, w, c = images.shape
    canvas = np.full(
        (nrows * h + (nrows - 1) * pad, ncols * w + (ncols - 1) * pad, c), 255, np.uint8
    )
    for idx in range(min(n, nrows * ncols)):
        r, col = divmod(idx, ncols)
        y, x = r * (h + pad), col * (w + pad)
        canvas[y : y + h, x : x + w] = to_uint8(images[idx])
    Image.fromarray(canvas.squeeze()).save(path)
    return path


def grid_tiles(path: str, n: int, *, nrows: int, ncols: int, pad: int = 2) -> np.ndarray:
    """The first ``n`` uint8 tiles of a grid :func:`save_grid` wrote, read
    back from the PNG: (n, h, w, C)."""
    from PIL import Image

    canvas = np.asarray(Image.open(path))
    if canvas.ndim == 2:
        canvas = canvas[..., None]
    h = (canvas.shape[0] - (nrows - 1) * pad) // nrows
    w = (canvas.shape[1] - (ncols - 1) * pad) // ncols
    tiles = []
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y, x = r * (h + pad), col * (w + pad)
        tiles.append(canvas[y : y + h, x : x + w])
    return np.stack(tiles)


def grid_shape(n: int) -> tuple[int, int]:
    """(nrows, ncols) for tiling n images: ⌊√n⌋ columns, rows ceil-divided so
    every sample is shown (the reference's 16×16 grid generalized)."""
    ncols = max(int(n**0.5), 1)
    return -(-n // ncols), ncols


def get_next_path(pth: str) -> str:
    """First non-existing ``<stem>_<i><ext>`` (reference intent, loop fixed)."""
    prefix, ext = os.path.splitext(pth)
    i = 1
    file_path = pth
    while os.path.isfile(file_path):
        file_path = f"{prefix}_{i}{ext}"
        i += 1
    return file_path
