"""``python -m ddim_cold_torch loader-check [image_dir] [out.png]``: the
dataset's degradation visual check (counterpart of ``main`` of the JAX
package's ``diffusion_loader.py``, reference diffusion_loader.py:141-154).

For each level t = 1..max_step it renders the ``(D(x,t), D(x,t−1))`` pair
of the first image of ``data.ColdDownSampleDataset`` at 64 px and writes
``degradation_pairs.png`` (default: in the working directory). Without a
folder it degrades a synthetic gradient image, so the check runs out of the
box. Headless: matplotlib (Agg), imported inside :func:`main`, saves the
figure instead of showing it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence


def synthetic_dir(size: int = 64) -> str:
    """A new temporary folder holding one gradient PNG (``grad.png``)."""
    import numpy as np
    from PIL import Image

    root = tempfile.mkdtemp(prefix="ddim_cold_viz_")
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    arr = np.stack([x, y, 0.5 * (x + y)], axis=-1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(os.path.join(root, "grad.png"))
    return root


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from ddim_cold_torch.data import ColdDownSampleDataset

    argv = list(argv)
    root = argv[0] if argv else synthetic_dir()
    out = argv[1] if len(argv) > 1 else os.path.join(base_dir or os.getcwd(),
                                                     "degradation_pairs.png")
    ds = ColdDownSampleDataset(root, imgSize=(64, 64))
    fig, axes = plt.subplots(2, ds.max_step, figsize=(2 * ds.max_step, 4.2))
    for t in range(1, ds.max_step + 1):
        noisy, target, _ = ds.__getitem__(0, t=t)
        for row, img, label in ((0, noisy, f"D(x,{t})"), (1, target, f"D(x,{t - 1})")):
            ax = axes[row][t - 1]
            ax.imshow(np.clip((np.asarray(img) + 1) / 2, 0, 1))
            ax.set_title(label, fontsize=8)
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"degradation pairs (t=1..{ds.max_step}) → {out}")
    return 0
