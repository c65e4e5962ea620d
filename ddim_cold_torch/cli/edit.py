"""``python -m ddim_cold_torch edit``: cold sampling and the zero-shot
applications (counterpart of the JAX package's ``ViT_draft2drawing.py``,
reference ViT_draft2drawing.py:331-476).

Flags as in ``ViT_draft2drawing.py``: ``--config`` (default ``vit_tiny``),
``--checkpoint`` (a reference ``.pkl`` or the port trainer's ``.ckpt``;
default ``Saved_Models/20220822vit_tiny_diffusion/bestloss.pkl``),
``--init-random``, ``--draft``, ``--interpolate A B``, ``--cold-n``,
``--seed``, ``--eta``, plus ``--device``. Under ``Saved_Models/`` it
writes, each through ``get_next_path``:

* ``cold_sequence.png`` — ``cold_n`` cold trajectories over the model's own
  ``log2(H)`` levels (rows are samples, columns levels), and
  ``cold_samples.png`` — ``cold_n`` cold samples in ``grid_shape(cold_n)``;
* with ``--draft``: ``draft2img.png`` — the draft, then nine variants, each
  the draft encoded to t_start ∈ range(1599, 2000, 50) and DDIM-denoised
  at k=10 (2×5);
* with ``--interpolate A B``: ``interpolation.png`` — eight slerp
  interpolants between the encodings of A and B at t_start 1800, decoded
  at k=10 (1×8).

Generators are seeded as JAX's keys: ``seed`` and ``seed + 1`` for the cold
sequence and grid, ``seed + 100 + i`` / ``seed + 200 + i`` for restart i's
encoding and decoding, ``seed + 500`` for the interpolation. The model is
float32 on the dense attention route, as JAX's script builds it.

Split for the tests: :func:`img2tensor` and the start builders draw the
inputs; :func:`cold_arrays`, :func:`draft_tiles` and :func:`interp_frames`
map inputs to the arrays saved.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

from ddim_cold_torch import cli

#: the draft→drawing restart levels (reference :393) and decode stride
T_STARTS = tuple(range(1599, 2000, 50))
DRAFT_K = 10
#: interpolants, their encoding level and decode stride
N_INTERP, INTERP_T, INTERP_K = 8, 1800, 10


def parse(argv: Sequence[str], device: Optional[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch edit")
    ap.add_argument("--config", default="vit_tiny",
                    help="Model config name (reference uses vit_tiny).")
    ap.add_argument("--checkpoint", default=None,
                    help="Weights: reference .pkl or the port's .ckpt [default: "
                         "Saved_Models/20220822vit_tiny_diffusion/bestloss.pkl].")
    ap.add_argument("--init-random", action="store_true",
                    help="Use random init instead of a checkpoint (smoke runs).")
    ap.add_argument("--draft", default=None,
                    help="Draft/sketch image for the draft→drawing app.")
    ap.add_argument("--interpolate", nargs=2, default=None,
                    help="Two images to slerp-interpolate between.")
    ap.add_argument("--cold-n", type=int, default=49, help="Samples in the cold grid.")
    ap.add_argument("--seed", type=int, default=0, help="Sampling rng seed.")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="Stochastic-DDIM noise scale for the draft2img restarts "
                         "and the --interpolate decode (0 = deterministic).")
    ap.add_argument("--device", default=device,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(list(argv))


def img2tensor(path: str, img_size, device="cpu"):
    """An image file → (1, H, W, C) float32 tensor in [−1, 1] on ``device``
    (reference ViT_draft2drawing.py:331-339: resize then scale, no crop)."""
    import numpy as np
    import torch

    from ddim_cold_torch.data.datasets import pil_loader
    from ddim_cold_torch.data.resize import resize_bilinear

    img = np.asarray(pil_loader(path), np.float32) / 255.0
    img = resize_bilinear(img, tuple(img_size))
    return torch.from_numpy(img * 2.0 - 1.0)[None].to(device)


def _gen(seed: int, dev):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def levels_of(model) -> int:
    """The cold levels of the model's own size: t ∈ [1, log2(H)]."""
    return int(math.log2(model.img_size[0]))


def cold_starts(model, seed: int, n: int):
    """(sequence start, grid start): ``cold_init`` of ``seed`` and ``seed + 1``."""
    from ddim_cold_torch.ops import sampling

    dev = model.device
    return (sampling.cold_init(model, _gen(seed, dev), n, dev),
            sampling.cold_init(model, _gen(seed + 1, dev), n, dev))


def cold_arrays(model, seq_init, grid_init):
    """(frames, n_frames, grid): the cold trajectories of ``seq_init``
    (rows = samples) and the cold samples of ``grid_init``."""
    from ddim_cold_torch.ops import sampling

    levels = levels_of(model)
    seq = sampling.cold_sample(model, x_init=seq_init, levels=levels,
                               return_sequence=True, device=model.device)
    grid = sampling.cold_sample(model, x_init=grid_init, levels=levels, device=model.device)
    return seq.transpose(0, 1).reshape(-1, *seq.shape[2:]), seq.shape[0], grid


def draft_states(model, x, seed: int) -> list:
    """The draft encoded to each restart level, from ``seed + 100 + i``."""
    from ddim_cold_torch.ops import sampling

    return [sampling.forward_noise(_gen(seed + 100 + i, model.device), x, t_start,
                                   model.total_steps)
            for i, t_start in enumerate(T_STARTS)]


def draft_tiles(model, x, states: list, *, seed: int = 0, eta: float = 0.0):
    """The draft as (x + 1)/2, then each restart state DDIM-denoised at
    k=10 (decode noise of η > 0 from ``seed + 200 + i``)."""
    import torch

    from ddim_cold_torch.ops import sampling

    variants = [sampling.sample_from(model, noisy, t_start=t_start, k=DRAFT_K, eta=eta,
                                     generator=_gen(seed + 200 + i, model.device),
                                     device=model.device)[0]
                for i, (t_start, noisy) in enumerate(zip(T_STARTS, states))]
    return torch.stack([(x[0].to(model.device) + 1.0) / 2.0] + variants)


def interp_states(model, a, b, seed: int):
    """The slerp-mixed encodings of A and B (``sampling.interp_states`` of
    ``seed + 500``)."""
    from ddim_cold_torch.ops import sampling

    return sampling.interp_states(_gen(seed + 500, model.device), a, b, N_INTERP,
                                  INTERP_T, model.total_steps)


def interp_frames(model, mixed, *, seed: int = 0, eta: float = 0.0):
    """The mixed encodings decoded at k=10 (``slerp_interpolate``'s decode:
    η > 0 draws from ``fold_in(seed + 500, 1)``)."""
    from ddim_cold_torch.ops import sampling

    return sampling.sample_from(model, mixed, t_start=INTERP_T, k=INTERP_K, eta=eta,
                                generator=sampling.fold_in(_gen(seed + 500, model.device), 1),
                                device=model.device)


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    opts = parse(argv, device)
    dev = cli.device_or_exit(opts.device, "edit")
    if dev is None:
        return cli.NO_ACCELERATOR
    from ddim_cold_torch.cli.sample import build_model
    from ddim_cold_torch.utils.image import get_next_path, grid_shape, save_grid

    base = base_dir or os.getcwd()
    saved = os.path.join(base, "Saved_Models")
    os.makedirs(os.path.join(saved, "20220822vit_tiny_diffusion"), exist_ok=True)
    model = build_model(opts.config, opts.checkpoint, opts.init_random, opts.seed, base, dev,
                        default_ckpt=os.path.join("20220822vit_tiny_diffusion", "bestloss.pkl"))
    print(f"devices: {[str(dev)]}")

    def write(images, name: str, nrows: int, ncols: int) -> None:
        out = save_grid(images, get_next_path(os.path.join(saved, name)),
                        nrows=nrows, ncols=ncols)
        print(f"wrote {out}", flush=True)

    frames, n_frames, grid = cold_arrays(model, *cold_starts(model, opts.seed, opts.cold_n))
    write(frames, "cold_sequence.png", opts.cold_n, n_frames)
    write(grid, "cold_samples.png", *grid_shape(opts.cold_n))
    if opts.draft is not None:
        x = img2tensor(opts.draft, model.img_size, dev)
        write(draft_tiles(model, x, draft_states(model, x, opts.seed), seed=opts.seed,
                          eta=opts.eta), "draft2img.png", 2, 5)
    if opts.interpolate:
        a, b = (img2tensor(p, model.img_size, dev)[0] for p in opts.interpolate)
        write(interp_frames(model, interp_states(model, a, b, opts.seed), seed=opts.seed,
                            eta=opts.eta), "interpolation.png", 1, N_INTERP)
    return 0
