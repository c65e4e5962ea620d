"""``python -m ddim_cold_torch sample``: batch sampling and the denoise-
sequence figure (counterpart of the JAX package's ``ViT.py``, reference
ViT.py:258-316).

The same flags and defaults as ``ViT.py`` (``--sample_n``, ``--acc_k``,
``--config``, ``--checkpoint``, ``--init-random``, ``--seed``, ``--eta``)
plus ``--device``. It writes ``Saved_Models/denoise_sequence.png`` (six
samples along a k=100 trajectory: rows are samples, columns frames) and
``Saved_Models/samples.png`` (``grid_shape(sample_n)``), each through
``get_next_path``, and prints a ``wrote <path>`` line for each.

The model is ``DiffusionViT(total_steps=2000, **MODEL_CONFIGS[config])``:
float32 on the dense attention route, as ``ViT.py:53`` builds it. Its
weights come from ``--checkpoint`` (a reference ``.pkl`` or the port
trainer's ``.ckpt``; default ``Saved_Models/OxfordFlower.pkl``) or, with
``--init-random``, from the seeded init. ``--seed`` seeds a
``torch.Generator`` on the device: ``seed`` for the sequence,
``seed + 1`` for the samples (JAX's ``PRNGKey(seed)`` and
``PRNGKey(seed + 1)``; the bits differ from JAX's).

With more than one visible card and ``sample_n`` divisible by their
number, the samples are drawn over a ``{"data": cards}`` mesh, one spawned
process per card (``sampling.ddim_sample(mesh=)``), as ``ViT.py`` shards
them over a data mesh; rank 0 draws the sequence and writes both files.

The command is split for the tests: :func:`starts` draws the inputs,
:func:`denoise_sequence` and :func:`samples` map them to the arrays saved.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ddim_cold_torch import cli

#: samples in the denoise-sequence figure, and its DDIM stride
N_SEQ, SEQ_K = 6, 100


def parse(argv: Sequence[str], device: Optional[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch sample")
    ap.add_argument("--sample_n", type=int, default=256, help="Number of samples you'll get.")
    ap.add_argument("--acc_k", type=int, default=1,
                    help="Number of steps jumped during sampling.")
    ap.add_argument("--config", default="oxford_flower_64",
                    help="Model config name (see ddim_cold_torch.models.MODEL_CONFIGS).")
    ap.add_argument("--checkpoint", default=None,
                    help="Weights: reference .pkl or the port's .ckpt "
                         "[default: Saved_Models/OxfordFlower.pkl].")
    ap.add_argument("--init-random", action="store_true",
                    help="Use random init instead of a checkpoint (smoke runs).")
    ap.add_argument("--seed", type=int, default=0, help="Sampling rng seed.")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="Stochastic-DDIM noise scale (0 = the reference's "
                         "deterministic sampler).")
    ap.add_argument("--device", default=device,
                    help="'cpu' to sample on the CPU (default: the card)")
    return ap.parse_args(list(argv))


def build_model(config: str, checkpoint: Optional[str], init_random: bool, seed: int,
                base: str, dev, default_ckpt: str = "OxfordFlower.pkl"):
    """``DiffusionViT(total_steps=2000, **MODEL_CONFIGS[config])`` on
    ``dev``, seeded with ``seed`` under ``init_random``, else holding the
    checkpoint's weights (``default_ckpt`` under ``<base>/Saved_Models``)."""
    from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT
    from ddim_cold_torch.utils import run_io

    model = DiffusionViT(total_steps=2000, **MODEL_CONFIGS[config], device=dev,
                         seed=seed if init_random else 0)
    if not init_random:
        run_io.load_weights(model, checkpoint or os.path.join(base, "Saved_Models",
                                                              default_ckpt))
    return model


def generators(seed: int, dev):
    """The sequence's and the samples' generators: ``seed``, ``seed + 1``."""
    import torch

    return (torch.Generator(device=dev).manual_seed(seed),
            torch.Generator(device=dev).manual_seed(seed + 1))


def starts(model, seed: int, sample_n: int):
    """(sequence start, samples start): N(0, 1) batches of ``N_SEQ`` and
    ``sample_n`` images drawn from :func:`generators` on the model's device."""
    from ddim_cold_torch.ops import sampling

    g_seq, g_smp = generators(seed, model.device)
    return (sampling.fresh_start(model, g_seq, N_SEQ, model.device),
            sampling.fresh_start(model, g_smp, sample_n, model.device))


def denoise_sequence(model, x_init, *, seed: int = 0, eta: float = 0.0):
    """(frames, n_frames): the k=100 trajectory of ``x_init``, rows =
    samples and columns = frames flattened into one batch."""
    from ddim_cold_torch.ops import sampling

    seq = sampling.ddim_sample(model, generators(seed, model.device)[0], x_init=x_init,
                               k=SEQ_K, return_sequence=True, eta=eta,
                               device=model.device)
    return seq.transpose(0, 1).reshape(-1, *seq.shape[2:]), seq.shape[0]


def samples(model, x_init, *, acc_k: int, seed: int = 0, eta: float = 0.0, mesh=None):
    """The samples at stride ``acc_k`` from ``x_init`` (over ``mesh``'s
    data axis when given)."""
    from ddim_cold_torch.ops import sampling

    return sampling.ddim_sample(model, generators(seed, model.device)[1], x_init=x_init,
                                k=acc_k, eta=eta, mesh=mesh, device=model.device)


def _run(opts: argparse.Namespace, base: str, dev, mesh=None) -> int:
    from ddim_cold_torch.parallel import mesh as pmesh
    from ddim_cold_torch.utils.image import get_next_path, grid_shape, save_grid

    rank0 = mesh is None or pmesh.is_rank0()
    saved = os.path.join(base, "Saved_Models")
    if rank0:
        os.makedirs(saved, exist_ok=True)
    model = build_model(opts.config, opts.checkpoint, opts.init_random, opts.seed, base, dev)
    x_seq, x_smp = starts(model, opts.seed, opts.sample_n)
    if rank0:
        print("devices:", [str(dev)] if mesh is None else
              [f"{dev.type}:{i}" for i in range(pmesh.data_axis_size(mesh))])
        frames, n_frames = denoise_sequence(model, x_seq, seed=opts.seed, eta=opts.eta)
        out = save_grid(frames, get_next_path(os.path.join(saved, "denoise_sequence.png")),
                        nrows=N_SEQ, ncols=n_frames)
        print(f"wrote {out}")
    img = samples(model, x_smp, acc_k=opts.acc_k, seed=opts.seed, eta=opts.eta, mesh=mesh)
    if rank0:
        nrows, ncols = grid_shape(opts.sample_n)
        out = save_grid(img, get_next_path(os.path.join(saved, "samples.png")),
                        nrows=nrows, ncols=ncols)
        print(f"wrote {out}", flush=True)
    return 0


def _rank_main(rank: int, world: int, init: str, opts: argparse.Namespace,
               base: str) -> None:
    """One spawned rank of a multi-card run, on card ``rank``."""
    import torch
    import torch.distributed as dist

    from ddim_cold_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    pmesh.initialize_distributed(init_method=init, world_size=world, rank=rank, device=dev)
    try:
        _run(opts, base, dev, pmesh.make_mesh({"data": world}, device=dev))
    finally:
        dist.destroy_process_group()


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    opts = parse(argv, device)
    dev = cli.device_or_exit(opts.device, "sample")
    if dev is None:
        return cli.NO_ACCELERATOR
    import torch

    base = base_dir or os.getcwd()
    world = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if world > 1 and opts.sample_n % world == 0:
        import torch.multiprocessing as mp

        from ddim_cold_torch.parallel import mesh as pmesh

        os.makedirs(os.path.join(base, "Saved_Models"), exist_ok=True)
        mp.start_processes(_rank_main, args=(world, f"tcp://localhost:{pmesh.free_port()}",
                                             opts, base),
                           nprocs=world, join=True, start_method="spawn")
        return 0
    return _run(opts, base, dev)
