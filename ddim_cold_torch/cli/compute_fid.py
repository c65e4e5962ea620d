"""``python -m ddim_cold_torch fid``: FID of a trained run's samples against
its validation images (counterpart of the JAX package's
``scripts/compute_fid.py``).

The model is the run's own (``utils/run_io.load_run``: its YAML, bfloat16,
the YAML's ``use_flash``, ``bestloss.ckpt``). The real stream is the clean
images of ``data.ColdDownSampleDataset(target_mode="direct")`` over
``--val-dir`` (default: the run's own val ``dataStorage``), read by the
port's loader in order, dropping the last partial batch, up to
``--n-real``. The extractor is the seeded random-init InceptionV3
(``eval/inception.init_variables(--inception-seed)``: a fixed, reproducible
feature space, not comparable to published FID numbers) or a local
torchvision ``.pth`` (``--inception-pth``; nothing is downloaded). Samples
come from ``--sampler cold`` (the run's ``log2(H)`` levels) or ``ddim``
(stride ``--k``), in full batches of ``--batch``, batch b drawn from
``sampling.fold_in(Generator.manual_seed(1), b)``.

Writes ``results/<run>/fid.json`` under the working directory with JAX's
keys (``metric``, ``value``, ``n_samples``, ``n_real``, ``extractor``,
``run``) and prints it as one JSON line. ``--cpu`` runs on the CPU;
otherwise it runs on the card and exits 3 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Callable, Optional, Sequence

from ddim_cold_torch import cli


def parse(argv: Sequence[str], base: str, device: Optional[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch fid")
    ap.add_argument("run_dir", nargs="?", default=os.path.join(
        base, "Saved_Models", "20220822vit_tiny_diffusion"))
    ap.add_argument("--val-dir", default=None,
                    help="real-image folder for the FID reference stream [default: "
                         "the run config's own val dataStorage]")
    ap.add_argument("--n-samples", type=int, default=1024)
    ap.add_argument("--n-real", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sampler", choices=("cold", "ddim"), default="cold",
                    help="cold = the trained regime of the 20220822 run; ddim uses "
                         "stride --k")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--inception-seed", type=int, default=0)
    ap.add_argument("--inception-pth", default=None,
                    help="optional local torchvision inception_v3 .pth for "
                         "published-comparable numbers")
    ap.add_argument("--cpu", action="store_true", default=device == "cpu")
    return ap.parse_args(list(argv))


def real_stream(val_dir: str, image_size, batch: int, n_real: int):
    """(batches, seen): an iterator of clean val batches in [0, 1] and a
    one-entry list counting the images it yielded."""
    from ddim_cold_torch.data import ColdDownSampleDataset, ShardedLoader

    ds = ColdDownSampleDataset(val_dir, imgSize=tuple(image_size), target_mode="direct")
    seen = [0]

    def batches():
        for _, clean, _ in ShardedLoader(ds, batch, shuffle=False, drop_last=True):
            if seen[0] >= n_real:
                break
            yield (clean + 1.0) / 2.0  # the direct mode's target is x0
            seen[0] += clean.shape[0]

    return batches(), seen


def extractor(seed: int, pth: Optional[str]):
    """(inception model, state_dict, provenance) — ``scripts/compute_fid.py``'s
    choice, in the port's weights."""
    from ddim_cold_torch.eval import inception

    if pth:
        inc_model, inc_vars = inception.load_torch_inception(pth)
        return inc_model, inc_vars, f"torchvision pth: {pth}"
    inc_model, inc_vars = inception.init_variables(seed)
    return inc_model, inc_vars, (
        f"seeded random init (torch.Generator().manual_seed({seed})) — no network for "
        "the canonical weights; converter torch-parity-tested")


def make_sampler(model, name: str, k: int, levels: int) -> Callable:
    """``sampler(generator, n)`` → [0, 1] images: cold over ``levels`` or
    DDIM at stride ``k``."""
    from ddim_cold_torch.ops import sampling

    def sampler(generator, n):
        if name == "cold":
            return sampling.cold_sample(model, generator, n=n, levels=levels,
                                        device=model.device)
        return sampling.ddim_sample(model, generator, k=k, n=n, device=model.device)

    return sampler


def fid_value(model, real_batches, sampler: Callable, *, n_samples: int, batch: int,
              k: int, inception_model, inception_variables) -> float:
    """The FID of ``sampler``'s samples against ``real_batches`` (the
    command's measurement, ``eval/fid.compute_fid`` from generator seed 1)."""
    import torch

    from ddim_cold_torch.eval import fid

    return fid.compute_fid(
        model, real_batches, generator=torch.Generator(device=model.device).manual_seed(1),
        n_samples=n_samples, sample_batch=batch, k=k, inception_model=inception_model,
        inception_variables=inception_variables, sampler=sampler, device=model.device)


def write_result(base: str, run: str, name: str, out: dict) -> str:
    """``results/<run>/<name>`` under ``base``; returns its path."""
    out_dir = os.path.join(base, "results", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return path


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    base = base_dir or os.getcwd()
    args = parse(argv, base, device)
    dev = cli.device_or_exit("cpu" if args.cpu else None, "fid", "--cpu")
    if dev is None:
        return cli.NO_ACCELERATOR
    from ddim_cold_torch.utils.run_io import default_val_dir, load_run

    config, model, _ = load_run(args.run_dir, dev)
    if args.val_dir is None:
        args.val_dir = default_val_dir(config, base)
    inc_model, inc_vars, provenance = extractor(args.inception_seed, args.inception_pth)
    real, seen = real_stream(args.val_dir, config.image_size, args.batch, args.n_real)
    sampler = make_sampler(model, args.sampler, args.k, int(math.log2(config.image_size[0])))
    value = fid_value(model, real, sampler, n_samples=args.n_samples, batch=args.batch,
                      k=args.k, inception_model=inc_model, inception_variables=inc_vars)
    run = os.path.basename(os.path.normpath(args.run_dir))
    out = {
        "metric": f"fid_{args.sampler}" + (f"_k{args.k}" if args.sampler == "ddim" else ""),
        "value": round(float(value), 4),
        "n_samples": args.n_samples,
        "n_real": seen[0],  # actually accumulated, not requested
        "extractor": provenance,
        "run": run,
    }
    write_result(base, run, "fid.json", out)
    print(json.dumps(out), flush=True)
    return 0
