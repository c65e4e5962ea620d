"""``python -m ddim_cold_torch publish``: a finished run's evidence under
``results/<run>/`` (counterpart of the JAX package's
``scripts/publish_run.py``).

* ``train.log`` and ``metrics.jsonl`` — the run's own records, copied;
* ``val_curve.png`` — the per-epoch val smooth-L1 of ``train.log``, over
  the reference's committed run when ``DDIM_COLD_REF_LOG`` names its
  ``train.log`` (read only if the file exists; matplotlib is imported
  inside :func:`render_curve` only);
* ``samples.png`` / ``cold_sequence.png`` — cold grids from the run's
  ``bestloss.ckpt`` at the run's own ``log2(H)`` levels (16 samples; the
  trajectories of 4);
* ``summary.json`` — best and final losses, with JAX's keys.

``results/`` is the working directory's. ``--no-samples`` skips the
grids; ``--cpu`` samples on the CPU, otherwise on the card (exit 3
without one). A ``StallWatchdog`` (``DDIM_COLD_FID_STALL_S``) bounds the
sampling, the one device work.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from typing import Optional, Sequence

from ddim_cold_torch import cli

#: the reference run's training log, overlaid on the curve (read only if
#: the file exists)
REF_LOG = os.environ.get("DDIM_COLD_REF_LOG", "")
EPOCH_RE = re.compile(r"epoch:\s*(\d+)\s+loss:\s*([0-9.]+)")


def parse_epoch_losses(log_path: str) -> dict[int, float]:
    """epoch → val loss; later lines win (the reference log contains a
    restart whose epochs overlap, the trainer's resume semantics)."""
    out: dict[int, float] = {}
    with open(log_path) as f:
        for line in f:
            m = EPOCH_RE.search(line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def render_curve(ours: dict[int, float], ref: dict[int, float], path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=130)
    if ref:
        xs = sorted(ref)
        ax.plot(xs, [ref[x] for x in xs], color="#999999", lw=1.5,
                label="reference (torch/3090, Oxford Flowers)")
        ax.axhline(min(ref.values()), color="#999999", lw=0.8, ls="--",
                   label=f"reference best {min(ref.values()):.4f}")
    xs = sorted(ours)
    ax.plot(xs, [ours[x] for x in xs], color="#1666c0", lw=1.8,
            label="this port (PyTorch, surrogate flowers)")
    ax.axhline(min(ours.values()), color="#1666c0", lw=0.8, ls="--",
               label=f"ours best {min(ours.values()):.4f}")
    ax.set_xlabel("epoch")
    ax.set_ylabel("val smooth-L1")
    ax.set_yscale("log")
    ax.set_title("Cold-diffusion run: val loss per epoch")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def render_samples(run_dir: str, out_dir: str, *, n: int = 16, wd=None,
                   device=None) -> None:
    """Grids from the run's best checkpoint: ``samples.png`` (n cold
    samples, ⌊√n⌋ square) and ``cold_sequence.png`` (the trajectories of 4;
    rows are samples, columns levels), both at the run's ``log2(H)``
    levels, from generator seeds 0 and 1 on the device."""
    import math

    import torch

    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.utils.image import save_grid
    from ddim_cold_torch.utils.run_io import load_run

    config, model, _ = load_run(run_dir, device)
    levels = int(math.log2(config.image_size[0]))
    side = int(math.isqrt(n))
    gen = lambda seed: torch.Generator(device=model.device).manual_seed(seed)
    if wd is not None:
        wd.mark("sample grid", budget_s=1800)
    cold = sampling.cold_sample(model, gen(0), n=side * side, levels=levels,
                                device=model.device)
    save_grid(cold, os.path.join(out_dir, "samples.png"), nrows=side, ncols=side)
    if wd is not None:
        wd.mark("sequence grid", budget_s=1800)
    seq = sampling.cold_sample(model, gen(1), n=4, levels=levels, return_sequence=True,
                               device=model.device)
    frames = seq.transpose(0, 1).reshape(-1, *seq.shape[-3:])
    save_grid(frames, os.path.join(out_dir, "cold_sequence.png"),
              nrows=seq.shape[1], ncols=seq.shape[0])


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    base = base_dir or os.getcwd()
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch publish")
    ap.add_argument("run_dir", nargs="?", default=os.path.join(
        base, "Saved_Models", "20220822vit_tiny_diffusion"))
    ap.add_argument("--no-samples", action="store_true")
    ap.add_argument("--cpu", action="store_true", default=device == "cpu")
    args = ap.parse_args(list(argv))
    dev = cli.device_or_exit("cpu" if args.cpu else None, "publish", "--cpu")
    if dev is None:
        return cli.NO_ACCELERATOR

    run = os.path.basename(os.path.normpath(args.run_dir))
    ours = parse_epoch_losses(os.path.join(args.run_dir, "train.log"))
    if not ours:
        raise SystemExit("no epoch lines in train.log — run unfinished?")
    out_dir = os.path.join(base, "results", run)
    os.makedirs(out_dir, exist_ok=True)
    for name in ("train.log", "metrics.jsonl"):
        src = os.path.join(args.run_dir, name)
        if os.path.isfile(src):
            shutil.copy(src, out_dir)
    ref = parse_epoch_losses(REF_LOG) if os.path.isfile(REF_LOG) else {}
    render_curve(ours, ref, os.path.join(out_dir, "val_curve.png"))

    if not args.no_samples:
        from ddim_cold_torch.utils.platform import watchdog_stall_s
        from ddim_cold_torch.utils.watchdog import StallWatchdog

        wd = StallWatchdog(watchdog_stall_s("DDIM_COLD_FID_STALL_S", 600.0, dev),
                           name="publish-run").start()
        render_samples(args.run_dir, out_dir, wd=wd, device=dev)
        wd.done()

    summary = {
        "run": run,
        "epochs": len(ours),
        "val_loss_epoch0": ours.get(0),
        "val_loss_best": min(ours.values()),
        "val_loss_last": ours[max(ours)],
        "reference_best": min(ref.values()) if ref else None,
        "reference_epoch0": ref.get(0) if ref else None,
        "dataset": "procedural surrogate flowers (python -m ddim_cold_torch "
                   "make-dataset; no network for the real Oxford Flowers)",
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    print(f"published → {out_dir}", flush=True)
    return 0
