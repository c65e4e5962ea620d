"""``python -m ddim_cold_torch fid-trend``: FID of several checkpoints of one
run under one fixed seeded extractor (counterpart of the JAX package's
``scripts/fid_trend.py``).

A single random-feature FID at small n orders nothing; the FID of several
checkpoints of the same run, plus a random-init anchor, under ONE
extractor (same seed, same n, the same sample stream for every point)
does (random ≫ early ≫ late). The real statistics are computed once and
shared by every point.

Points, in order (:func:`collect_points`): ``random`` (the run's model as
initialised), the port trainer's ``snapshots/epoch_N.ckpt`` files
(``snapshot_epochs``), evenly thinned to ``--max-points`` with the first
and last kept (``obs/trend.thin``), then ``best`` (``bestloss.ckpt``). A
snapshot holding a whole resume state (a copied ``lastepoch.ckpt``) is
unwrapped to its ``params``.

A ``utils/watchdog.StallWatchdog`` (``DDIM_COLD_FID_STALL_S``, default
600 s on the card, off on the CPU) writes ``fid_trend.partial.json`` with
the points so far when the device goes silent. Writes
``results/<run>/fid_trend.json`` under the working directory (JAX's keys:
the points annotated by ``obs/trend.annotate_deltas`` with lower FID
better, ``run_meta`` stamped with the card's name) and prints one JSON
line. ``--cpu`` runs on the CPU; otherwise the card, exit 3 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Optional, Sequence

from ddim_cold_torch import cli

SNAPSHOT_RE = re.compile(r"epoch_(\d+)\.ckpt")


def collect_points(run_dir: str, max_points: int):
    """→ ordered [(label, epoch|None, ckpt_path|None)] trend points: the
    random-init anchor, the evenly thinned snapshot epochs (first and last
    always kept), then the run's best checkpoint."""
    from ddim_cold_torch.obs import trend

    points = [("random", -1, None)]  # anchor: params as initialised
    snap_dir = os.path.join(run_dir, "snapshots")
    if os.path.isdir(snap_dir):
        snaps = []
        for name in os.listdir(snap_dir):
            m = SNAPSHOT_RE.fullmatch(name)
            if m:
                snaps.append((int(m.group(1)), os.path.join(snap_dir, name)))
        snaps.sort()
        snaps = trend.thin(snaps, max_points)
        points += [(f"epoch_{ep}", ep, path) for ep, path in snaps]
    best = os.path.join(run_dir, "bestloss.ckpt")
    if os.path.isfile(best):
        points.append(("best", None, best))
    return points


def parse(argv: Sequence[str], base: str, device: Optional[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch fid-trend")
    ap.add_argument("run_dir", nargs="?", default=os.path.join(
        base, "Saved_Models", "20220822vit_tiny_diffusion"))
    ap.add_argument("--val-dir", default=None,
                    help="real-image folder for the FID reference stream [default: "
                         "the run config's own val dataStorage]")
    ap.add_argument("--n-samples", type=int, default=256,
                    help="samples per trend point (the headline fid.json uses "
                         "n=1024; trend points trade n for breadth under the SAME "
                         "extractor)")
    ap.add_argument("--n-real", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--inception-seed", type=int, default=0)
    ap.add_argument("--max-points", type=int, default=10,
                    help="evenly thin snapshot points beyond this count")
    ap.add_argument("--cpu", action="store_true", default=device == "cpu")
    return ap.parse_args(list(argv))


def trend_points(model, template: dict, points, real, feature_fn, dim: int, *,
                 n_samples: int, batch: int, levels: int, wd=None,
                 results: Optional[list] = None) -> list:
    """[{"ckpt", "epoch", "fid"}] for each point: its weights loaded into
    ``model`` (the template for the anchor), ``n_samples`` cold samples in
    full batches from the same stream (batch b from
    ``fold_in(Generator.manual_seed(1), b)``) against ``real``."""
    import torch

    from ddim_cold_torch.eval import fid
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.utils import run_io

    results = [] if results is None else results
    first = True
    for label, epoch, path in points:
        if path is None:
            run_io.load_params(model, template, "the random-init template")
        else:
            run_io.load_weights(model, path)
        fake = fid.ActivationStats(dim)
        gen = torch.Generator(device=model.device).manual_seed(1)  # the same stream
        for b, keep in fid._batches(n_samples, batch):
            if wd is not None:
                wd.mark(f"sample-batch {label} {b * batch}/{n_samples}",
                        budget_s=1800 if first else None)
            first = False
            imgs = sampling.cold_sample(model, sampling.fold_in(gen, b), n=batch,
                                        levels=levels, device=model.device)
            fake.update(feature_fn(imgs)[:keep])
        value = fid.fid_from_stats(real, fake)
        results.append({"ckpt": label, "epoch": epoch, "fid": round(float(value), 4)})
        print(f"[fid-trend] {label}: {value:.2f}", file=sys.stderr)
    return results


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    base = base_dir or os.getcwd()
    args = parse(argv, base, device)
    dev = cli.device_or_exit("cpu" if args.cpu else None, "fid-trend", "--cpu")
    if dev is None:
        return cli.NO_ACCELERATOR
    import torch

    from ddim_cold_torch.cli.compute_fid import real_stream, write_result
    from ddim_cold_torch.eval import fid, inception
    from ddim_cold_torch.obs import trend
    from ddim_cold_torch.utils.platform import watchdog_stall_s
    from ddim_cold_torch.utils.record import run_metadata
    from ddim_cold_torch.utils.run_io import default_val_dir, load_run_template
    from ddim_cold_torch.utils.watchdog import StallWatchdog

    config, model, template = load_run_template(args.run_dir, dev)
    if args.val_dir is None:
        args.val_dir = default_val_dir(config, base)
    points = collect_points(args.run_dir, args.max_points)
    run = os.path.basename(os.path.normpath(args.run_dir))
    results: list = []

    def write_partial(label, silent_s):
        # a distinct file name: a stall never clobbers a complete fid_trend.json
        write_result(base, run, "fid_trend.partial.json", {
            "metric": "fid_trend_cold", "points": results,
            "aborted": f"stalled {silent_s:.0f}s after {label!r} (stall watchdog)"})

    wd = StallWatchdog(watchdog_stall_s("DDIM_COLD_FID_STALL_S", 600.0, dev),
                       on_abort=write_partial, name="fid-trend").start()
    wd.mark("inception init", budget_s=1800)
    inc_model, inc_vars = inception.init_variables(args.inception_seed)
    feature_fn, dim = fid.make_feature_fn(inc_model, inc_vars, device=dev)
    real_batches, seen = real_stream(args.val_dir, config.image_size, args.batch,
                                     args.n_real)

    def marked(batches):
        for batch in batches:
            wd.mark(f"real-batch {seen[0]}/{args.n_real}",
                    budget_s=1800 if seen[0] == 0 else None)
            yield batch

    real = fid.stats_for_batches(marked(real_batches), feature_fn, dim)
    print(f"[fid-trend] real stats over {real.count} images", file=sys.stderr)
    trend_points(model, template, points, real, feature_fn, dim,
                 n_samples=args.n_samples, batch=args.batch,
                 levels=int(math.log2(config.image_size[0])), wd=wd, results=results)
    wd.done()
    out = {
        "metric": "fid_trend_cold",
        "points": trend.annotate_deltas(results, "fid", lower_is_better=True),
        "run_meta": run_metadata(chip=torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
        "n_samples": args.n_samples,
        "n_real": seen[0],
        "extractor": (f"seeded random init (torch.Generator().manual_seed("
                      f"{args.inception_seed})) — no network for canonical weights; "
                      "fixed across all points, so values order models but are NOT "
                      "comparable to published FID numbers"),
        "run": run,
    }
    write_result(base, run, "fid_trend.json", out)
    print(json.dumps(out), flush=True)
    return 0
