"""The port's command line: ``python -m ddim_cold_torch <command> ...``.

Commands (:data:`COMMANDS`), each the counterpart of a JAX entry point:

* ``train <ExpName>`` — the launcher (``multi_gpu_trainer.py``), below;
* ``sample`` — batch sampling and the denoise-sequence figure (``ViT.py``);
* ``edit`` — cold sampling, draft→drawing and slerp interpolation
  (``ViT_draft2drawing.py``);
* ``fid``, ``fid-trend``, ``publish`` — FID of a finished run, FID across
  its checkpoints, and its published evidence (``scripts/compute_fid.py``,
  ``fid_trend.py``, ``publish_run.py``);
* ``attrib-report``, ``obs-report`` — the observability layer's files
  rendered (``scripts/attrib_report.py``, ``obs_report.py``);
* ``make-dataset`` — the surrogate dataset's recipe
  (``scripts/make_dataset.py``);
* ``loader-check`` — the degradation visual check
  (``diffusion_loader.py``).

All but ``train`` live in :mod:`ddim_cold_torch.cli`, one module each,
imported when the command runs. Every command that builds a model runs on
the card and exits with code 3 before writing anything when CUDA is
unavailable, unless ``--device cpu`` (``--cpu`` for ``fid``, ``fid-trend``
and ``publish``, the JAX scripts' flag) asks for the CPU.

``train`` is the counterpart of the JAX package's launcher
(``multi_gpu_trainer.py:17-64``): it reads ``<ExpName>.yaml`` from the
working directory, creates ``Saved_Models/<ExpName><framework>/`` there
(printing ``Warning!Current folder already exist!`` when it exists), copies
the YAML in, trains with ``train/trainer.run`` and prints the launcher's
closing line. It trains on the card: without CUDA it exits with code 3
and a message before touching the file system, unless ``--device cpu``
asks for the CPU. ``num_gpus: N`` (a ``data`` mesh) or a ``mesh: {model:
m, pipe: p, data: d, seq: s}`` (with ``microbatches`` under ``pipe``) in the
YAML trains one process per device, as the reference's launcher spawned
them (``train/trainer.py``): NCCL on the cards, gloo on the CPU; under
torchrun each process runs this command and only rank 0 prepares the run
directory and prints. The subcommands are a dispatch table,
:data:`COMMANDS`.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import sys
from typing import Optional, Sequence

from ddim_cold_torch.cli import NO_ACCELERATOR, device_or_exit


def _train(args: Sequence[str], base_dir: Optional[str], device: Optional[str]) -> int:
    parser = argparse.ArgumentParser(prog="python -m ddim_cold_torch train")
    parser.add_argument("exp_name", help="reads <exp_name>.yaml from the working directory")
    parser.add_argument("--device", default=device,
                        help="'cpu' to train on the CPU (default: the card)")
    opts = parser.parse_args(list(args))
    if device_or_exit(opts.device, "train") is None:
        return NO_ACCELERATOR

    from ddim_cold_torch.config import load_config
    from ddim_cold_torch.train.trainer import run

    yaml_path = os.path.abspath(opts.exp_name + ".yaml")
    if not os.path.isfile(yaml_path):
        print(f"python -m ddim_cold_torch train: no {yaml_path}", file=sys.stderr)
        return 2
    config = load_config(yaml_path, opts.exp_name)
    base = base_dir or os.getcwd()
    run_dir = os.path.join(base, "Saved_Models", config.run_name)
    rank0 = int(os.environ.get("RANK", 0)) == 0  # torchrun starts every rank here
    if rank0:
        if os.path.isdir(run_dir):
            print("Warning!Current folder already exist!")
        os.makedirs(run_dir, exist_ok=True)
        shutil.copy(yaml_path, run_dir)
    result = run(config, base, device=opts.device)
    if rank0:
        print(f"\nbest val loss {result.best_loss:.5f} after {result.steps} steps "
              f"→ {result.run_dir}")
    return 0


def _command(module: str):
    """The handler of a :mod:`ddim_cold_torch.cli` module, imported on use."""
    def run(args: Sequence[str], base_dir: Optional[str], device: Optional[str]) -> int:
        return importlib.import_module(f"ddim_cold_torch.cli.{module}").main(
            args, base_dir=base_dir, device=device)

    return run


#: subcommand → handler(args, base_dir, device) → exit code
COMMANDS = {"train": _train, "sample": _command("sample"), "edit": _command("edit"),
            "fid": _command("compute_fid"), "fid-trend": _command("fid_trend"),
            "publish": _command("publish_run"), "attrib-report": _command("attrib_report"),
            "obs-report": _command("obs_report"), "make-dataset": _command("make_dataset"),
            "loader-check": _command("loader_check")}


def main(argv: Optional[Sequence[str]] = None, base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    """Run one subcommand; ``argv`` excludes the program name (default
    ``sys.argv[1:]``). ``base_dir`` roots ``Saved_Models/`` elsewhere than
    the working directory and ``device`` sets ``--device``'s default
    (``"cpu"`` sets ``--cpu``; both for tests)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ddim_cold_torch {{{','.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:], base_dir, device)


if __name__ == "__main__":
    sys.exit(main())
