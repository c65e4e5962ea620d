"""The commands of ``python -m ddim_cold_torch`` beyond ``train``, one module
each, every one the counterpart of a JAX entry point with its flags by
name, its artifacts by file name and its JSON by keys:

* :mod:`.sample` ← ``ViT.py`` (``sample``)
* :mod:`.edit` ← ``ViT_draft2drawing.py`` (``edit``)
* :mod:`.compute_fid` ← ``scripts/compute_fid.py`` (``fid``)
* :mod:`.fid_trend` ← ``scripts/fid_trend.py`` (``fid-trend``)
* :mod:`.publish_run` ← ``scripts/publish_run.py`` (``publish``)
* :mod:`.attrib_report` ← ``scripts/attrib_report.py`` (``attrib-report``)
* :mod:`.obs_report` ← ``scripts/obs_report.py`` (``obs-report``)
* :mod:`.make_dataset` ← ``scripts/make_dataset.py`` (``make-dataset``)
* :mod:`.loader_check` ← ``diffusion_loader.py``'s ``main`` (``loader-check``)

Each module's ``main(argv, base_dir=None, device=None)`` returns an exit
code. ``base_dir`` (default: the working directory) roots what a command
reads and writes by default (``Saved_Models/``, ``results/``), as ``train``
roots its run directory; ``device`` is the default of ``--device`` (or,
where the JAX script's flag is ``--cpu``, ``"cpu"`` sets it). A command
that builds a model runs it on the card and exits with
:data:`NO_ACCELERATOR` before writing anything when CUDA is unavailable,
unless the CPU is asked for. Nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import sys
from typing import Optional

#: exit code of a run that asked for the card on a machine without one (the
#: JAX launchers' ``require_accelerator_or_exit``)
NO_ACCELERATOR = 3


def device_or_exit(device: Optional[str], prog: str, cpu_flag: str = "--device cpu"):
    """The torch device a command runs on (None means the card), or None
    after a message on stderr when it asks for CUDA and there is none."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"python -m ddim_cold_torch {prog}: no CUDA device "
              f"(torch.cuda.is_available() is False); pass {cpu_flag} to run "
              "on the CPU", file=sys.stderr)
        return None
    return dev
