"""Load a finished training run (config, model, best params) from its
``Saved_Models/<run>/`` directory, and weights into a model — shared by the
commands that read a run or a checkpoint (counterpart of
``ddim_cold_tpu/utils/run_io.py``).

The run directory describes itself: ``python -m ddim_cold_torch train``
copies the experiment YAML into it, and ``bestloss.ckpt`` holds the
best-val params (one ``utils/checkpoint.save_checkpoint`` file). The model
is rebuilt from that YAML by JAX's recipe: ``config.model_kwargs()`` in
bfloat16, its initial weights drawn from ``torch.Generator().manual_seed(0)``
on the CPU and then moved to the device, so every device rebuilds the same
template. Every load is strict (``checkpoint.check_loaded_params``): a
checkpoint of another geometry is refused, naming its leaves.
"""

from __future__ import annotations

import os

import torch

from ddim_cold_torch.config import load_config
from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.utils import checkpoint as ckpt


def load_params(model: DiffusionViT, params: dict, src_path: str) -> dict:
    """Load ``params`` (a state_dict) into ``model`` strictly, cast onto the
    model's own dtypes; returns what was loaded."""
    expected = model.state_dict()
    ckpt.check_loaded_params(params, expected, src_path)
    params = {k: v.to(expected[k].dtype) for k, v in params.items()}
    model.load_state_dict(params, strict=True)
    return params


def load_weights(model: DiffusionViT, path: str) -> dict:
    """Weights from a file into ``model``: a reference ``.pkl`` state_dict
    (``checkpoint.load_torch_pkl``), or a checkpoint of the port's trainer
    (``bestloss.ckpt``, a ``snapshots/epoch_N.ckpt``, or ``lastepoch.ckpt``,
    whose ``params`` entry is taken). An orbax directory is the JAX
    package's format and is refused: its
    ``utils/checkpoint.torch_state_dict_from_flax`` writes a ``.pkl``."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); "
            "convert it to a .pkl with the JAX package's "
            "utils/checkpoint.torch_state_dict_from_flax, or pass a .pkl or .ckpt")
    if path.endswith(".ckpt"):
        raw = ckpt.load_checkpoint(path)
        if "params" in raw and "opt_state" in raw:  # a lastepoch-style resume state
            raw = raw["params"]
    else:
        raw = ckpt.load_torch_pkl(path)
    return load_params(model, raw, path)


def load_run_template(run_dir: str, device=None):
    """→ (config, model, template): the run's model rebuilt from its own
    YAML (bfloat16, the YAML's ``use_flash``) on ``device`` (None means
    ``"cuda"``), and a copy of its initial state_dict to restore a
    checkpoint over, or to go back to (the random anchor of a trend)."""
    yamls = sorted(f for f in os.listdir(run_dir) if f.endswith(".yaml"))
    if not yamls:
        raise FileNotFoundError(f"no experiment yaml in {run_dir}")
    config = load_config(os.path.join(run_dir, yamls[0]),
                         os.path.splitext(yamls[0])[0])
    model = DiffusionViT(dtype=torch.bfloat16, device=device, **config.model_kwargs())
    template = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return config, model, template


def load_run(run_dir: str, device=None):
    """→ (config, model, params): the model holding the run's best
    checkpoint (``bestloss.ckpt``)."""
    config, model, _ = load_run_template(run_dir, device)
    params = load_weights(model, os.path.join(run_dir, "bestloss.ckpt"))
    return config, model, params


def default_val_dir(config, root: str) -> str:
    """The run's own validation split, the FID commands' ``--val-dir``
    default — one policy for ``fid`` and ``fid-trend`` (a 200px run must
    not compare against the 64px OxfordFlowers default). A relative
    ``dataStorage`` path resolves against ``root``, the directory the
    trainer ran from."""
    val = config.data_storage[1]
    if not val:
        raise ValueError(
            f"run yaml for {config.run_name!r} has no dataStorage val entry "
            "— pass --val-dir explicitly")
    return val if os.path.isabs(val) else os.path.join(root, val)
