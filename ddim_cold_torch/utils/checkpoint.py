"""Checkpoints of the port's trainer (its own format, through ``torch.save``).

The reference's dual checkpoints (multi_gpu_trainer.py:94-106,152-163):

* ``lastepoch.ckpt`` — the resume target: ``{epoch, steps, loss_rec,
  metric, params, opt_state[, ema_params]}``, params and the optimizer
  moments keyed by the model's state_dict names;
* ``bestloss.ckpt`` — bare params whenever the val loss improves, plus
  ``bestloss.pkl``, the params as a reference torch state_dict
  (``blocks.N.attn.qkv.weight`` …: the port's own parameter names are the
  reference's, the names ``utils/weights.state_dict_from_flax`` writes);
  a Switch-MoE model has no reference layout and gets no ``.pkl`` (JAX
  trainer.py:600).

The warm-start ``initializing`` pkl loads through the same names (a
reference ``lastepoch`` dict's ``state_dict`` and DDP's ``module.`` prefix
are accepted). Loads use ``torch.load(weights_only=True)``: only tensors
and plain containers.

Crash safety. Every file is written beside its destination as
``<path>.<pid>.writing`` and renamed over it with one ``os.replace``, so a
crash at any point leaves either the previous file or the new one whole.
The next save of the same path removes what a killed writer left
(``<path>.<pid>.writing`` of a pid that no longer runs), as JAX's save
clears its ``.writing`` and ``.old`` directories. :func:`save_checkpoint`
fires the ``ckpt.save`` fault site at JAX's four crash windows, in JAX's
order and with its tags (``window:pre-write|``, ``window:post-write|``,
``window:mid-swap|`` just before the replace, ``window:post-swap|`` just
after it); a crash in the first three leaves the previous checkpoint, in
the last the new one — the versions JAX's two directory renames leave after
its ``recover_swap``. One rename never leaves a ``.old`` behind, so the
port has no ``recover_swap``.
"""

from __future__ import annotations

import os
import re

import torch

from ddim_cold_torch.utils import faults


_WRITING = re.compile(r"\.(\d+)\.writing$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, another user's
        return True
    return True


def _clear_stale(path: str) -> None:
    """Remove ``<path>.<pid>.writing`` files whose writer is gone (a save
    killed mid-write); a live writer's file is left alone."""
    folder, name = os.path.split(os.path.abspath(path))
    for entry in os.listdir(folder):
        m = _WRITING.search(entry)
        if (m and entry[:m.start()] == name and int(m.group(1)) != os.getpid()
                and not _pid_alive(int(m.group(1)))):
            try:
                os.remove(os.path.join(folder, entry))
            except FileNotFoundError:  # another save removed it first
                pass


def _window(name: str) -> None:
    faults.fire("ckpt.save", tag=f"window:{name}|")


def _atomic_save(obj, path: str, windows: bool = False) -> None:
    """``torch.save`` beside ``path``, then one rename over it; with
    ``windows`` the ``ckpt.save`` site fires at the four crash windows."""
    _clear_stale(path)
    tmp = f"{path}.{os.getpid()}.writing"
    try:
        if windows:
            _window("pre-write")
        torch.save(obj, tmp)
        if windows:
            _window("post-write")
            _window("mid-swap")
        os.replace(tmp, path)
        if windows:
            _window("post-swap")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, tree: dict) -> None:
    """Write a checkpoint (a dict of tensors, numbers and dicts of them);
    tensors are copied to the host first. The ``ckpt.save`` fault site
    fires at its four crash windows."""
    _atomic_save(_to_cpu(tree), path, windows=True)


def load_checkpoint(path: str) -> dict:
    """Read what :func:`save_checkpoint` wrote (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_torch_pkl(state_dict: dict, path: str) -> None:
    """Params as a reference torch state_dict pickle (float32, on the CPU)
    that the reference's ``model.load_state_dict`` reads. Switch-MoE params
    are refused, as JAX's bridge refuses them: the reference has no
    experts."""
    if any(".moe." in k for k in state_dict):
        raise ValueError(
            "MoE params (num_experts > 1) have no reference torch layout — "
            "the bridge covers the reference's dense architecture only")
    _atomic_save({k: v.detach().to("cpu", torch.float32, copy=True)
                  for k, v in state_dict.items()}, path)


def load_torch_pkl(path: str) -> dict:
    """A reference ``*.pkl`` (bare state_dict, or a dict holding one under
    ``state_dict``) as a state_dict in the port's (= the reference's) names;
    DDP's ``module.`` prefix is stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in obj.items()}


def check_loaded_params(loaded: dict, expected: dict, src_path: str) -> None:
    """Refuse, loudly and naming the leaves, a warm-start or resume source
    whose names or shapes differ from this model's (a stale file from a
    differently sized run under the same name)."""
    if set(loaded) != set(expected):
        missing = sorted(set(expected) - set(loaded))[:4]
        extra = sorted(set(loaded) - set(expected))[:4]
        raise ValueError(
            f"initializing file {src_path} does not match this model config "
            f"(different parameters — missing {missing}, unexpected {extra}: "
            "wrong depth, positional-embedding mode, or bias layout)")
    mism = [f"{k}: file {tuple(loaded[k].shape)} vs model {tuple(v.shape)}"
            for k, v in expected.items() if tuple(loaded[k].shape) != tuple(v.shape)]
    if mism:
        raise ValueError(
            f"initializing file {src_path} does not match this model config "
            f"— {'; '.join(mism[:4])}"
            + (f"; +{len(mism) - 4} more" if len(mism) > 4 else ""))
