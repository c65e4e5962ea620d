"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``device=None`` means ``"cuda"``, and a CUDA request on a machine without
CUDA raises instead of moving to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def watchdog_stall_s(env_var: str, accel_default_s: float,
                     device: Union[str, torch.device]) -> float:
    """How long a device-touching loop may go silent before its
    ``StallWatchdog`` fires (the port's reading of
    ``ddim_cold_tpu/utils/platform.watchdog_stall_s``, which keys on JAX's
    platform).

    An explicit env value always wins (``0`` disarms; an empty string counts
    as unset). Otherwise the default is ``0`` (never armed) on a CPU device,
    where healthy runs of heavy sections legitimately blow any sane deadline
    and no device call can wedge, else ``accel_default_s``."""
    env = os.environ.get(env_var) or None
    if env is not None:
        return float(env)
    return 0.0 if torch.device(device).type == "cpu" else accel_default_s
