"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``device=None`` means ``"cuda"``, and a CUDA request on a machine without
CUDA raises instead of moving to the CPU.
"""

from __future__ import annotations

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
