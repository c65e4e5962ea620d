"""Losses (counterpart of ``ddim_cold_tpu/ops/losses.py``). The reference
trains and evaluates with mean smooth-L1 (Huber, beta=1) —
``F.smooth_l1_loss`` at multi_gpu_trainer.py:43,124."""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Mean smooth-L1 in float32: 0.5·d²/beta for |d| < beta, |d| − 0.5·beta
    otherwise."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()
