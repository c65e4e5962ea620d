"""Parameter initializers matching the reference's torch semantics.

Counterpart of ``ddim_cold_tpu/models/init.py``. The reference initializes
every Linear, the time embedding, the positional embedding and the class
token with ``trunc_normal_(std=.02)``, whose truncation bounds are the
ABSOLUTE values [a, b] = [−2, 2] (reference ViT.py:12-50). The patch
embedding is an ``nn.Conv2d`` that the reference's ``_init_weights`` leaves
at torch's default ``kaiming_uniform_(a=√5)``: U(±1/√fan_in) for kernel and
bias. Both take an explicit ``torch.Generator`` so a model is a pure
function of its seed.
"""

from __future__ import annotations

import math

import torch


def _norm_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


@torch.no_grad()
def trunc_normal_(tensor: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02, mean: float = 0.0, a: float = -2.0,
                  b: float = 2.0) -> torch.Tensor:
    """Fill ``tensor`` from a normal truncated to ABSOLUTE bounds [a, b]:
    U(2l−1, 2u−1) through erfinv, scaled by std·√2, shifted, clamped."""
    lo = _norm_cdf((a - mean) / std)
    hi = _norm_cdf((b - mean) / std)
    tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    tensor.erfinv_().mul_(std * math.sqrt(2.0)).add_(mean)
    return tensor.clamp_(min=a, max=b)


@torch.no_grad()
def torch_default_uniform_(tensor: torch.Tensor, fan_in: int,
                           generator: torch.Generator) -> torch.Tensor:
    """torch's default Linear/Conv init, U(±1/√fan_in)
    (kaiming_uniform_(a=√5): gain √(1/3) · √(3/fan_in) = 1/√fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)
    return tensor.uniform_(-bound, bound, generator=generator)
