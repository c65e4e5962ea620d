"""The block sizes that change a w8a8 result.

The port's own copy of ``legal_block`` and ``sublane_unit`` from
``ddim_cold_tpu/ops/tiling.py``. It is not a tile rule set for the card: the
CUDA kernels pick their own tiles, and for float and w8a16 inputs a block
size changes only the f32 summation order. In the w8a8 mode it changes the
value. The fused Mlp requantises its hidden activation per ``block_m`` rows
and the fused trunk attention requantises its context per ``block_q``
rows, so the port must cut those row blocks exactly where the JAX package
does, and the JAX package cuts them with ``legal_block``. A block the
tuner offers is one ``legal_block`` leaves as it is (:func:`is_legal`), so
the block it times is the block the kernel runs.
"""

from __future__ import annotations

import torch


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def sublane_unit(dtype: torch.dtype) -> int:
    """The JAX package's sublane unit: 8 rows at 32 bits, 16 at 16, 32 at 8."""
    bits = torch.empty((), dtype=dtype).element_size() * 8
    try:
        return {32: 8, 16: 16, 8: 32}[bits]
    except KeyError:
        raise ValueError(f"no tile rule for {dtype} ({bits}-bit)") from None


def legal_block(requested: int, dim: int, dtype: torch.dtype) -> int:
    """The row (sublane) block the JAX package uses for a requested one:
    rounded up to the unit of ``dtype``, then clamped to ``dim`` rounded up
    to the same unit."""
    if requested < 1:
        raise ValueError(f"block size must be >= 1, got {requested}")
    if dim < 1:
        raise ValueError(f"array dim must be >= 1, got {dim}")
    unit = sublane_unit(dtype)
    return min(round_up(requested, unit), round_up(dim, unit))


def is_legal(block: int, dim: int, dtype: torch.dtype) -> bool:
    """True when ``legal_block`` returns ``block`` unchanged for an array dim
    of ``dim`` (a fixed point: the requested block is the one that runs)."""
    return block >= 1 and legal_block(block, dim, dtype) == block
