"""Ulysses sequence parallelism: all-to-all head↔sequence resharding
(counterpart of ``ddim_cold_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses,
arXiv:2309.14509).

Instead of rotating K/V around a ring, the sequence-sharded q, k and v are
exchanged with ONE all-to-all so that each rank of the ``seq`` group holds
the WHOLE sequence for H/S of the heads, attends locally (softmax is per
head: no cross-rank softmax state), and a second all-to-all gives every rank
its tokens back with every head. The local attention is the hand-written
flash kernel on CUDA (its plain version on the CPU), the blockwise route, or
the dense einsum, by ``use_flash`` as in JAX. Padded positions are sliced
off between the two exchanges, so the local attention never sees them.

The exchanges (:func:`~ddim_cold_torch.parallel.mesh.all_to_all`, one each
way, q, k and v in one buffer) run under the ``sp/all_to_all_gather`` and
``sp/all_to_all_scatter`` scopes; autograd runs them backwards with the
inverse exchange. Needs the head count divisible by the seq group; the ring
has no such constraint.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.ops.flash_attention import (DEFAULT_BLOCK_KV, blockwise_attention_xla,
                                                 flash_attention_qkv)
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.utils import profiling


class SeqParallelConfigError(ValueError):
    """A sequence-parallel geometry that cannot run: head count vs seq-axis
    divisibility (Ulysses' structural requirement). Subclasses ValueError so
    existing callers' error handling keeps working; raised with an actionable
    message naming the serving config knobs (``SamplerConfig.sp_mode`` /
    ``sp_degree``) — the engine's ring fallback catches exactly this class
    when resolving a config's attention strategy."""


def heads_error(heads: str, axis: str, parts: int) -> SeqParallelConfigError:
    """JAX's message for heads (``heads``: the count as JAX words it) that
    do not divide over ``axis``'s ``parts`` ranks."""
    return SeqParallelConfigError(
        f"ulysses needs local heads ({heads}) divisible by the '{axis}' axis "
        f"({parts}); use sp_mode='ring' otherwise (serving: SamplerConfig("
        "sp_mode='ring', sp_degree=...), or pick an sp_degree that divides the "
        "local head count)")


def check_head_axis(mesh, head_axis: str, heads: int) -> int:
    """The ``head_axis`` size, with JAX's errors for an axis the mesh lacks
    and heads that do not divide over it."""
    names = tuple(mesh.mesh_dim_names or ())
    if head_axis not in names:
        shape = {a: pmesh.axis_size(mesh, a) for a in names}
        raise ValueError(f"head_axis {head_axis!r} is not an axis of the mesh {shape} "
                         "— drop it, or add the tp axis to the mesh")
    tp = pmesh.axis_size(mesh, head_axis)
    if heads % tp:
        raise SeqParallelConfigError(
            f"num_heads ({heads}) must divide over the '{head_axis}' axis ({tp})")
    return tp


def _local_attention(qkv: torch.Tensor, scale: float, use_flash,
                     block_kv: Optional[int]) -> torch.Tensor:
    """Attention of a ``(B, N, 3, H, D)`` projection, ``(B, N, H, D)`` in its
    dtype: the flash kernels (``use_flash=True``), the blockwise route
    (``"xla"``) or the dense einsum in float32 (False)."""
    if use_flash == "xla":
        return blockwise_attention_xla(*qkv.unbind(2), scale,
                                       block_kv or DEFAULT_BLOCK_KV).to(qkv.dtype)
    if use_flash:
        return flash_attention_qkv(qkv, scale)
    q, k, v = (x.float() for x in qkv.unbind(2))
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(qkv.dtype)


def ulysses_attention_qkv(qkv: torch.Tensor, *, group, n_valid: Optional[int] = None,
                          scale: float, use_flash: "bool | str" = False,
                          block_kv: Optional[int] = None,
                          axis_name: str = "seq") -> torch.Tensor:
    """:func:`ulysses_attention` of a local ``(B, n_loc, 3, H, D)`` qkv
    projection (the model's layout: one buffer to exchange, and the flash
    kernels read q, k and v as its slices). Returns ``(B, n_loc, H, D)``."""
    S = dist.get_world_size(group)
    B, n_loc, _, H, D = qkv.shape
    if H % S != 0:
        raise heads_error(str(H), axis_name, S)
    Np = n_loc * S
    n_valid = Np if n_valid is None else int(n_valid)
    Hs = H // S
    # seq-sharded → head-sharded: chunk j (heads j·H/S …) goes to rank j,
    # which receives every rank's tokens for its heads in rank order
    send = qkv.reshape(B, n_loc, 3, S, Hs, D).permute(3, 0, 1, 2, 4, 5)
    with profiling.scope("sp/all_to_all_gather"):
        got = pmesh.all_to_all(send.contiguous(), group)  # (S, B, n_loc, 3, Hs, D)
    full = got.permute(1, 0, 2, 3, 4, 5).reshape(B, Np, 3, Hs, D)[:, :n_valid]
    out = _local_attention(full, scale, use_flash, block_kv)  # (B, n_valid, Hs, D)
    if Np > n_valid:
        out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, Np - n_valid))
    # head-sharded → seq-sharded
    back = out.reshape(B, S, n_loc, Hs, D).permute(1, 0, 2, 3, 4)
    with profiling.scope("sp/all_to_all_scatter"):
        got = pmesh.all_to_all(back.contiguous(), group)  # (S, B, n_loc, Hs, D)
    return got.permute(1, 2, 0, 3, 4).reshape(B, n_loc, H, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                      n_valid: Optional[int] = None, scale: float,
                      use_flash: "bool | str" = False,
                      block_kv: Optional[int] = None,
                      axis_name: str = "seq") -> torch.Tensor:
    """Ulysses attention on LOCAL shards: q/k/v ``(B, n_loc, H, D)`` with the
    sequence split over ``group`` (padded so ``n_loc · S`` covers it);
    ``n_valid`` is the unpadded global length; ``axis_name`` names the
    group's mesh axis in errors. Requires ``H % S == 0``.
    Returns ``(B, n_loc, H, D)``, differentiable through the exchanges and
    the local attention."""
    return ulysses_attention_qkv(torch.stack((q, k, v), dim=2), group=group,
                                 n_valid=n_valid, scale=scale, use_flash=use_flash,
                                 block_kv=block_kv, axis_name=axis_name)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                           axis: str = "seq", batch_axis: Optional[str] = None,
                           head_axis: Optional[str] = None,
                           scale: Optional[float] = None,
                           use_flash: "bool | str" = False,
                           flash_blocks: Optional[tuple] = None) -> torch.Tensor:
    """Front end over whole arrays, the mirror of
    :func:`~ddim_cold_torch.parallel.ring_attention.ring_self_attention`:
    q/k/v ``(B, N, H, D)`` as every rank holds them; this rank's rows along
    ``batch_axis`` and its block of the padded sequence along ``axis`` go
    through :func:`ulysses_attention`, and every rank returns the whole
    result. ``flash_blocks[1]`` is the blockwise route's key block.
    ``head_axis`` (tensor parallelism): this rank also takes its H/tp heads
    along that axis, and the exchanges split each tp group's local heads
    over ``axis`` (every (tp, sp) pair attends over H/(tp·sp) heads of the
    whole sequence); needs ``(H / tp) % sp == 0``."""
    B, N, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    tp = check_head_axis(mesh, head_axis, H) if head_axis is not None else 1
    parts = pmesh.axis_size(mesh, axis)
    if (H // tp) % parts != 0:  # before any exchange
        raise heads_error(f"{H}//{tp}={H // tp}", axis, parts)
    block_kv = flash_blocks[1] if flash_blocks else None
    return pmesh.over_sequence(
        lambda shard, q, k, v: ulysses_attention(
            q, k, v, group=shard.group, n_valid=N, scale=scale, use_flash=use_flash,
            block_kv=block_kv, axis_name=axis),
        (q, k, v), mesh, axis, batch_axis, head_axis)
