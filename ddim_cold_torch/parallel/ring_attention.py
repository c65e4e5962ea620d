"""Ring attention: sequence parallelism by K/V rotation (counterpart of
``ddim_cold_tpu/parallel/ring_attention.py``; Ring Attention,
arXiv:2310.01889).

Each rank of a ``seq`` group holds a block of the tokens' q, k and v. The
K/V blocks rotate around the ring, S − 1 hops (the last block is consumed
outside the loop, so no dead exchange rides the link), and every rank folds
each block into a running (numerator, denominator, max) with the online
softmax (``ops/flash_attention.online_softmax_update``), in float32: the
logits a rank ever holds are (B, H, n_local, n_local). Padded positions
(the sequence rarely divides the ring) are masked as keys by a validity
mask that travels with its block.

Autograd cannot pass through the exchange, so :class:`RingAttention` is a
``torch.autograd.Function``: the forward keeps each row's log-sum-exp; the
backward runs the ring again, rebuilding each block's P from the lse,
keeping dQ on its rank and sending the dK/dV accumulators around with their
blocks, which arrive home after one more hop. Each exchange is
:func:`~ddim_cold_torch.parallel.mesh.ring_shift` under the
``sp/ring_exchange`` scope; the per-block step is plain PyTorch, as JAX's is
plain XLA, and launches no hand-written kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.ops.flash_attention import exp_f32, online_softmax_update
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel.ulysses import check_head_axis
from ddim_cold_torch.utils import profiling

_NEG_INF = -1e30


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    with profiling.scope("sp/ring_exchange"):
        return pmesh.ring_shift(x, group)


def _pack(*ts: torch.Tensor, dtype) -> torch.Tensor:
    """One (B, L) buffer of the flattened per-row tensors, for one exchange."""
    return torch.cat([t.reshape(t.shape[0], -1).to(dtype) for t in ts], dim=1)


def _unpack(buf: torch.Tensor, shapes: list) -> list:
    out, lo = [], 0
    for shape in shapes:
        n = 1
        for s in shape[1:]:
            n *= s
        out.append(buf[:, lo:lo + n].reshape(shape))
        lo += n
    return out


def _logits(qf, k_blk, valid_blk, scale):
    """(B, H, nq, nk) f32 logits of q against a K block, invalid keys at
    ``_NEG_INF``. qf (B, H, nq, D) f32; k_blk (B, nk, H, D)."""
    logits = torch.einsum("bhqd,bkhd->bhqk", qf, k_blk.float()) * scale
    return torch.where(valid_blk[:, None, None, :] > 0.5, logits,
                       torch.full((), _NEG_INF, device=logits.device))


class RingAttention(torch.autograd.Function):
    """Differentiable ring attention on local shards (see the module)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, group, scale):
        B, n, H, D = q.shape
        size = dist.get_world_size(group)
        qf = q.float().transpose(1, 2)  # (B, H, n, D)
        o = torch.zeros((B, H, n, D), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, n), _NEG_INF, dtype=torch.float32, device=q.device)
        shapes = [tuple(k.shape), tuple(v.shape), (B, n)]
        k_blk, v_blk, valid_blk = k, v, kv_valid.to(k.dtype)
        for _ in range(size - 1):
            o, l, m = online_softmax_update(o, l, m, _logits(qf, k_blk, valid_blk, scale),
                                            v_blk.float().transpose(1, 2))
            k_blk, v_blk, valid_blk = _unpack(
                _exchange(_pack(k_blk, v_blk, valid_blk, dtype=k.dtype), group), shapes)
        o, l, m = online_softmax_update(o, l, m, _logits(qf, k_blk, valid_blk, scale),
                                        v_blk.float().transpose(1, 2))
        out = o / l[..., None]  # (B, H, n, D) f32
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.group, ctx.scale = group, scale
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        size = dist.get_world_size(group)
        B, n, H, D = q.shape
        qf = q.float().transpose(1, 2)
        dof = do.float().transpose(1, 2)  # (B, H, n, D)
        delta = (dof * out).sum(-1)  # (B, H, n)
        dq = torch.zeros_like(qf)
        kv_shapes = [tuple(k.shape), tuple(v.shape), (B, n)]
        d_shapes = [(B, H, n, D), (B, H, n, D)]
        k_blk, v_blk, valid_blk = k.float(), v.float(), kv_valid.float()
        dk_blk = torch.zeros((B, H, n, D), dtype=torch.float32, device=q.device)
        dv_blk = torch.zeros_like(dk_blk)
        for s in range(size):
            logits = _logits(qf, k_blk, valid_blk, scale)
            p = exp_f32(logits - lse[..., None])  # masked keys: exactly 0
            vf = v_blk.transpose(1, 2)  # (B, H, nk, D)
            dv_blk = dv_blk + torch.einsum("bhqk,bhqd->bhkd", p, dof)
            dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds, k_blk) * scale
            dk_blk = dk_blk + torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
            if s < size - 1:
                k_blk, v_blk, valid_blk, dk_blk, dv_blk = _unpack(
                    _exchange(_pack(k_blk, v_blk, valid_blk, dk_blk, dv_blk,
                                    dtype=torch.float32), group),
                    kv_shapes + d_shapes)
        if size > 1:
            # the accumulators held now belong to the next rank's block
            dk_blk, dv_blk = _unpack(
                _exchange(_pack(dk_blk, dv_blk, dtype=torch.float32), group), d_shapes)
        return (dq.transpose(1, 2).to(q.dtype), dk_blk.transpose(1, 2).to(k.dtype),
                dv_blk.transpose(1, 2).to(v.dtype), None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], *, group,
                   scale: float) -> torch.Tensor:
    """Blockwise-softmax attention with K/V ring rotation over ``group``.

    Local shards: q/k/v ``(B, n_local, H, D)``, ``kv_valid`` ``(B, n_local)``
    bool (True = a real token) or None. Returns ``(B, n_local, H, D)`` in
    q's dtype. Non-causal: every query attends to every valid key of the
    whole ring."""
    B, n = q.shape[:2]
    if kv_valid is None:
        kv_valid = torch.ones((B, n), dtype=torch.bool, device=q.device)
    return RingAttention.apply(q, k, v, kv_valid, group, float(scale))


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                        axis: str = "data", batch_axis: Optional[str] = None,
                        head_axis: Optional[str] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Front end over whole arrays: q/k/v ``(B, N, H, D)`` as every rank
    holds them; this rank takes its rows along ``batch_axis`` (if any) and
    its block of the sequence (padded to the ring size) along ``axis``, runs
    :func:`ring_attention`, and the blocks are gathered back, so every rank
    returns the dense-softmax result ``(B, N, H, D)``
    (:func:`~ddim_cold_torch.parallel.mesh.over_sequence`). ``head_axis``
    (tensor parallelism): this rank also takes its heads along that axis,
    so each tp group rings only its own heads (softmax is per head)."""
    if scale is None:
        scale = q.shape[-1]**-0.5
    if head_axis is not None:
        check_head_axis(mesh, head_axis, q.shape[2])
    return pmesh.over_sequence(
        lambda shard, q, k, v: ring_attention(q, k, v, shard.valid(q.shape[0], q.device),
                                              group=shard.group, scale=scale),
        (q, k, v), mesh, axis, batch_axis, head_axis)
