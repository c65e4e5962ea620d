"""Switch-style mixture-of-experts MLP (counterpart of
``ddim_cold_tpu/models/moe.py``).

``num_experts`` > 1 swaps each block's dense Mlp for a top-1 routed expert
bank (Switch Transformer, arXiv:2101.03961): :class:`SwitchMlp`, with JAX's
fields and parameters (``router`` (D, E), ``w1`` (E, D, H), ``b1`` (E, H),
``w2`` (E, H, O), ``b2`` (E, O): the state_dict keys
``blocks.{i}.moe.{router,w1,b1,w2,b2}``, in JAX's layout). Kept from the
JAX module:

* routing per batch row over its N tokens, with per-expert capacity
  ``C = max(1, ceil(N·cf/E))`` (N is the sequence the trunk runs: the
  token cache's k tokens there); a token's queue position is the number of
  earlier tokens of its row routed to its expert, and tokens past C are
  dropped (their MLP delta is 0: they ride the residual);
* the router in float32 whatever the block computes in, outside any
  autocast; ``argmax`` takes the first maximum, as ``jnp.argmax``;
* exact-erf GELU, dropout on the hidden ``h`` (B, E, C, H) and on the
  output, drawn from the block's explicit generator;
* the two dispatches: ``"einsum"``, the cumsum queue position and the
  one-hot (B, N, E, C) dispatch and combine tensors (O(B·N²·cf) memory), and
  ``"index"``, a stable sort by expert id, the capacity gather, and the
  token-side combine that inverts the sort (O(B·N·cf·D)). The stable sort
  keeps token order inside an expert, so the same tokens overflow as under
  the cumsum priority; the one-hot products are exact, so the two agree.

The Switch load-balance term ``E · Σ_e frac_e · mean_prob_e`` over all
(B, N) tokens, which JAX ``sow``s, comes out through an explicit channel:
a forward given a ``losses`` list appends this call's :class:`RouterStats`
(the tokens routed to each expert, the router probabilities' sums, the
token count), and :func:`mean_load_balance` turns a forward's records into
the train step's aux (the mean over layers; on a mesh the statistics are
summed over the ``data`` and ``seq`` groups before the product, so the
term is the global batch's). No module state or global is involved.

Expert parallelism (:meth:`SwitchMlp.shard_experts`, an ``expert`` mesh
axis): as in JAX the batch is not split over ``expert``; each rank keeps
E/ep experts of the bank and computes them for its rows. The bank's input
and the gate enter through Megatron's *f* (the gate reaches the combine of
every rank's experts, so its gradient is summed over the group and the
router's is counted once; the router runs on the input before *f* and the
load-balance statistics are whole on every rank), the rank's partial
combine leaves through *g* (a float32 sum), and the hidden units' dropout
mask is drawn whole and sliced per rank.

Sequence parallelism (the block's ``shard``): a rank holds a token block,
so a token's queue position counts the routed tokens of the blocks before
it (an exclusive prefix of the per-(row, expert) counts over the ``seq``
group), C comes from the whole sequence, and the block's padding tokens take
no capacity and stay out of the statistics: the routing is the
one-process routing. Queue slots keep their whole-sequence numbers, so the
hidden units' dropout mask (drawn for every slot) is the one-process one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ddim_cold_torch.models.init import trunc_normal_
from ddim_cold_torch.models.vit import TensorShard, _dropout
from ddim_cold_torch.parallel import mesh as pmesh

DISPATCHES = ("einsum", "index")


class RouterStats(NamedTuple):
    """One bank call's routing statistics (float32), the load-balance
    term's inputs: per expert the tokens routed to it (``routed``, (E,)) and
    the sum of its router probability over the tokens (``prob``, (E,), with
    its gradient), and the tokens counted (``count``, a scalar); and per
    expert the tokens its capacity kept (``kept``, (E,): the dropped share
    is ``1 − Σ kept / count``)."""

    routed: torch.Tensor
    prob: torch.Tensor
    count: torch.Tensor
    kept: Optional[torch.Tensor] = None


def capacity(n_tokens: int, capacity_factor: float, num_experts: int) -> int:
    """Per-expert queue length ``max(1, ceil(N·cf/E))`` (JAX moe.py:73)."""
    return max(1, math.ceil(n_tokens * capacity_factor / num_experts))


def load_balance(stats: RouterStats) -> torch.Tensor:
    """The Switch term ``E · Σ_e frac_e · mean_prob_e`` of one call."""
    count = stats.count
    return stats.routed.shape[0] * torch.sum(stats.routed / count * (stats.prob / count))


def mean_load_balance(records: Sequence, groups: Sequence = (),
                      scale: float = 1.0) -> torch.Tensor:
    """The aux of one forward: the mean over its ``records`` — each a
    :class:`RouterStats` (one block call) or a value already averaged (the
    pipelined apply's). ``groups``: the statistics are every rank's shares
    of the global batch's, summed over each group before the product
    (``parallel.mesh.reduce_shares``, whose backward scales each share's
    gradient by ``scale``, the data size the train step divides by)."""
    stats = [r for r in records if isinstance(r, RouterStats)]
    values = [r.reshape(()) for r in records if not isinstance(r, RouterStats)]
    if stats and groups:  # one flat buffer: (routed, prob, count) of every call
        flat = torch.cat([torch.cat([s.routed, s.prob, s.count.reshape(1)]) for s in stats])
        flat = pmesh.reduce_shares(flat, groups, scale)
        E = [s.routed.shape[0] for s in stats]
        stats = [RouterStats(p[:e], p[e:2 * e], p[2 * e])
                 for p, e in zip(flat.split([2 * e + 1 for e in E]), E)]
    values += [load_balance(s) for s in stats]
    if not values:
        raise ValueError("no load-balance records: the model has no expert banks")
    return torch.stack(values).mean()


class SwitchMlp(nn.Module):
    """Top-1 routed expert bank, in place of the block's dense ``Mlp``
    (see the module). ``shard``: the block's sequence block under sequence
    parallelism (a ``parallel.mesh.SeqShard``)."""

    def __init__(self, in_features: int, num_experts: int, hidden_features: int,
                 out_features: int, capacity_factor: float = 1.25, drop: float = 0.0,
                 dispatch: str = "einsum", shard: Optional[pmesh.SeqShard] = None):
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'einsum' or 'index', got {dispatch!r}")
        E, D, H, O = num_experts, in_features, hidden_features, out_features
        self.num_experts = E
        self.capacity_factor = capacity_factor
        self.drop = drop
        self.dispatch = dispatch
        self.shard = shard
        self.ep: Optional[TensorShard] = None
        self.router = nn.Parameter(torch.empty(D, E))
        self.w1 = nn.Parameter(torch.empty(E, D, H))
        self.b1 = nn.Parameter(torch.empty(E, H))
        self.w2 = nn.Parameter(torch.empty(E, H, O))
        self.b2 = nn.Parameter(torch.empty(E, O))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's init: trunc_normal(.02) on the router and the expert
        kernels, zero biases."""
        for p in (self.router, self.w1, self.w2):
            trunc_normal_(p, generator)
        for p in (self.b1, self.b2):
            nn.init.zeros_(p)

    def shard_experts(self, ep: TensorShard) -> None:
        """Keep this rank's E/ep experts (dim 0 of ``w1``, ``b1``, ``w2``,
        ``b2``); the router stays whole."""
        n = self.num_experts // ep.size
        for name in ("w1", "b1", "w2", "b2"):
            t = getattr(self, name).detach()
            setattr(self, name, nn.Parameter(t[ep.index * n:(ep.index + 1) * n].clone()))
        self.ep = ep

    def _offset(self, counts: torch.Tensor,
                shard: Optional[pmesh.SeqShard]) -> Optional[torch.Tensor]:
        """(B, E): the tokens of each row routed to each expert on the seq
        ranks before this one (None without sequence parallelism)."""
        if shard is None:
            return None
        with torch.no_grad():
            every = pmesh.gather_cat(counts[None], shard.group, dim=0)
        return every[:shard.lo // shard.n_local].sum(0)

    def route(self, x: torch.Tensor) -> tuple:
        """The router on ``x`` (B, n, D), in float32 outside any autocast
        (softmax stability under bf16 compute): the probabilities (B, n, E),
        each token's expert (the first maximum, as ``jnp.argmax``) and its
        gate, the expert's probability."""
        with torch.autocast(x.device.type, enabled=False):
            probs = torch.softmax(x.float() @ self.router.float(), dim=-1)
        expert = probs.argmax(-1)
        return probs, expert, probs.gather(-1, expert[..., None])[..., 0]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                losses: Optional[list] = None,
                shard: Optional[pmesh.SeqShard] = None) -> torch.Tensor:
        """``shard``: the token block x is, when it is not the block's own (a
        token-cache reuse step's k live tokens: capacity follows k)."""
        B, n, D = x.shape
        E, dt, ep = self.num_experts, x.dtype, self.ep
        shard = self.shard if shard is None else shard
        C = capacity(n if shard is None else shard.total, self.capacity_factor, E)
        probs, expert, gate = self.route(x)                        # (B, n, E), (B, n)
        onehot = F.one_hot(expert, E).float()                      # (B, n, E)
        valid = None if shard is None else shard.valid(B, x.device)
        if valid is not None:  # padding tokens route nowhere
            onehot = onehot * valid[..., None]
        offset = self._offset(onehot.sum(1), shard)
        # ---- this rank's experts [lo, hi) --------------------------------
        lo, hi = (0, E) if ep is None else (ep.index * E // ep.size,
                                            (ep.index + 1) * E // ep.size)
        if ep is not None:
            x = pmesh.copy_to_group(x, ep.group)
            gate = pmesh.copy_to_group(gate, ep.group)
        if self.dispatch == "index":
            # stable sort by expert id (padding last): slot priority, and so
            # the overflow set, is the einsum path's cumsum priority
            key = expert if valid is None else torch.where(valid, expert, E)
            perm = torch.sort(key, dim=1, stable=True).indices      # (B, n)
            key_sorted = key.gather(1, perm)
            x_sorted = x.gather(1, perm[..., None].expand(-1, -1, D))
            counts = onehot.sum(1).long()                           # (B, E)
            starts = torch.cumsum(counts, 1) - counts
            first = (torch.zeros_like(counts) if offset is None else offset.long())
            # expert e's global queue slot c holds sorted token starts + c − first
            c_ar = torch.arange(C, device=x.device)
            f, s = first[:, lo:hi, None], starts[:, lo:hi, None]
            q_valid = (c_ar >= f) & (c_ar < f + counts[:, lo:hi, None])   # (B, El, C)
            idx = (s + c_ar - f).clamp(0, n - 1).reshape(B, -1)
            xe = x_sorted.gather(1, idx[..., None].expand(-1, -1, D))
            xe = xe.reshape(B, hi - lo, C, D) * q_valid[..., None].to(dt)
        else:
            pos = torch.cumsum(onehot, 1) - onehot                  # (B, n, E)
            if offset is not None:
                pos = pos + offset[:, None, :]
            keep = onehot * (pos < C)  # dropped tokens zero out here
            kept = keep.sum((0, 1))
            slot = F.one_hot((pos * onehot).sum(-1).long().clamp(max=C - 1), C).float()
            dispatch = (keep[..., None] * slot[:, :, None, :])[:, :, lo:hi]  # (B, n, El, C)
            xe = torch.einsum("bnd,bnec->becd", x, dispatch.to(dt))
        # ---- the experts: this rank's slice of the stacked banks --------
        h = torch.einsum("becd,edh->bech", xe, self.w1.to(dt)) + self.b1.to(dt)[None, :, None]
        h = F.gelu(h, approximate="none")
        h = _dropout(h, self.drop, generator, part=None if ep is None else (1, ep))
        ye = torch.einsum("bech,eho->beco", h, self.w2.to(dt)) + self.b2.to(dt)[None, :, None]
        if ep is not None:  # the partial combine is summed over the group in f32
            ye = ye.float()
        if self.dispatch == "index":
            # token-side combine: each token reads its own queue slot; its
            # rank inside its expert group comes from inverting the sort
            ends = torch.cat([starts, counts.sum(1, keepdim=True)], 1)   # padding: key E
            rank = torch.arange(n, device=x.device)[None] - ends.gather(1, key_sorted)
            tok_pos = torch.empty_like(rank).scatter_(1, perm, rank)     # (B, n)
            tok_pos = tok_pos + first.gather(1, expert)
            kept = (onehot * (tok_pos < C)[..., None]).sum((0, 1))
            keep_tok = (tok_pos < C) & (expert >= lo) & (expert < hi)
            if valid is not None:
                keep_tok = keep_tok & valid
            slot_tok = ((expert - lo) * C + tok_pos).clamp(0, (hi - lo) * C - 1)
            y = ye.reshape(B, -1, ye.shape[-1]).gather(
                1, slot_tok[..., None].expand(-1, -1, ye.shape[-1]))
            y = y * (gate * keep_tok).to(dt).to(y.dtype)[..., None]
        else:
            combine = (dispatch * gate[..., None, None]).to(dt).to(ye.dtype)
            y = torch.einsum("beco,bnec->bno", ye, combine)
        if ep is not None:
            y = pmesh.reduce_from_group(y, ep.group).to(dt)
        if losses is not None:
            if valid is None:
                prob, count = probs.sum((0, 1)), torch.tensor(float(B * n), device=x.device)
            else:
                prob, count = (probs * valid[..., None]).sum((0, 1)), valid.sum().float()
            losses.append(RouterStats(onehot.sum((0, 1)), prob, count, kept))
        return _dropout(y, self.drop, generator, shard=shard)
