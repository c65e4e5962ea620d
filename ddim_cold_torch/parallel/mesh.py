"""The mesh and its collectives, one process per device (counterpart of
``ddim_cold_tpu/parallel/mesh.py``).

The reference ran one OS process per GPU, rendezvoused over TCP
(multi_gpu_trainer.py:25-30), wrapped the model in DDP and sharded its data
with DistributedSampler. The JAX package drives every chip of a host from
one process instead, over a named ``Mesh``. The port goes back to one
process per card, as PyTorch does it: :func:`initialize_distributed` joins
the ``torch.distributed`` world, :func:`make_mesh` names its axes with a
``DeviceMesh`` (``data``: batch rows; ``seq``: tokens; ``model``: attention
heads and Mlp hidden units, Megatron's tensor parallelism; ``pipe``:
pipeline stages; ``expert``: the Switch-MoE expert banks), and each process
holds its own rows and tokens, and the parameters of its
``model``/``pipe``/``expert`` coordinates
(:mod:`~ddim_cold_torch.parallel.sharding`), equal along ``data`` and
``seq``.

The collectives the parallel layers need are here too, each one call that
both NCCL and gloo carry, with no branch on the backend:

* :func:`copy_to_group` and :func:`reduce_from_group` — Megatron's *f* and
  *g* around a tensor-parallel (column → row) pair of linears;

* :func:`all_to_all` — ``all_to_all_single`` in equal chunks along dim 0,
  differentiable (its backward is the same exchange of the gradient);
* :func:`ring_shift` — the whole tensor to the next rank of a group, the
  previous rank's in return: ``all_to_all_single`` with every split but the
  neighbour's empty (not differentiable: the ring's own backward calls it);
* :func:`gather_cat` — every rank's tensor concatenated along a dim,
  differentiable with the backward every rank of the group computing the
  same function of the result needs: its own slice of the gradient;
* :func:`all_reduce_flat` — a list of tensors summed across a group in a
  few flat buffers (:func:`all_reduce_mesh`: across a whole mesh);
* :func:`reduce_shares` — every rank's share of a global statistic summed
  over groups, each share's gradient its own (scaled);
* :func:`rows_to_blocks` and :func:`rows_from_blocks` — a subset of a
  split sequence's rows (the token cache's live tokens) moved from the
  ranks that hold them into the blocks of the subset's own
  :meth:`SeqShard.resized` geometry, and back.

The serving engine across ranks adds :func:`submesh` (a named mesh over a
given list of ranks, such as a sequence-parallel ``(data, seq)`` mesh over
an engine's ranks), :func:`mesh_ranks`, :func:`local_group`, :func:`wait`
(a collective's wait bounded per call), and the dispatch broadcast: a fixed
int64 header (:data:`HEADER`, :func:`broadcast_header`) and then the
batch's tensors (:func:`broadcast_tensors`), with no pickling.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ddim_cold_torch.utils.platform import resolve_device

#: the mesh axes the port runs
PORTED_AXES = ("data", "seq", "model", "pipe", "expert")

#: the axes whose ranks hold identical parameters (every other axis, the
#: ``model``, ``pipe`` and ``expert`` ones, holds a shard of them)
REPLICA_AXES = ("data", "seq")

#: largest flat buffer :func:`all_reduce_flat` sums in one call (DDP's
#: default bucket)
BUCKET_BYTES = 25 * 2**20


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *, device=None) -> bool:
    """Join the process group (the reference's TCP rendezvous,
    multi_gpu_trainer.py:25-30; JAX's ``jax.distributed.initialize``).

    ``world_size``/``rank`` default to torchrun's ``WORLD_SIZE``/``RANK``,
    ``init_method`` to ``env://`` when ``MASTER_ADDR`` is set. A world of one
    with no ``init_method`` and no launcher environment initialises nothing
    and returns False, as JAX's does for one process; otherwise the group is
    joined (once: a second call with the same world returns False) and True
    is returned. ``backend`` defaults to NCCL when ``device`` (None means
    ``"cuda"``) is a CUDA device and to gloo for the CPU; a caller that wants
    gloo on CUDA tensors names it."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks "
                               f"exists; asked for {world_size}")
        return False
    if world_size <= 1 and init_method is None:
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def free_port() -> int:
    """A free local TCP port for a ``tcp://localhost:<port>`` rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape: Optional[dict] = None, device=None):
    """A ``DeviceMesh`` over the process group's ranks with named axes
    (``init_device_mesh``). ``shape`` e.g. ``{"data": 2, "seq": 2}``: axis
    order is dict order (the first outermost), and the sizes must multiply
    to the world size; default ``{"data": world}``. ``device`` (None means
    ``"cuda"``) sets the mesh's device type. Needs
    :func:`initialize_distributed` first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    sizes = tuple(int(s) for s in shape.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh shape {dict(shape)} does not match {world} devices")
    return init_device_mesh(resolve_device(device).type, sizes,
                            mesh_dim_names=tuple(shape))


def axis_size(mesh, axis: Optional[str]) -> int:
    """Ranks along ``axis``; 1 for no mesh, no axis or an axis the mesh
    lacks."""
    if mesh is None or axis is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate along ``axis`` (0 where :func:`axis_size` is 1
    for want of the axis)."""
    if mesh is None or axis is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def data_axis_size(mesh) -> int:
    """Shards a batch's leading dim splits into on this mesh: 1 for no mesh
    or a mesh without a ``data`` axis (batch replicated). JAX's
    ``data_axis_size``."""
    return axis_size(mesh, "data")


def shard_rows(x, mesh, axis: str = "data", dim: int = 0):
    """This rank's rows of ``x`` (tensor or array) along ``axis``: block
    ``axis_index`` of ``axis_size`` equal blocks of dim ``dim``."""
    parts = axis_size(mesh, axis)
    if parts == 1:
        return x
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"batch of {n} rows does not divide over the '{axis}' "
                         f"axis ({parts})")
    b = n // parts
    i = axis_index(mesh, axis)
    return x[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]


def shard_batch(batch, mesh, grouped: bool = False):
    """This rank's rows of a global batch (a tuple of tensors or arrays)
    along ``data``, the whole batch along ``seq`` (every seq rank of a data
    row reads the same rows): the port's ``shard_batch``. ``grouped``: the
    batch carries a leading steps-per-dispatch axis
    (``train.step.make_train_step``), which stays whole; ``data`` splits
    the per-step rows behind it, so a rank holds its shard of every inner
    step (JAX's ``batch_sharding(grouped=True)``)."""
    return tuple(shard_rows(x, mesh, dim=1 if grouped else 0) for x in batch)


class SeqShard(NamedTuple):
    """This rank's block of a token axis of ``total`` positions split over
    the ranks of ``group``: tokens ``[lo, lo + n_real)``, held as ``n_local``
    rows (the sequence is padded to equal blocks, so the last block may be
    short or empty of real tokens). ``mode`` is the model's ``sp_mode``."""

    group: object
    total: int
    n_local: int
    lo: int
    n_real: int
    mode: Optional[str] = None

    def pad(self, x: torch.Tensor, value=0.0) -> torch.Tensor:
        """``x`` (B, n_real, …) padded to (B, n_local, …) with ``value``."""
        extra = self.n_local - self.n_real
        if not extra:
            return x
        fill = torch.full((x.shape[0], extra, *x.shape[2:]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill], dim=1)

    def take(self, x: torch.Tensor, value=0.0) -> torch.Tensor:
        """This block of a whole ``x`` (B, total, …), padded: (B, n_local, …)."""
        return self.pad(x[:, self.lo:self.lo + self.n_real], value)

    def valid(self, batch: int, device) -> torch.Tensor:
        """(B, n_local) bool: True on real tokens."""
        pos = torch.arange(self.lo, self.lo + self.n_local, device=device)
        return (pos < self.total)[None].expand(batch, -1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block (B, n_local, …) joined into the whole (B,
        total, …), on every rank of the group."""
        return gather_cat(x, self.group, dim=1)[:, :self.total]

    def resized(self, total: int) -> "SeqShard":
        """This rank's block of ``total`` positions over the same group and
        mode: the geometry of a subset of the sequence, such as the k live
        tokens a token-cache reuse step runs its trunk at."""
        parts, index = ((1, 0) if self.group is None
                        else (dist.get_world_size(self.group), dist.get_rank(self.group)))
        n_loc = -(-total // parts)
        lo = index * n_loc
        return SeqShard(group=self.group, total=total, n_local=n_loc, lo=lo,
                        n_real=max(0, min(n_loc, total - lo)), mode=self.mode)


def _expand_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``rows`` (B, m) as a ``gather``/``scatter`` index over dim 1 of a
    ``like``-shaped (B, n, …) tensor."""
    return rows.reshape(*rows.shape, *(1,) * (like.dim() - 2)).expand(
        *rows.shape, *like.shape[2:])


def rows_to_blocks(x: torch.Tensor, shard: SeqShard, rows: torch.Tensor,
                   sub: SeqShard) -> torch.Tensor:
    """The rows at global positions ``rows`` ((B, k), the same on every rank
    of the group) of a sequence split by ``shard``, this rank's block ``x``
    (B, n_local, …), laid out as ``sub``'s blocks of those k rows: this
    rank's (B, sub.n_local, …), its padding zero. One ``all_gather`` of the
    blocks over the group: every rank then holds the whole sequence and
    takes its block of the subset. Simpler than an ``all_to_all_single``
    with per-rank splits, which would move only the live rows that change
    rank, at the cost of the whole stream a step."""
    mine = rows[:, sub.lo:sub.lo + sub.n_real]
    whole = shard.gather(x)
    return sub.pad(whole.gather(1, _expand_rows(mine, whole)))


def rows_from_blocks(y: torch.Tensor, sub: SeqShard, rows: torch.Tensor,
                     shard: SeqShard) -> tuple:
    """The inverse of :func:`rows_to_blocks`: ``sub``'s blocks ``y`` (B,
    sub.n_local, …) of the rows at global positions ``rows`` put back into
    this rank's block of ``shard``. Returns ``(block, owned)``: (B,
    shard.n_local, …) holding the rows of ``rows`` this rank owns (zeros
    elsewhere) and the (B, n_local) bool mask of them. One ``all_gather``
    of the subset's blocks; a rank may own many of the rows or none."""
    whole = sub.gather(y)  # (B, k, …)
    local = rows - shard.lo
    owned = (local >= 0) & (local < shard.n_real)
    # the rows another rank owns land in a spare row past the block
    idx = torch.where(owned, local, torch.full_like(local, shard.n_local))
    B = y.shape[0]
    block = y.new_zeros((B, shard.n_local + 1, *y.shape[2:]))
    block.scatter_(1, _expand_rows(idx, whole), whole)
    mask = torch.zeros((B, shard.n_local + 1), dtype=torch.bool, device=y.device)
    mask.scatter_(1, idx, True)
    return block[:, :shard.n_local], mask[:, :shard.n_local]


def seq_shard(mesh, axis: str, total: int, mode: Optional[str] = None) -> SeqShard:
    """This rank's :class:`SeqShard` of ``total`` positions along ``axis``."""
    parts = axis_size(mesh, axis)
    n_loc = -(-total // parts)
    lo = axis_index(mesh, axis) * n_loc
    return SeqShard(group=mesh.get_group(axis), total=total, n_local=n_loc, lo=lo,
                    n_real=max(0, min(n_loc, total - lo)), mode=mode)


def over_sequence(fn, xs: tuple, mesh, axis: str, batch_axis: Optional[str] = None,
                  head_axis: Optional[str] = None):
    """``fn(shard, *blocks)`` on this rank's rows (along ``batch_axis``, if
    any), token block (along ``axis``) and heads (dim 2, along
    ``head_axis``, if any) of whole ``(B, N, H, …)`` tensors ``xs``; its
    ``(B, n_local, …)`` result is gathered back, so every rank returns the
    whole ``(B, N, H, …)``. The gradients of a rank's inputs are its own
    rows, tokens and heads' share: summed over the ranks they are the whole
    gradient."""
    shard = seq_shard(mesh, axis, xs[0].shape[1])
    if batch_axis is not None:
        xs = tuple(shard_rows(x, mesh, batch_axis) for x in xs)
    if head_axis is not None:
        parts, i = axis_size(mesh, head_axis), axis_index(mesh, head_axis)
        h = xs[0].shape[2] // parts
        xs = tuple(x[:, :, i * h:(i + 1) * h] for x in xs)
    out = shard.gather(fn(shard, *(shard.take(x) for x in xs)))
    if head_axis is not None:
        out = gather_cat(out, mesh.get_group(head_axis), dim=2)
    if batch_axis is not None:
        out = gather_cat(out, mesh.get_group(batch_axis), dim=0)
    return out


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """``tensors`` of global rank ``src`` copied into every other rank's
    tensors of the same shapes and dtypes, through a few flat buffers
    (``src`` keeps its own untouched): parameters from rank 0, or a
    dispatch's inputs after its header, allocated from it."""
    mine = dist.get_rank() == src
    for bucket in _buckets(list(tensors)):
        flat = torch._utils._flatten_dense_tensors([t.detach() for t in bucket])
        dist.broadcast(flat, src=src, group=group)
        if mine:
            continue
        with torch.no_grad():
            for t, v in zip(bucket, torch._utils._unflatten_dense_tensors(flat, bucket)):
                t.copy_(v)


def _from_replica_zero(tensors: list, mesh) -> None:
    """``tensors`` of the first rank of each replica group copied into the
    others': over the world when ``mesh`` (None: the world) shards nothing,
    else along each of its :data:`REPLICA_AXES` in turn, from that axis's
    rank 0 (the ranks of a ``model`` or ``pipe`` axis hold other shards)."""
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if not set(names) - set(REPLICA_AXES):
        broadcast_tensors(tensors)
        return
    for axis in REPLICA_AXES:
        if axis_size(mesh, axis) > 1:
            group = mesh.get_group(axis)
            broadcast_tensors(tensors, src=dist.get_global_rank(group, 0), group=group)


def shard_params(model, mesh=None) -> None:
    """Every rank takes its replica group's first rank's parameters and
    buffers (rank 0's where ``mesh`` shards nothing: JAX's ``shard_params``
    with no specs). Under ``model``/``pipe`` axes each rank holds its own
    shard already (the model is built sharded,
    :mod:`~ddim_cold_torch.parallel.sharding`), equal along ``data`` and
    ``seq``."""
    if dist.is_initialized():
        _from_replica_zero(list(model.parameters()) + list(model.buffers()), mesh)


def shard_train_state(state, mesh=None):
    """:func:`shard_params` for a ``train.step.TrainState``: parameters, the
    EMA shadow and AdamW's moments, which are co-sharded with the
    parameters (lists in their order), so every replica starts from
    identical tensors."""
    if dist.is_initialized():
        shard_params(state.model, mesh)
        extra = list(state.ema_params) if state.ema_params is not None else []
        _from_replica_zero(list(state.mu) + list(state.nu) + extra, mesh)
    return state


def _buckets(tensors: list) -> list:
    """Consecutive runs of one dtype and device, each at most
    :data:`BUCKET_BYTES` (one tensor alone may exceed it)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or t.device != cur[0].device
                    or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def all_reduce_flat(tensors: list, group=None) -> list:
    """``tensors`` summed across ``group`` (default the world), through a few
    flat buffers; returns new tensors in their order and shapes."""
    out = []
    for bucket in _buckets(tensors):
        flat = torch._utils._flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        out.extend(torch._utils._unflatten_dense_tensors(flat, bucket))
    return out


def all_reduce_mesh(tensors: list, mesh) -> list:
    """``tensors`` summed over every rank of ``mesh``: :func:`all_reduce_flat`
    along each axis of more than one rank in turn."""
    for axis in mesh.mesh_dim_names:
        if axis_size(mesh, axis) > 1:
            tensors = all_reduce_flat(tensors, group=mesh.get_group(axis))
    return list(tensors)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` across ``group`` (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` from the previous rank of ``group``, this rank's ``x`` sent to
    the next: one ``all_to_all_single`` in which only the neighbours' splits
    are non-empty (NCCL runs it as one grouped send and receive)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    r = dist.get_rank(group)
    n = x.shape[0]
    send = [0] * size
    recv = [0] * size
    send[(r + 1) % size] = n
    recv[(r - 1) % size] = n
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal chunks along dim 0: chunk j goes to
    rank j, and rank j's chunk for this rank lands at position j. The
    exchange is its own inverse, so the backward sends the gradient back the
    same way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # the buffers are read and written as contiguous memory
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable equal-chunk all-to-all along dim 0 (size a multiple of
    the group's)."""
    if x.shape[0] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) must divide over "
                         f"the group ({dist.get_world_size(group)})")
    return _AllToAll.apply(x, group)


class _GatherCat(torch.autograd.Function):
    """Every rank's tensor, concatenated along ``dim`` in rank order. Every
    rank of the group computes the same function of the result (the sampler
    and the loss run on the whole image on each seq rank), so the gradient
    of this rank's input is its own slice of the result's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (all of one shape)."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherCat.apply(x, group, dim)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the backward sums the gradient
    over ``group`` (each rank's column shard contributes its share of the
    input's gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's *g*: the forward sums the ranks' partial products over
    ``group``; the backward passes the gradient through (every rank holds
    the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel linear (see :class:`_CopyToGroup`)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The summed output of a row-parallel linear (see
    :class:`_ReduceFromGroup`)."""
    return _ReduceFromGroup.apply(x, group)


class _ReduceShares(torch.autograd.Function):
    """Every rank's share of one global sum, summed over ``groups`` in
    turn; the backward gives each rank the gradient of its own share
    (every rank computes the same function of the sum), times ``scale``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups, scale: float) -> torch.Tensor:
        ctx.scale = scale
        x = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad * ctx.scale, None, None


def reduce_shares(x: torch.Tensor, groups: Sequence, scale: float = 1.0) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``groups`` (a share of a global
    statistic: the Switch-MoE router's counts and probabilities over the
    data and seq ranks). The train step averages the gradients over the
    ``data`` ranks, so it passes the data size as ``scale``: the shares'
    gradients, summed over the ranks and divided by it, are the whole
    statistic's."""
    return _ReduceShares.apply(x, tuple(groups), float(scale))


def mesh_ranks(mesh) -> list:
    """The global ranks of ``mesh``, in its order (the first axis
    outermost)."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def local_group(ranks: Sequence[int], timeout: Optional[float] = None,
                backend: Optional[str] = None):
    """A process group over ``ranks`` (this rank among them) that only they
    create: every rank of ``ranks`` calls this at once, in the same order
    as their other such calls. ``timeout`` in seconds bounds each of its
    collectives (None: the backend's default)."""
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    return dist.new_group(list(ranks), backend=backend, use_local_synchronization=True,
                          **kw)


def submesh(ranks: Sequence[int], shape: dict, device=None,
            timeout: Optional[float] = None):
    """A ``DeviceMesh`` with named axes over ``ranks`` (global ranks, this
    one among them), laid out in that order with the first axis outermost:
    ``submesh(r, {"data": 2, "seq": 2})`` puts each seq group on two
    consecutive ranks of ``r``, JAX's data-major ``make_mesh`` over a
    device list. Every rank of ``ranks`` calls it at once; the others need
    not (it works over a whole world and over a block of one). Each axis
    group bounds its collectives by ``timeout`` seconds (None: the
    backend's default)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(int(v) for v in shape.values())
    if math.prod(sizes) != len(ranks):
        raise ValueError(f"mesh shape {dict(shape)} does not match {len(ranks)} ranks")
    grid = torch.tensor([int(r) for r in ranks], dtype=torch.int64).reshape(sizes)
    hits = (grid == dist.get_rank()).nonzero()
    if not len(hits):
        raise ValueError(f"rank {dist.get_rank()} is not one of {list(ranks)}")
    coord = [int(c) for c in hits[0]]
    groups = []
    for dim in range(len(sizes)):
        index = list(coord)
        index[dim] = slice(None)
        groups.append(local_group(grid[tuple(index)].tolist(), timeout))
    return DeviceMesh.from_group(groups, resolve_device(device).type, mesh=grid,
                                 mesh_dim_names=tuple(shape))


def wait(work, timeout: Optional[float] = None) -> None:
    """Wait for an ``async_op`` collective's ``work``, at most ``timeout``
    seconds (None: its group's own bound); raises past it."""
    if timeout is None:
        work.wait()
    else:
        work.wait(datetime.timedelta(seconds=timeout))


#: the dispatch header's int64 fields, in order
HEADER = ("op", "config", "bucket", "rows", "attempt")


def broadcast_header(values: Optional[Sequence[int]], src: int, group,
                     timeout: Optional[float] = None) -> list:
    """The dispatch header, ``values`` (one int per :data:`HEADER` field) on
    global rank ``src``, None elsewhere, broadcast over ``group`` as one
    int64 CPU tensor; returns the fields on every rank. ``timeout`` in
    seconds bounds the wait (None: the group's own bound)."""
    buf = torch.zeros(len(HEADER), dtype=torch.int64)
    if values is not None:
        buf.copy_(torch.tensor([int(v) for v in values], dtype=torch.int64))
    wait(dist.broadcast(buf, src=src, group=group, async_op=True), timeout)
    return [int(v) for v in buf.tolist()]


def is_rank0() -> bool:
    """True in the process that writes (rank 0 of the world, or no world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()
