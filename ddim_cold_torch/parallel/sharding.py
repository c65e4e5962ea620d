"""Tensor- and pipeline-parallel shard plans over the state_dict
(counterpart of ``ddim_cold_tpu/parallel/sharding.py``).

JAX annotates each parameter with a ``PartitionSpec`` and lets GSPMD place
the shards. The port runs one process per device, so a plan says, per
state_dict key, which torch dim splits over which mesh axis
(:class:`KeyPlan`), and each rank's model holds only its shards
(:class:`~ddim_cold_torch.models.vit.DiffusionViT` with ``head_axis`` and
``pipe_axis``). Megatron's column → row rules over the ``model`` axis, on
torch's ``(out, in)`` weights:

* ``attn.qkv`` and ``mlp.fc1`` split by column, the output dim (dim 0) —
  ``qkv`` by whole heads: its 3·C outputs are (3, H, hd), so each of the
  three thirds splits over the axis (``groups=3``) and ``model`` must
  divide ``num_heads``; their bias (and an int8 tree's ``scale``) follow;
* ``attn.proj`` and ``mlp.fc2`` split by row, the input dim (dim 1); their
  bias and ``scale`` (per output channel) stay whole;
* the patch embedding, LayerNorms, head and the cls/pos/time tables stay
  replicated; an int8 tree's ``w_int8`` splits as the weight it encodes.

A Switch-MoE expert bank (``blocks.{i}.moe.*``, JAX's ``_spec_for``,
sharding.py:35-46) splits its stacked ``w1``, ``b1``, ``w2`` and ``b2``
along dim 0, the experts, over the ``expert`` axis (the port keeps the
``blocks.{i}`` modules, so the expert axis always leads); the ``router``
stays whole, and the bank is whole along ``model``.

Under a ``pipe`` axis (:func:`pipeline_param_specs`) every ``blocks.{i}``
key belongs to one stage: depth/p consecutive blocks a stage, the stage
being block ``i``'s rank along ``pipe`` (``KeyPlan.stage``), with the tensor
split inside it.

:func:`shard_state_dict` cuts a whole (one-process) state_dict into this
rank's shards and :func:`gather_state_dict` puts the ranks' shards back
together on every rank; they are exact inverses. Checkpoints hold the
gathered state_dict, in the one-process format.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.parallel import mesh as pmesh

_COL = {"attn": ("qkv",), "mlp": ("fc1",)}  # output-dim sharded
_ROW = {"attn": ("proj",), "mlp": ("fc2",)}  # input-dim sharded
_BLOCK = re.compile(r"^blocks\.(\d+)\.")


class KeyPlan(NamedTuple):
    """One key's layout: ``dims[d]`` is the mesh axis torch dim ``d`` splits
    over (None: whole); ``groups`` > 1 splits each of that many equal runs
    of the dim (``qkv``'s q, k and v); ``stage`` names the axis whose ranks
    each own a run of whole blocks (None: every rank holds the key)."""

    dims: tuple
    groups: int = 1
    stage: Optional[str] = None

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.dims)


def block_index(key: str) -> Optional[int]:
    """``i`` of a ``blocks.{i}.…`` key; None for the others."""
    m = _BLOCK.match(key)
    return int(m.group(1)) if m else None


def _tensor_plan(key: str, ndim: int, axis: Optional[str],
                 expert_axis: Optional[str] = None) -> KeyPlan:
    """JAX's ``_spec_for`` on a torch key: the Megatron split over ``axis``
    and an expert bank's over ``expert_axis`` (None: replicated)."""
    whole = KeyPlan((None,) * ndim)
    parts = key.split(".")
    if ".moe." in key:
        if expert_axis is None or parts[-1] == "router":
            return whole
        return KeyPlan((expert_axis,) + (None,) * (ndim - 1))
    if axis is None or block_index(key) is None or len(parts) < 3:
        return whole
    parent, module, leaf = parts[-3], parts[-2], parts[-1]
    if module in _COL.get(parent, ()):
        dims = (axis, None) if leaf in ("weight", "w_int8") else (axis,)
        return KeyPlan(dims[:ndim], groups=3 if module == "qkv" else 1)
    if module in _ROW.get(parent, ()):
        return KeyPlan((None, axis) if leaf in ("weight", "w_int8") else (None,) * ndim)
    return whole


def plan_for(state, tp_axis: Optional[str] = None, pipe_axis: Optional[str] = None,
             expert_axis: Optional[str] = None) -> dict:
    """key → :class:`KeyPlan` of ``state`` (a state_dict, or a dict of key →
    shape) for a model split over ``tp_axis`` (Megatron's plan; a
    ``model`` axis under any name), ``pipe_axis`` (every ``blocks.{i}``
    key belongs to one stage) and ``expert_axis`` (the expert banks)."""
    out = {}
    for k, v in state.items():
        plan = _tensor_plan(k, len(_shape(v)), tp_axis, expert_axis)
        out[k] = (plan._replace(stage=pipe_axis)
                  if pipe_axis is not None and block_index(k) is not None else plan)
    return out


def _named(axes, name: str) -> Optional[str]:
    return name if name in tuple(axes) else None


def param_partition_specs(state, axes=("model", "expert")) -> dict:
    """JAX's ``param_partition_specs``: the plan of tensor parallelism over
    the ``model`` axis and of the expert banks over the ``expert`` axis,
    each when ``axes`` names it."""
    return plan_for(state, _named(axes, "model"), None, _named(axes, "expert"))


def pipeline_param_specs(state, axis: str = "pipe", tensor_axes=()) -> dict:
    """JAX's ``pipeline_param_specs``: every block a stage's along ``axis``,
    with the ``model`` and ``expert`` splits inside it when
    ``tensor_axes`` names them; every other key replicated."""
    return plan_for(state, _named(tensor_axes, "model"), axis,
                    _named(tensor_axes, "expert"))


def plan_for_mesh(state, mesh) -> dict:
    """:func:`plan_for` the mesh's ``model``, ``pipe`` and ``expert`` axes
    of more than one rank (``parallel.layout.layout_for_mesh``'s
    selection)."""
    tp, pipe, ep = (a if pmesh.axis_size(mesh, a) > 1 else None
                    for a in ("model", "pipe", "expert"))
    return plan_for(state, tp, pipe, ep)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(v)


def stage_blocks(depth: int, mesh, axis: str) -> range:
    """The blocks this rank's stage owns along ``axis``: ``depth / p``
    consecutive ones (JAX's error when ``p`` does not divide ``depth``)."""
    p = pmesh.axis_size(mesh, axis)
    if depth % p:
        raise ValueError(f"depth {depth} not divisible by {p} pipeline stages")
    bps = depth // p
    s = pmesh.axis_index(mesh, axis)
    return range(s * bps, (s + 1) * bps)


def _depth(keys) -> int:
    idx = [block_index(k) for k in keys]
    return 1 + max((i for i in idx if i is not None), default=-1)


def take_part(t: torch.Tensor, dim: int, index: int, parts: int,
              groups: int = 1) -> torch.Tensor:
    """Part ``index`` of ``parts`` of ``t`` along ``dim``, taken from each
    of ``groups`` equal runs of the dim (a view)."""
    n = t.shape[dim] // groups
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{parts} parts")
    runs = t.unflatten(dim, (groups, n))
    return runs.narrow(dim + 1, index * (n // parts), n // parts).flatten(dim, dim + 1)


def shard_tensor(t: torch.Tensor, plan: KeyPlan, mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor under ``plan`` (a copy)."""
    for d, axis in enumerate(plan.dims):
        if axis is not None:
            t = take_part(t, d, pmesh.axis_index(mesh, axis),
                          pmesh.axis_size(mesh, axis), plan.groups)
    return t.clone()


def shard_state_dict(state: dict, mesh, plan: Optional[dict] = None) -> dict:
    """This rank's part of a whole state_dict: its stage's blocks only, each
    tensor cut per ``plan`` (default :func:`plan_for_mesh`). Keys stay the
    one-process names (``blocks.{i}`` keeps its global ``i``)."""
    plan = plan_for_mesh(state, mesh) if plan is None else plan
    depth = _depth(state)
    out = {}
    for k, v in state.items():
        p = plan[k]
        if p.stage is not None and block_index(k) not in stage_blocks(depth, mesh,
                                                                       p.stage):
            continue
        out[k] = shard_tensor(v, p, mesh)
    return out


def _gather_tensor(t: torch.Tensor, plan: KeyPlan, mesh) -> torch.Tensor:
    for d, axis in reversed(list(enumerate(plan.dims))):
        if axis is None or pmesh.axis_size(mesh, axis) == 1:
            continue
        group = mesh.get_group(axis)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat([x.unflatten(d, (plan.groups, -1)) for x in parts],
                      dim=d + 1).flatten(d, d + 1)
    return t


def gather_state_dict(state: dict, mesh, plan: Optional[dict] = None,
                      depth: Optional[int] = None) -> dict:
    """The whole (one-process) state_dict from this rank's part ``state``, on
    every rank (on ``state``'s device), in the one-process key order: the
    tensor splits all-gathered along their axes, then each stage's blocks
    broadcast along ``pipe`` by the stage that holds them (in one flat
    buffer a stage; every block has the same keys and shapes). Every rank
    of the mesh calls it at once. ``plan`` defaults to :func:`plan_for_mesh`
    of ``state`` (whose block keys may be one stage's: the plan of a key
    depends on its name only); ``depth`` to the stages times this stage's
    blocks."""
    plan = plan_for_mesh(state, mesh) if plan is None else plan
    local = {k: _gather_tensor(v, plan[k], mesh).detach() for k, v in state.items()}
    keys = list(local)
    blocks = [k for k in keys if block_index(k) is not None]
    axes = {plan[k].stage for k in blocks} - {None}
    if not axes or not blocks:
        return local
    (axis,) = axes
    parts = pmesh.axis_size(mesh, axis)
    mine = sorted({block_index(k) for k in blocks})
    suffixes = list(dict.fromkeys(_BLOCK.sub("", k) for k in blocks))
    n = depth if depth is not None else len(mine) * parts
    if n % parts:
        raise ValueError(f"depth {n} not divisible by {parts} pipeline stages")
    bps = n // parts
    like = [local[f"blocks.{mine[0]}.{s}"] for s in suffixes]
    full = dict(local)
    group = mesh.get_group(axis)
    for stage in range(parts):
        held = range(stage * bps, (stage + 1) * bps)
        if pmesh.axis_index(mesh, axis) == stage:
            flat = torch._utils._flatten_dense_tensors(
                [local[f"blocks.{i}.{s}"] for i in held for s in suffixes])
        else:
            flat = torch.empty(sum(t.numel() for t in like) * bps, dtype=like[0].dtype,
                               device=like[0].device)
        dist.broadcast(flat, src=dist.get_global_rank(group, stage), group=group)
        got = torch._utils._unflatten_dense_tensors(flat, like * bps)
        for j, t in enumerate(got):
            i, s = held[j // len(suffixes)], suffixes[j % len(suffixes)]
            full[f"blocks.{i}.{s}"] = t
    first = keys.index(blocks[0])
    order = (keys[:first] + [f"blocks.{i}.{s}" for i in range(n) for s in suffixes]
             + [k for k in keys[first:] if block_index(k) is None])
    return {k: full[k] for k in order}
