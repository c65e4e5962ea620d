"""Pipeline parallelism: GPipe microbatching over a ``pipe`` mesh axis, one
process per device (counterpart of ``ddim_cold_tpu/parallel/pipeline.py``).

Each rank of the ``pipe`` axis holds depth/p consecutive blocks (a
``DiffusionViT`` built with ``pipe_axis``: the other stages' blocks are not
there). The batch splits into M microbatches and the (M + p − 1)-step
schedule runs: at step i stage s applies its blocks to microbatch i − s,
when there is one (JAX computes the bubble steps and discards them; the
port computes nothing there), and hands the result to stage s + 1. The last
stage's outputs are broadcast to every stage, as JAX's psum does, so the
head and the loss run on every stage as in one process.

Autograd is not left to order the stage exchanges: a backward through
several exchanges could take them in another order on each rank and hang.
:class:`_Pipeline` is one ``torch.autograd.Function`` whose forward keeps
each microbatch's graph inside the stage and whose backward drives the
reverse schedule itself: the same number of exchanges in the same order on
every rank, each stage handing its input's gradient back to the one before.
An exchange is one ``all_to_all_single`` over the ``pipe`` group in which
only the neighbours' splits are non-empty (gloo cannot carry point to point
on CUDA tensors; ``mesh.ring_shift`` does the same).

Composition: ``data`` (each data row pipelines its own rows), ``model``
(the stage's blocks are tensor-parallel: their collectives run inside each
microbatch's forward and backward), ``seq`` (the model is sequence-parallel:
a microbatch is ``(B/M, n_local, C)`` token blocks, the padding masked by
the blocks' ring or left out by Ulysses) and ``remat`` (each block under
``torch.utils.checkpoint``, recomputed inside the schedule's backward).
Each block of each microbatch draws its dropout masks from a generator
folded from the step's (``ops.sampling.fold_in``) with the microbatch and
the block: the seq ranks of a data row draw alike. JAX's errors hold for
depth % p, B % M and a non-sequence-parallel block under ``seq_axis``;
``with_aux`` and the ``losses`` collection (MoE) are ROADMAP.md Queue 1
item 18.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel import sharding

_MOE = "ROADMAP.md Queue 1 item 18 (MoE)"


def _exchange(y: Optional[torch.Tensor], like: torch.Tensor, group, send: bool,
              recv: bool, back: bool) -> Optional[torch.Tensor]:
    """``y`` to the next stage (the previous one when ``back``) when
    ``send``, a tensor like ``like`` from the previous (next) one when
    ``recv``: one ``all_to_all_single`` every stage calls."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    n = like.numel()
    to, frm = (r - 1, r + 1) if back else (r + 1, r - 1)
    send_splits, recv_splits = [0] * size, [0] * size
    if send:
        send_splits[to] = n
    if recv:
        recv_splits[frm] = n
    src = (y.contiguous().reshape(-1) if send
           else torch.empty(0, dtype=like.dtype, device=like.device))
    out = torch.empty(n if recv else 0, dtype=like.dtype, device=like.device)
    dist.all_to_all_single(out, src, recv_splits, send_splits, group=group)
    return out.reshape(like.shape) if recv else None


class _Schedule:
    """One pipelined trunk call: the stage, its blocks and the schedule."""

    def __init__(self, model, mesh, axis: str, n_microbatch: int,
                 generator: Optional[torch.Generator]):
        self.model, self.group = model, mesh.get_group(axis)
        self.p = pmesh.axis_size(mesh, axis)
        self.s = pmesh.axis_index(mesh, axis)
        self.M = n_microbatch
        self.blocks = list(sharding.stage_blocks(model.depth, mesh, axis))
        self.generator = generator
        self.last = dist.get_global_rank(self.group, self.p - 1)

    def active(self, i: int) -> bool:
        return 0 <= i - self.s < self.M

    def stage(self, tok: torch.Tensor, j: int) -> torch.Tensor:
        """This stage's blocks on microbatch ``j``."""
        from ddim_cold_torch.ops.sampling import fold_in  # sampling imports parallel/

        for layer in self.blocks:
            gen = (None if self.generator is None
                   else fold_in(self.generator, j * self.model.depth + layer))
            tok = self.model.run_block(layer, tok, gen)
        return tok

    def forward(self, tokens: torch.Tensor, keep: bool):
        """The schedule's forward: the last stage's outputs on every stage,
        and (``keep``) each microbatch's (input, output) graph."""
        mbs = tokens.chunk(self.M)
        like = mbs[0]
        saved, outs, buf = {}, [None] * self.M, None
        T = self.M + self.p - 1
        for i in range(T):
            j = i - self.s
            y = None
            if self.active(i):
                inp = mbs[j] if self.s == 0 else buf
                if keep:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = self.stage(inp, j)
                    saved[j] = (inp, out)
                    y = out.detach()
                else:
                    y = self.stage(inp, j)
                if self.s == self.p - 1:
                    outs[j] = y
            if i < T - 1:
                buf = _exchange(y, like, self.group, send=y is not None and self.s < self.p - 1,
                                recv=self.s > 0 and self.active(i + 1), back=False)
        out = (torch.cat(outs) if self.s == self.p - 1
               else torch.empty_like(tokens))
        dist.broadcast(out, src=self.last, group=self.group)
        return out, saved

    def backward(self, grad: torch.Tensor, saved: dict, params: list):
        """The reverse schedule: the gradient of the stage's input tokens
        (stage 0) and of ``params``."""
        chunks = grad.chunk(self.M)
        like = chunks[0]
        g_params = [None] * len(params)
        g_tokens = [None] * self.M
        g_inp = None
        T = self.M + self.p - 1
        for i in reversed(range(T)):
            got = None
            if i < T - 1:
                got = _exchange(g_inp, like, self.group,
                                send=g_inp is not None and self.s > 0,
                                recv=self.s < self.p - 1 and self.active(i), back=True)
            g_inp = None
            if not self.active(i):
                continue
            j = i - self.s
            g_out = chunks[j] if self.s == self.p - 1 else got
            inp, out = saved.pop(j)
            grads = torch.autograd.grad(out, [inp] + params, g_out, allow_unused=True)
            for k, g in enumerate(grads[1:]):
                if g is not None:
                    g_params[k] = g if g_params[k] is None else g_params[k] + g
            if self.s == 0:
                g_tokens[j] = grads[0]
            else:
                g_inp = grads[0]
        tok = torch.cat(g_tokens) if self.s == 0 else None
        return tok, g_params


class _Pipeline(torch.autograd.Function):
    """The pipelined trunk as one autograd node (see the module)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, tokens: torch.Tensor, *params):
        keep = any(ctx.needs_input_grad[1:])
        out, saved = sched.forward(tokens, keep)
        ctx.sched, ctx.saved, ctx.params = sched, saved, params
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        tok, g_params = ctx.sched.backward(grad, ctx.saved, list(ctx.params))
        return (None, tok, *g_params)


def pipeline_blocks(model, tokens: torch.Tensor, mesh, *, axis: str = "pipe",
                    batch_axis: Optional[str] = "data", seq_axis: Optional[str] = None,
                    n_microbatch: int = 2, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    with_aux: bool = False) -> torch.Tensor:
    """Run the trunk of ``model`` (built with ``pipe_axis=axis``) through the
    pipeline: ``tokens`` ``(B, n, C)`` are this rank's rows (along
    ``batch_axis``; the port's mesh gives each rank its own rows already)
    and, with ``seq_axis``, its token block; returns the trunk's output on
    every stage. Requires depth % p == 0 and B % n_microbatch == 0."""
    del batch_axis  # each rank holds its own rows: nothing to do per data row
    if with_aux:
        raise NotImplementedError(f"pipeline_blocks(with_aux=True) is not ported yet: {_MOE}")
    sharding.stage_blocks(model.depth, mesh, axis)  # JAX's depth error
    B, M = tokens.shape[0], int(n_microbatch)
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if seq_axis is not None and model.shard is None:
        # JAX: sharding tokens under a non-sequence-parallel block would
        # attend block-diagonally, silently wrong
        raise ValueError(
            "seq_axis is set but `block` is not the manual-ring "
            "template — build it with block_template(model, "
            "seq_manual_axis=...)")
    if model.pipe_axis != axis or model.stage is None:
        raise ValueError(f"the model does not hold pipeline stages along {axis!r}: "
                         f"build it with pipe_axis={axis!r}")
    sched = _Schedule(model, mesh, axis, M, None if deterministic else generator)
    params = [p for i in sched.blocks for p in model.blocks[i].parameters()]
    return _Pipeline.apply(sched, tokens, *params)


def make_pipelined_apply(model, mesh, *, axis: str = "pipe",
                         batch_axis: Optional[str] = "data",
                         seq_axis: Optional[str] = "seq", n_microbatch: int = 2):
    """An ``apply_fn(x, t, deterministic=True, generator=None)`` in place of
    ``model(...)``: embed (on every stage, cheap) → pipelined blocks → head
    (on every stage, on the broadcast output). ``model`` must be built with
    ``scan_blocks=True`` and ``pipe_axis=axis``; a ``seq_axis`` of more
    than one rank in the mesh needs the model sequence-parallel over it."""
    if not model.scan_blocks:
        raise ValueError("pipelined apply requires scan_blocks=True")
    if seq_axis is None or pmesh.axis_size(mesh, seq_axis) == 1:
        seq_axis = None

    def apply_fn(x, t, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None, mutable=None):
        if mutable not in (None, False):
            raise NotImplementedError(
                f"the pipelined apply's 'losses' collection is not ported yet: {_MOE}")
        tokens = model(x, t, deterministic, generator, stage="embed")
        tokens = pipeline_blocks(model, tokens, mesh, axis=axis, batch_axis=batch_axis,
                                 seq_axis=seq_axis, n_microbatch=n_microbatch,
                                 deterministic=deterministic, generator=generator)
        return model(x, t, deterministic, generator, stage="head", tokens=tokens)

    return apply_fn
