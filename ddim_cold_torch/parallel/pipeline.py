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
the block: the seq ranks of a data row draw alike. ``expert`` (a Switch-MoE
model's banks are expert-parallel inside the stage, as ``model``) composes
too. JAX's errors hold for depth % p, B % M, a non-sequence-parallel block
under ``seq_axis`` and a Switch-MoE model under ``seq_axis``.

``with_aux`` (pipe×MoE): the pipeline also returns the Switch load-balance
aux, the mean of every block call's term across (layer, microbatch), the
bubble steps computing none (JAX pipeline.py:80-95): each router sees one
microbatch, so it is a mean of per-microbatch terms, not the unpipelined
whole-batch term. Each stage sums its blocks' terms, the sum is summed over
the stages, and the backward hands each microbatch's terms their share of
the aux's gradient inside the same reverse schedule.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel import sharding

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
                 generator: Optional[torch.Generator], with_aux: bool = False):
        self.model, self.group = model, mesh.get_group(axis)
        self.with_aux = with_aux
        self.p = pmesh.axis_size(mesh, axis)
        self.s = pmesh.axis_index(mesh, axis)
        self.M = n_microbatch
        self.blocks = list(sharding.stage_blocks(model.depth, mesh, axis))
        self.generator = generator
        self.last = dist.get_global_rank(self.group, self.p - 1)

    def active(self, i: int) -> bool:
        return 0 <= i - self.s < self.M

    @property
    def calls(self) -> int:
        """Block calls of the whole trunk: depth × microbatches."""
        return self.model.depth * self.M

    def stage(self, tok: torch.Tensor, j: int):
        """This stage's blocks on microbatch ``j``: the tokens and (with
        ``with_aux``) the sum of their Switch load-balance terms, or None."""
        from ddim_cold_torch.models.moe import load_balance
        from ddim_cold_torch.ops.sampling import fold_in  # sampling imports parallel/

        records = [] if self.with_aux else None
        for layer in self.blocks:
            gen = (None if self.generator is None
                   else fold_in(self.generator, j * self.model.depth + layer))
            tok = self.model.run_block(layer, tok, gen, records)
        aux = sum(load_balance(r) for r in records) if records else None
        return tok, aux

    def forward(self, tokens: torch.Tensor, keep: bool):
        """The schedule's forward: the last stage's outputs on every stage,
        the aux (with ``with_aux``, else 0) and (``keep``) each microbatch's
        (input, output, aux terms) graph."""
        mbs = tokens.chunk(self.M)
        like = mbs[0]
        saved, outs, buf = {}, [None] * self.M, None
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        T = self.M + self.p - 1
        for i in range(T):
            j = i - self.s
            y = None
            if self.active(i):
                inp = mbs[j] if self.s == 0 else buf
                if keep:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out, terms = self.stage(inp, j)
                    saved[j] = (inp, out, terms)
                    y = out.detach()
                else:
                    y, terms = self.stage(inp, j)
                if terms is not None:
                    aux = aux + terms.detach()
                if self.s == self.p - 1:
                    outs[j] = y
            if i < T - 1:
                buf = _exchange(y, like, self.group, send=y is not None and self.s < self.p - 1,
                                recv=self.s > 0 and self.active(i + 1), back=False)
        out = (torch.cat(outs) if self.s == self.p - 1
               else torch.empty_like(tokens))
        dist.broadcast(out, src=self.last, group=self.group)
        if self.with_aux:
            dist.all_reduce(aux, group=self.group)
            aux = aux / self.calls
        return out, aux, saved

    def backward(self, grad: torch.Tensor, grad_aux: torch.Tensor, saved: dict,
                 params: list):
        """The reverse schedule: the gradient of the stage's input tokens
        (stage 0) and of ``params``, from the output's gradient and the
        aux's (each block call's term weighs 1/calls in the aux)."""
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
            inp, out, terms = saved.pop(j)
            outs, g_outs = [out], [g_out]
            if terms is not None and terms.requires_grad:
                outs.append(terms)
                g_outs.append(grad_aux / self.calls)
            grads = torch.autograd.grad(outs, [inp] + params, g_outs, allow_unused=True)
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
        out, aux, saved = sched.forward(tokens, keep)
        ctx.sched, ctx.saved, ctx.params = sched, saved, params
        return out, aux

    @staticmethod
    def backward(ctx, grad: torch.Tensor, grad_aux: torch.Tensor):
        tok, g_params = ctx.sched.backward(grad, grad_aux, ctx.saved, list(ctx.params))
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
    every stage; with ``with_aux``, ``(tokens, aux)`` (see the module).
    Requires depth % p == 0 and B % n_microbatch == 0."""
    del batch_axis  # each rank holds its own rows: nothing to do per data row
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
    if seq_axis is not None:
        _refuse_seq_moe(model, seq_axis)
    if model.pipe_axis != axis or model.stage is None:
        raise ValueError(f"the model does not hold pipeline stages along {axis!r}: "
                         f"build it with pipe_axis={axis!r}")
    sched = _Schedule(model, mesh, axis, M, None if deterministic else generator,
                      with_aux)
    params = [p for i in sched.blocks for p in model.blocks[i].parameters()]
    out, aux = _Pipeline.apply(sched, tokens, *params)
    return (out, aux) if with_aux else out


def _refuse_seq_moe(model, seq_axis: str) -> None:
    """JAX's pipe×seq×MoE error (pipeline.py:116-132)."""
    if getattr(model, "num_experts", 1) > 1:
        raise ValueError(
            "pipeline×sequence parallelism does not compose with "
            "num_experts > 1: the stage body would route each seq "
            "shard's tokens through shard-local Switch capacity, "
            "silently diverging from the unsharded model — drop the "
            f"'{seq_axis}' axis or use the {{data, seq, expert}} mesh")


def make_pipelined_apply(model, mesh, *, axis: str = "pipe",
                         batch_axis: Optional[str] = "data",
                         seq_axis: Optional[str] = "seq", n_microbatch: int = 2):
    """An ``apply_fn(x, t, deterministic=True, generator=None, losses=None)``
    in place of ``model(...)``: embed (on every stage, cheap) → pipelined
    blocks → head (on every stage, on the broadcast output). ``model`` must
    be built with ``scan_blocks=True`` and ``pipe_axis=axis``; a ``seq_axis``
    of more than one rank in the mesh needs the model sequence-parallel over
    it (and no expert banks). Given a ``losses`` list, the pipeline's aux
    (``with_aux``) is appended to it: the model's ``losses`` channel, which
    ``models.moe.mean_load_balance`` reads (``apply_fn.supports_losses``, as
    JAX's)."""
    if not model.scan_blocks:
        raise ValueError("pipelined apply requires scan_blocks=True")
    if seq_axis is None or pmesh.axis_size(mesh, seq_axis) == 1:
        seq_axis = None
    else:
        _refuse_seq_moe(model, seq_axis)

    def apply_fn(x, t, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 losses: Optional[list] = None):
        tokens = model(x, t, deterministic, generator, stage="embed")
        tokens = pipeline_blocks(model, tokens, mesh, axis=axis, batch_axis=batch_axis,
                                 seq_axis=seq_axis, n_microbatch=n_microbatch,
                                 deterministic=deterministic, generator=generator,
                                 with_aux=losses is not None)
        if losses is not None:
            tokens, aux = tokens
            losses.append(aux)
        return model(x, t, deterministic, generator, stage="head", tokens=tokens)

    apply_fn.supports_losses = True
    return apply_fn
