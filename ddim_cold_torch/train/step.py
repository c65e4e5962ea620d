"""The training step (counterpart of ``ddim_cold_tpu/train/step.py``).

One ``train_step(state, batch, generator, loss_rec) → (state, loss,
loss_rec)`` carries the reference inner loop (multi_gpu_trainer.py:109-134):
forward in the model's compute dtype (bf16 under "AMP": bf16 compute with
float32 parameters, no GradScaler), smooth-L1 loss in f32, global-norm clip
1.0, AdamW(wd=0.05) with a per-step cosine schedule to 0.

The optimizer is written out so that it equals the JAX package's optax
chain ``clip_by_global_norm(1.0) → adamw(cosine_decay_schedule(lr, T, 0),
b1=.9, b2=.999, eps=1e-8, weight_decay=.05)`` op for op, where PyTorch's own
pieces differ from it: ``clip_grad_norm_`` adds 1e-6 to the norm (optax does
not), optax's cosine reads the update count *before* the update, and optax's
AdamW decays every parameter, biases, LayerNorm and embeddings included. The
update is a pass of ``torch._foreach_*`` operations over the parameter list,
in place (PyTorch may update in place where JAX rebuilds the tree).

Randomness (dropout, drop path, a stochastic ``prepare``) comes from one
``torch.Generator`` on the model's device, drawn in a fixed order; it cannot
reproduce JAX's bits. The trainer makes each step's generator with
:func:`step_generator` from (seed, step) and, under data parallelism, the
rank's ``data`` coordinate, as JAX folds the step into its key
(``fold_in(rng, state.step)``): a run resumed at step s draws what the
uninterrupted run draws, data ranks draw apart, and the seq ranks of one
data row share their stream.

With a ``mesh`` (:mod:`ddim_cold_torch.parallel`, one process per device)
the step reduces the gradients across the ranks before the clip, so the
clip sees JAX's global gradient: a sum over the ``data`` and ``seq`` axes
in a few flat buffers, divided by the ``data`` size, is the mean over data
ranks of the sum over seq ranks. A seq rank's gradient is its own tokens'
share of its data row's loss (the model gathers the head's outputs with a
backward that keeps each rank's slice), so the sum over seq ranks is the
whole gradient. The logged loss is the same mean over data ranks.

Tensor and pipeline parallelism reduce by parameter class. A ``model``
rank's gradient of its shard is the whole gradient of that shard (the
column linears' input enters through Megatron's *f*), and of a whole
parameter the same on every ``model`` rank: nothing is summed over
``model``. A ``pipe`` stage holds the gradient of its own blocks; the
head's is the same on every stage (the trunk's output is broadcast and the
head runs on every stage), the embedding's is on stage 0 only and is summed
over the stages. The clip's ‖g‖ counts every element of the whole model
once: a shard's square sum is summed over the axes it is split along.
An ``expert`` rank holds the whole gradient of its experts' shard of each
bank (the bank's input and gate enter through Megatron's *f*), and of every
whole parameter, the router included, the same as the other ``expert``
ranks: nothing is summed over ``expert`` either.

Switch-MoE (``moe_aux_weight`` > 0 on a model with ``num_experts`` > 1):
the forward hands its banks' routing statistics back through its
``losses`` list, and ``moe_aux_weight × aux`` is added to the smooth-L1
(the logged loss included), ``aux`` being the mean over the layers of the
Switch load-balance term (JAX train/step.py:126-168). On a mesh each
term's ``frac`` and ``mean_prob`` are the global batch's: the statistics
are summed over the ``data`` and ``seq`` groups before the product
(``models.moe.mean_load_balance``), and since the gradients are divided by
the ``data`` size, each rank's share of them is scaled by it in the
backward. A pipelined apply hands back its own aux (the mean of the
per-microbatch terms, JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.models import moe
from ddim_cold_torch.ops.losses import smooth_l1
from ddim_cold_torch.ops.sampling import fold_in
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel import sharding

B1, B2, EPS, WEIGHT_DECAY, MAX_NORM = 0.9, 0.999, 1e-8, 0.05, 1.0


@dataclasses.dataclass
class TrainState:
    """What the step carries: the model (its parameters are the live
    params), the optimizer count ``step`` (a host int: the lr is set from it
    with no device sync), AdamW's moments in parameter order, and an optional
    EMA shadow of the params (``ema_decay`` > 0; the reference has no EMA)."""

    model: torch.nn.Module
    lr: float
    total_steps: int
    step: int = 0
    mu: list = dataclasses.field(default_factory=list)
    nu: list = dataclasses.field(default_factory=list)
    ema_params: Optional[list] = None
    #: global norm of the last update's gradients, before the clip (a
    #: device scalar: reading it syncs)
    grad_norm: Optional[torch.Tensor] = None

    @property
    def names(self) -> list:
        return [n for n, _ in self.model.named_parameters()]

    @property
    def params(self) -> list:
        return list(self.model.parameters())

    def learning_rate(self, count: Optional[int] = None) -> float:
        """optax ``cosine_decay_schedule(lr, total_steps, alpha=0)`` at the
        update count (default: the one the next update reads)."""
        count = min(self.step if count is None else count, self.total_steps)
        return self.lr * (0.5 * (1.0 + math.cos(math.pi * count / self.total_steps)))

    def opt_state_dict(self) -> dict:
        """The optimizer state by parameter name (for checkpoints)."""
        names = self.names
        return {"count": self.step, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu))}

    def load_opt_state_dict(self, state: dict) -> None:
        names = self.names
        for which in ("mu", "nu"):
            if set(state[which]) != set(names):
                raise ValueError(f"optimizer state {which} does not match this "
                                 "model's parameters")
        self.step = int(state["count"])
        dev = self.params[0].device
        self.mu = [state["mu"][n].to(dev, torch.float32).clone() for n in names]
        self.nu = [state["nu"][n].to(dev, torch.float32).clone() for n in names]

    def seed_ema(self) -> None:
        """EMA shadow := a copy of the current params."""
        self.ema_params = [p.detach().clone() for p in self.params]


def create_train_state(model: torch.nn.Module, lr: float, total_steps: int,
                       ema_decay: float = 0.0) -> TrainState:
    """Wrap ``model``'s (already initialised) parameters with the optimizer:
    zero moments, count 0, and an EMA shadow when ``ema_decay`` > 0."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    params = list(model.parameters())
    state = TrainState(model=model, lr=float(lr), total_steps=int(total_steps),
                       mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
                       nu=[torch.zeros_like(p, dtype=torch.float32) for p in params])
    if ema_decay:
        state.seed_ema()
    return state


@torch.no_grad()
def apply_gradients(state: TrainState, grads: list,
                    g_norm: Optional[torch.Tensor] = None) -> None:
    """One optax-chain update of ``state.model``'s parameters, in place:
    clip by global norm 1.0, Adam moments and bias correction, decoupled
    weight decay on every parameter, cosine lr, ``p ← p + (−lr)·u``. The
    clip decision stays on the device (no sync). ``g_norm``: the global
    norm of the whole model's gradient when ``grads`` are this rank's
    shards (default: their own norm)."""
    params = state.params
    lr = state.learning_rate()
    # clip_by_global_norm: select(‖g‖ < max, g, g / ‖g‖ · max)
    if g_norm is None:
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    state.grad_norm = g_norm
    denom = torch.where(g_norm < MAX_NORM, torch.ones_like(g_norm), g_norm / MAX_NORM)
    grads = torch._foreach_div(grads, denom)
    # scale_by_adam: mu = (1−b1)·g + b1·mu; nu = (1−b2)·g² + b2·nu
    torch._foreach_mul_(state.mu, B1)
    torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
    count = state.step + 1
    mu_hat = torch._foreach_div(state.mu, 1.0 - B1**count)
    nu_hat = torch._foreach_div(state.nu, 1.0 - B2**count)
    denom_v = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom_v, EPS)
    updates = torch._foreach_div(mu_hat, denom_v)
    # add_decayed_weights, then scale_by_learning_rate and apply_updates
    torch._foreach_add_(updates, params, alpha=WEIGHT_DECAY)
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(params, updates)
    state.step = count


def step_generator(seed: int, step: int, device, data_index: Optional[int] = None
                   ) -> torch.Generator:
    """The generator of optimizer step ``step`` (the update count before it)
    on ``device``: ``seed + 1`` with the step folded in, then the rank's
    ``data`` coordinate when the batch is split over data ranks (JAX's
    ``fold_in(PRNGKey(seed + 1), state.step)``, train/step.py:146-152, with
    its per-shard key)."""
    g = fold_in(torch.Generator(device=device).manual_seed(seed + 1), step)
    return g if data_index is None else fold_in(g, data_index)


#: the parameters every stage computes but only stage 0's embedding feeds
#: the trunk: under ``pipe`` their gradient is summed over the stages
_EMBED = ("cls_token", "pos_embed", "patch_embed.", "time_embed.")


class _Reducer:
    """The gradient reduction and the global norm of one model on ``mesh``
    (see the module), by parameter class: a stage's block (under ``pipe``),
    a tensor-parallel shard or an expert shard is held by its own ranks
    only; the embedding under ``pipe`` has its gradient on stage 0 only;
    every other parameter is whole and equal on the ``model``, ``pipe`` and
    ``expert`` ranks."""

    def __init__(self, model, mesh):
        self.mesh, self.data = mesh, pmesh.data_axis_size(mesh)
        self.groups = [mesh.get_group(a) for a in pmesh.REPLICA_AXES
                       if pmesh.axis_size(mesh, a) > 1]
        # "tp"/"pipe"/"ep" → (group, size) of the model's sharded axes
        self.axes, key_of = {}, {}
        for key, attr in (("tp", "head_axis"), ("pipe", "pipe_axis"), ("ep", "expert_axis")):
            axis = getattr(model, attr, None)
            if pmesh.axis_size(mesh, axis) > 1:
                self.axes[key] = (mesh.get_group(axis), pmesh.axis_size(mesh, axis))
                key_of[axis] = key
        plan = getattr(model, "plan", {})
        names = [n for n, _ in model.named_parameters()]
        # the norm's classes: the sharded axes a parameter is split along
        splits = []
        for n in names:
            on = {key_of[a] for a in (plan[n].dims if n in plan else ()) if a in key_of}
            if "pipe" in self.axes and sharding.block_index(n) is not None:
                on.add("pipe")
            splits.append(frozenset(on))
        self.classes = sorted(set(splits), key=sorted)
        self.cls = [self.classes.index(s) for s in splits]
        self.embed = [i for i, n in enumerate(names)
                      if "pipe" in self.axes and n.startswith(_EMBED)]

    def __call__(self, loss: torch.Tensor, grads: list):
        """(loss, grads, ‖g‖): the mean over data ranks of the sum over seq
        ranks (and, for the embedding under ``pipe``, over the stages)."""
        out = list(grads)
        rest = [i for i in range(len(grads)) if i not in self.embed]
        summed = _sum([grads[i] for i in rest] + [loss.reshape(1)], self.groups)
        for i, g in zip(rest, summed):
            out[i] = g
        loss = summed[-1][0] / math.prod(dist.get_world_size(g) for g in self.groups)
        if self.embed:
            groups = self.groups + [self.axes["pipe"][0]]
            for i, g in zip(self.embed, _sum([grads[i] for i in self.embed], groups)):
                out[i] = g
        out = torch._foreach_div(out, float(self.data))
        return loss, out, self._norm(out)

    def _norm(self, grads: list) -> Optional[torch.Tensor]:
        """‖g‖ of the whole model: a shard's square sum summed over its
        axes, a whole parameter counted once; None where every rank holds
        every parameter."""
        if not self.axes:
            return None
        sq = torch.stack(torch._foreach_norm(grads)).square()
        cls = torch.tensor(self.cls, device=sq.device)
        parts = torch.stack([sq[cls == c].sum() for c in range(len(self.classes))])
        # the classes split along an axis sum over it; the others are equal
        # there and stay as they are
        for key, (group, _) in self.axes.items():
            mask = torch.tensor([float(key in c) for c in self.classes], device=sq.device)
            total = _sum([parts * mask], [group])[0]
            parts = parts * (1.0 - mask) + total
        return torch.sqrt(parts.sum())


def _sum(tensors: list, groups: list) -> list:
    """``tensors`` summed over each group in turn."""
    for group in groups:
        tensors = pmesh.all_reduce_flat(tensors, group=group)
    return list(tensors)


def make_train_step(model, apply_fn: Optional[Callable] = None,
                    prepare: Optional[Callable] = None,
                    ema_decay: float = 0.0, grad_accum: int = 1,
                    moe_aux_weight: float = 0.0,
                    steps_per_dispatch: int = 1, mesh=None) -> Callable:
    """``(state, batch, generator, loss_rec) → (state, loss, loss_rec)``.

    ``batch`` is ``(noisy, target, t)`` tensors on the model's device, or,
    with ``prepare`` (ops/degrade.make_cold_prepare / make_gaussian_prepare),
    the raw ``(base, t)`` it corrupts on the device. ``generator`` drives
    ``prepare``'s noise and the dropout masks.

    The EMA train loss (0.99/0.01, multi_gpu_trainer.py:126) stays a device
    scalar: the step never syncs with the host. ``ema_decay`` > 0 updates the
    state's EMA shadow after the update (``ema ← d·ema + (1−d)·p``).
    ``grad_accum`` > 1 splits the batch into that many interleaved slices
    (slice j = rows j, j+ga, …, as the JAX step), averages their gradients
    and their losses, and makes one update. ``mesh``: this rank's rows (and,
    for a sequence-parallel model, its tokens; for a tensor- or
    pipeline-parallel one, its shards); the gradients and the loss are
    reduced across the ranks as the module says, so every rank of a
    replica group applies the same update. ``apply_fn`` replaces the
    model's forward with the same signature (the pipelined apply,
    ``parallel.pipeline.make_pipelined_apply``). ``moe_aux_weight`` > 0 adds
    the Switch load-balance term for a model with expert banks (see the
    module); an ``apply_fn`` must then thread the ``losses`` list (set
    ``.supports_losses``, as the pipelined apply does).

    ``steps_per_dispatch`` n > 1 changes the contract, as in JAX: every
    leaf of ``batch`` gains a leading axis of n (n stacked per-step
    batches), one call runs n full optimizer steps and returns the mean of
    their losses, and ``generator`` is a callable ``step → Generator``
    called at the update count before each inner step (the trainer's
    :func:`step_generator`, as JAX folds each inner step's key off
    ``state.step``). The call is n single calls made with those generators,
    the same launches in the same order: states and losses equal bit for
    bit. It is a plain loop, not a captured graph.
    """
    moe_on = moe_aux_weight > 0 and getattr(model, "num_experts", 1) > 1
    if (moe_on and apply_fn is not None
            and not getattr(apply_fn, "supports_losses", False)):
        raise ValueError(
            "moe_aux_weight requires an apply path that threads the "
            "'losses' collection — model.apply, or a custom apply_fn that "
            "sets .supports_losses (e.g. make_pipelined_apply)")
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay!r}")

    forward = apply_fn or model
    reduce = _Reducer(model, mesh) if mesh is not None else None

    def loss_and_grads(params, noisy, target, t, generator):
        records = [] if moe_on else None
        extra = {"losses": records} if moe_on else {}
        pred = forward(noisy, t, deterministic=False, generator=generator, **extra)
        loss = smooth_l1(pred, target)
        if moe_on:
            aux = (moe.mean_load_balance(records) if reduce is None else
                   moe.mean_load_balance(records, reduce.groups, reduce.data))
            loss = loss + moe_aux_weight * aux
        # a seq rank that holds no class token leaves it unused, and a
        # pipeline stage but the first its embedding: their share is 0
        return loss, list(torch.autograd.grad(loss, params, allow_unused=True,
                                              materialize_grads=True))

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   loss_rec: torch.Tensor):
        if ema_decay and state.ema_params is None:
            raise ValueError(
                "ema_decay > 0 but the state carries no ema_params — create it "
                "with create_train_state(..., ema_decay=...) or call "
                "state.seed_ema()")
        if prepare is not None:
            batch = prepare(batch, generator)
        noisy, target, t = batch
        params = state.params
        if grad_accum == 1:
            loss, grads = loss_and_grads(params, noisy, target, t, generator)
        else:
            b = noisy.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
            loss, grads = None, None
            for j in range(grad_accum):
                loss_j, g_j = loss_and_grads(params, noisy[j::grad_accum],
                                             target[j::grad_accum],
                                             t[j::grad_accum], generator)
                if grads is None:
                    loss, grads = loss_j, g_j
                else:
                    loss = loss + loss_j
                    torch._foreach_add_(grads, g_j)
            torch._foreach_div_(grads, float(grad_accum))
            loss = loss / grad_accum
        loss = loss.detach()
        if reduce is None:
            apply_gradients(state, grads)
        else:
            loss, grads, g_norm = reduce(loss, grads)
            apply_gradients(state, grads, g_norm=g_norm)
        if ema_decay:
            with torch.no_grad():  # optax.incremental_update(p, ema, 1 − d)
                step_size = 1.0 - ema_decay
                torch._foreach_mul_(state.ema_params, 1.0 - step_size)
                torch._foreach_add_(state.ema_params, params, alpha=step_size)
        return state, loss, loss_rec * 0.99 + loss * 0.01

    if steps_per_dispatch == 1:
        return train_step

    def multi_step(state: TrainState, stacked_batch, generator, loss_rec: torch.Tensor):
        for leaf in stacked_batch:
            if leaf.shape[0] != steps_per_dispatch:
                raise ValueError(
                    f"a batch of steps_per_dispatch={steps_per_dispatch} steps needs "
                    f"every leaf's leading axis of that length, got {tuple(leaf.shape)}")
        losses = []
        for i in range(steps_per_dispatch):
            state, loss, loss_rec = train_step(
                state, tuple(leaf[i] for leaf in stacked_batch), generator(state.step),
                loss_rec)
            losses.append(loss)
        return state, torch.stack(losses).mean(), loss_rec

    return multi_step


def make_eval_step(model, apply_fn: Optional[Callable] = None,
                   prepare: Optional[Callable] = None) -> Callable:
    """``(batch) → loss``: the deterministic forward's smooth-L1 (through
    ``apply_fn`` when given, the pipelined apply), under
    ``torch.inference_mode()`` (no autograd history)."""
    forward = apply_fn or model

    @torch.inference_mode()
    def eval_step(batch):
        if prepare is not None:
            batch = prepare(batch, None)
        noisy, target, t = batch
        return smooth_l1(forward(noisy, t, deterministic=True), target)

    return eval_step
