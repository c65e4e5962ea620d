"""Rank cases of data and sequence parallelism, torch only.

:func:`run_world` spawns one world of ranks over a local TCP rendezvous
(``torch.multiprocessing``, spawn) and runs a list of cases in every rank,
each a function of this module called by name with its keyword arguments;
it returns every rank's result of every case. The CPU tests
(``tests/test_torch_port_parallel.py``: four gloo ranks, one intra-op thread
each) and ``chip_smoke.py`` (two gloo ranks on one card, CUDA tensors) run
the same code on their own devices.

A mesh spec smaller than the world is run by every block of consecutive
ranks at once, each block a one-axis mesh of its own
(``DeviceMesh.from_group``); a spec as large as the world is
``parallel.make_mesh``.

Cases: :func:`attention` (ring or Ulysses over whole arrays, forward and
the gradients summed over the mesh), :func:`model_forward`,
:func:`train_steps`, :func:`sample` (TINY sizes, weights passed in),
tensor and pipeline parallelism (:func:`tp_pp_grads`, :func:`tp_pp_train`,
:func:`shard_round_trip`, :func:`tp_pp_errors`, over
:func:`sharded_model`, the model as the trainer builds it on a mesh; the
Switch-MoE model through ``tp_pp_train`` and :func:`moe_errors`),
:func:`cli_sample` (the ``sample`` command's samples on a data mesh),
:func:`ulysses_heads_error`, the serving engine across ranks
(:func:`serve_engine`, :func:`serve_follower_fault`, :func:`bucket_error`),
the token cache's selection and the probe under sequence parallelism
(:func:`token_selection`, :func:`sp_probe`), the fleet across ranks
(:func:`serve_fleet`, :func:`serve_fleet_lost`), and the card's
:func:`probe`, :func:`card_train`, :func:`card_sample`, :func:`card_serve`,
:func:`card_probe` and :func:`card_fleet`.
"""

from __future__ import annotations

import functools
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ddim_cold_torch.data.loader import group_batches
from ddim_cold_torch.parallel import mesh as pmesh


class RankError(RuntimeError):
    """A rank of :func:`run_world` raised, died or outlived the deadline."""


def run_world(cases: list, world: int, *, device: str = "cpu",
              backend: Optional[str] = None, timeout_s: float = 100.0,
              may_exit: tuple = ()) -> list:
    """Run ``cases`` (``[(name, kwargs), ...]``) in a spawned world of
    ``world`` ranks on ``device`` (each CUDA rank on ``cuda:0``: one card
    serves every rank) and return ``results[case][rank]``. ``backend``
    None is ``initialize_distributed``'s default. Each rank runs one intra-op
    thread (the ranks share the host's cores). A rank that raises or dies,
    or a world still running after ``timeout_s``, raises :class:`RankError`
    with what the ranks left; every process is gone when this returns. The
    ranks of ``may_exit`` may leave early with exit code 0 (their results of
    the cases they did not finish are None)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dist_cases_") as out:
        init = f"tcp://localhost:{pmesh.free_port()}"
        ctx = mp.start_processes(
            _rank_main, args=(world, init, cases, device, backend, out),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    failure = f"world of {world} still running after {timeout_s} s"
                    break
        except Exception as e:  # noqa: BLE001 — a rank raised or died: reported below
            failure = f"{type(e).__name__}: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(out, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    got = pickle.load(f)
                errors += [f"rank {r}: {e}" for e in got.get("errors", [])]
                results.append(got.get("results"))
            else:
                results.append(None)
        if failure or errors or any(r is None for i, r in enumerate(results)
                                    if i not in may_exit):
            raise RankError("; ".join([failure or ""] + errors))
    return [[results[r][i] if results[r] is not None and i < len(results[r]) else None
             for r in range(world)] for i in range(len(cases))]


def _rank_main(rank: int, world: int, init: str, cases: list, device: str,
               backend: Optional[str], out: str) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    got = {"results": None, "errors": []}
    path = os.path.join(out, f"rank{rank}.pkl")
    try:
        pmesh.initialize_distributed(backend, init, world, rank, device=dev)
        got["results"] = []
        for name, kwargs in cases:
            got["results"].append(globals()[name](dev=dev, **kwargs))
            with open(path, "wb") as f:  # a rank that leaves keeps what it ran
                pickle.dump(got, f)
    except BaseException:  # noqa: BLE001 — the parent reports it
        got["errors"].append(traceback.format_exc())
        raise
    finally:
        with open(path, "wb") as f:
            pickle.dump(got, f)
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ meshes

def mesh_for(spec: dict, dev: torch.device):
    """The mesh of ``spec`` for this rank: the world's (``make_mesh``) when
    the spec covers it, else this rank's block of consecutive ranks as a
    one-axis mesh (every block runs the case at once)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    size = math.prod(spec.values())
    if size == world:
        return pmesh.make_mesh(spec, device=dev)
    if len(spec) != 1 or world % size:
        raise ValueError(f"mesh {spec} is neither the world of {world} nor one "
                         "axis that divides it")
    groups = [dist.new_group(list(range(lo, lo + size))) for lo in range(0, world, size)]
    mine = groups[dist.get_rank() // size]
    return DeviceMesh.from_group(mine, dev.type, mesh_dim_names=tuple(spec))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def qkv_inputs(seed: int, B: int, N: int, H: int, D: int) -> tuple:
    """q, k, v and the loss weights w, (B, N, H, D) float32 each."""
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, N, H, D).astype(np.float32) for _ in range(4))


# ------------------------------------------------------------- CPU cases

def attention(dev, spec: dict, fn: str, N: int, seed: int = 0, B: int = 4, H: int = 4,
              D: int = 8, dtype: str = "float32", use_flash=False, grad: bool = True,
              batch_axis: Optional[str] = None) -> dict:
    """``ring_self_attention`` or ``ulysses_self_attention`` over ``spec``'s
    ``seq`` axis: the whole output and, with ``grad``, the gradients of
    ``Σ out·w`` summed over the mesh."""
    from ddim_cold_torch.parallel import ring_self_attention, ulysses_self_attention

    mesh = mesh_for(spec, dev)
    q, k, v, w = (torch.from_numpy(a).to(dev) for a in qkv_inputs(seed, B, N, H, D))
    q, k, v = (x.to(getattr(torch, dtype)).requires_grad_(grad) for x in (q, k, v))
    scale = D**-0.5
    if fn == "ring":
        out = ring_self_attention(q, k, v, mesh, axis="seq", batch_axis=batch_axis,
                                  scale=scale)
    else:
        out = ulysses_self_attention(q, k, v, mesh, axis="seq", batch_axis=batch_axis,
                                     scale=scale, use_flash=use_flash)
    res = {"out": _np(out)}
    if grad:
        (out.float() * w).sum().backward()
        grads = pmesh.all_reduce_mesh([x.grad for x in (q, k, v)], mesh)
        res.update(dq=_np(grads[0]), dk=_np(grads[1]), dv=_np(grads[2]))
    return res


def ulysses_heads_error(dev, spec: dict) -> str:
    """The message of ``ulysses_attention`` on local shards whose heads do
    not divide the seq group."""
    from ddim_cold_torch.parallel.ulysses import SeqParallelConfigError, ulysses_attention

    mesh = mesh_for(spec, dev)
    q = torch.zeros(1, 2, 3, 8, device=dev)
    try:
        ulysses_attention(q, q, q, group=mesh.get_group("seq"), scale=1.0)
    except SeqParallelConfigError as e:
        return str(e)
    return ""


def _model(dev, cfg: dict, state_dict: dict, mesh=None, sp_mode: Optional[str] = None,
           quant: Optional[str] = None, fused: bool = False,
           head_axis: Optional[str] = None):
    """The model of ``cfg`` with the float ``state_dict``, as its ``quant``
    and ``fused`` variant (the weights quantized as the engine quantizes
    them), ``sp_clone``d onto ``mesh`` when ``sp_mode`` is given."""
    from ddim_cold_torch.models import DiffusionViT, sp_clone
    from ddim_cold_torch.ops import quant as quant_ops

    model = DiffusionViT(**cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                          strict=True)
    if quant is not None or fused:
        variant = model.clone(quant=quant, fused=fused)
        state = model.state_dict()
        variant.load_state_dict(quant_ops.quantize_state_dict(state) if quant else state,
                                strict=True)
        model = variant
    if sp_mode is not None:
        model = sp_clone(model, mesh, sp_mode=sp_mode, head_axis=head_axis)
    return model


def model_forward(dev, spec: dict, cfg: dict, state_dict: dict, x, t,
                  sp_mode: str) -> dict:
    """``sp_clone(model, mesh, sp_mode=...)`` on this rank's rows of ``x``,
    gathered: the output and the mode ``sp_clone`` resolved."""
    mesh = mesh_for(spec, dev)
    model = _model(dev, cfg, state_dict, mesh, sp_mode)
    with torch.no_grad():
        out = model(pmesh.shard_rows(torch.from_numpy(x), mesh),
                    pmesh.shard_rows(torch.from_numpy(t), mesh))
    if pmesh.data_axis_size(mesh) > 1:
        out = pmesh.gather_cat(out, mesh.get_group("data"))
    return {"out": _np(out), "sp_mode": model.sp_mode}


def _step_calls(batches: list, n: int, mesh, dev):
    """``(this rank's batch, generator)`` of each step call: a batch a call,
    or every ``n`` stacked into one call of ``n`` steps (``shard_batch(
    grouped=True)``: the rank's rows of every inner step); a fresh
    generator every step."""
    for batch in group_batches(batches, n):
        local = tuple(torch.from_numpy(a).to(dev)
                      for a in pmesh.shard_batch(batch, mesh, grouped=n > 1))
        yield local, ((lambda _: torch.Generator(device=dev)) if n > 1
                      else torch.Generator(device=dev))


def train_steps(dev, spec: dict, cfg: dict, state_dict: dict, batches: list, lr: float,
                total_steps: int, sp_mode: Optional[str] = None,
                grad_accum: int = 1, steps_per_dispatch: int = 1) -> dict:
    """``train.step`` on ``mesh``: each batch's rows of this rank (the whole
    batch on seq ranks), the model sequence-parallel when ``sp_mode`` is
    given. ``steps_per_dispatch`` n > 1 stacks every n batches into one
    call (``shard_batch(grouped=True)``: the rank's rows of each inner
    step). Returns the losses (one a call), the global gradient norms the
    clip saw last in each call and the parameters by name."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    mesh = mesh_for(spec, dev)
    extra = {}
    if sp_mode is not None:
        names = tuple(mesh.mesh_dim_names)
        extra = dict(seq_mesh=mesh, seq_axis="seq", sp_mode=sp_mode,
                     batch_axis="data" if "data" in names else None)
    model = DiffusionViT(**cfg, **extra, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                          strict=True)
    state = create_train_state(model, lr, total_steps)
    pmesh.shard_train_state(state)
    step = make_train_step(model, grad_accum=grad_accum, mesh=mesh,
                           steps_per_dispatch=steps_per_dispatch)
    rec = torch.tensor(5.0, device=dev)
    losses, norms = [], []
    for local, gen in _step_calls(batches, steps_per_dispatch, mesh, dev):
        state, loss, rec = step(state, local, gen, rec)
        losses.append(float(loss))
        norms.append(float(state.grad_norm))
    return {"losses": losses, "grad_norms": norms, "rec": float(rec),
            "params": {n: _np(p) for n, p in model.named_parameters()}}


def sharded_model(dev, spec: dict, cfg: dict, state_dict: Optional[dict] = None,
                  sp_mode: Optional[str] = None, mesh=None):
    """``(model, mesh)``: the model of ``cfg`` built for ``spec``'s mesh as
    the trainer builds it (``parallel.layout.model_axes``; sequence-parallel
    over a ``seq`` axis with ``sp_mode``), loaded with this rank's part of
    the whole ``state_dict`` (default: the seeded init)."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.parallel import sharding
    from ddim_cold_torch.parallel.layout import model_axes

    mesh = mesh_for(spec, dev) if mesh is None else mesh
    names = tuple(mesh.mesh_dim_names)
    extra = dict(seq_mesh=mesh, **model_axes(mesh))
    if sp_mode is not None:
        extra.update(seq_axis="seq", sp_mode=sp_mode,
                     batch_axis="data" if "data" in names else None)
    model = DiffusionViT(**cfg, **extra, device=dev)
    if state_dict is not None:
        whole = {k: torch.from_numpy(v) for k, v in state_dict.items()}
        model.load_state_dict(sharding.shard_state_dict(whole, mesh, model.plan),
                              strict=True)
    return model, mesh


def _whole_np(part: dict, model, mesh) -> dict:
    from ddim_cold_torch.parallel import sharding

    full = sharding.gather_state_dict(part, mesh, model.plan, depth=model.depth)
    return {k: _np(v) for k, v in full.items()}


def tp_pp_grads(dev, spec: dict, cfg: dict, state_dict: dict, x, t,
                sp_mode: Optional[str] = None, n_microbatch: int = 2,
                seed: Optional[int] = None) -> dict:
    """The sharded model's forward on this rank's rows of ``x`` (through the
    pipelined apply under ``pipe``; with ``seed``, the training forward
    drawing from a generator of that seed) and the gradient of
    ``mean(out²)`` over the whole batch, reduced as the train step reduces
    it: the whole batch's output, the whole state_dict of gradients and
    ‖g‖."""
    from ddim_cold_torch.parallel.layout import layout_for_mesh
    from ddim_cold_torch.train.step import _Reducer

    model, mesh = sharded_model(dev, spec, cfg, state_dict, sp_mode)
    _, apply_fn = layout_for_mesh(model, mesh, n_microbatch=n_microbatch)
    fwd = apply_fn or model
    xs, ts = (torch.from_numpy(pmesh.shard_rows(a, mesh)).to(dev) for a in (x, t))
    if seed is None:
        out = fwd(xs, ts)
    else:
        out = fwd(xs, ts, deterministic=False,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    loss = out.float().square().mean()
    names = [n for n, _ in model.named_parameters()]
    grads = list(torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                     materialize_grads=True))
    loss, grads, norm = _Reducer(model, mesh)(loss.detach(), grads)
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if pmesh.data_axis_size(mesh) > 1:
        out = pmesh.gather_cat(out.detach(), mesh.get_group("data"))
    return {"out": _np(out), "grads": _whole_np(dict(zip(names, grads)), model, mesh),
            "norm": float(norm), "loss": float(loss)}


def tp_pp_train(dev, spec: dict, cfg: dict, state_dict: dict, batches: list, lr: float,
                total_steps: int, sp_mode: Optional[str] = None, n_microbatch: int = 2,
                ema_decay: float = 0.0, moe_aux_weight: float = 0.0,
                aux_inputs: Optional[tuple] = None, steps_per_dispatch: int = 1) -> dict:
    """``train.step`` of the sharded model on ``spec``'s mesh (the pipelined
    apply under ``pipe``; ``moe_aux_weight`` for a Switch-MoE ``cfg``): the
    losses, the global norms the clip saw and the whole parameters (and EMA
    shadow) after the steps, gathered. ``aux_inputs`` ``(x, t)``: also the
    Switch load-balance aux of the deterministic forward of this rank's rows
    of them before the steps (the pipelined apply's, or the statistics
    summed over the data and seq ranks). ``steps_per_dispatch`` n > 1: every
    n batches in one call, as :func:`train_steps` runs them."""
    from ddim_cold_torch.models import moe
    from ddim_cold_torch.parallel.layout import layout_for_mesh
    from ddim_cold_torch.train.step import _Reducer, create_train_state, make_train_step

    model, mesh = sharded_model(dev, spec, cfg, state_dict, sp_mode)
    _, apply_fn = layout_for_mesh(model, mesh, n_microbatch=n_microbatch)
    state = pmesh.shard_train_state(
        create_train_state(model, lr, total_steps, ema_decay=ema_decay), mesh)
    step = make_train_step(model, apply_fn, ema_decay=ema_decay,
                           moe_aux_weight=moe_aux_weight, mesh=mesh,
                           steps_per_dispatch=steps_per_dispatch)
    aux = None
    if aux_inputs is not None:
        records = []
        with torch.no_grad():
            (apply_fn or model)(*(torch.from_numpy(pmesh.shard_rows(a, mesh)).to(dev)
                                  for a in aux_inputs), losses=records)
            aux = float(moe.mean_load_balance(records, _Reducer(model, mesh).groups))
    rec = torch.tensor(5.0, device=dev)
    losses, norms = [], []
    for local, gen in _step_calls(batches, steps_per_dispatch, mesh, dev):
        state, loss, rec = step(state, local, gen, rec)
        losses.append(float(loss))
        norms.append(float(state.grad_norm))
    names = state.names
    out = {"losses": losses, "grad_norms": norms, "aux": aux,
           "params": _whole_np(dict(zip(names, state.params)), model, mesh),
           "local_params": len(names), "local_numel": sum(p.numel() for p in state.params),
           "moments_numel": sum(m.numel() for m in state.mu)}
    if ema_decay:
        out["ema"] = _whole_np(dict(zip(names, state.ema_params)), model, mesh)
        out["ema_numel"] = sum(e.numel() for e in state.ema_params)
    return out


def shard_round_trip(dev, spec: dict, state_dict: dict) -> dict:
    """``gather_state_dict(shard_state_dict(sd))`` on ``spec``'s mesh: the
    whole dict back (key order kept) and this rank's keys and shapes."""
    from ddim_cold_torch.parallel import sharding

    mesh = mesh_for(spec, dev)
    whole = {k: torch.from_numpy(v) for k, v in state_dict.items()}
    part = sharding.shard_state_dict(whole, mesh)
    back = sharding.gather_state_dict(part, mesh)
    return {"keys": list(back), "back": {k: v.numpy() for k, v in back.items()},
            "part": {k: tuple(v.shape) for k, v in part.items()}}


def moe_errors(dev, cfg: dict) -> dict:
    """The messages of JAX's Switch-MoE refusals on a four-rank world: a
    pipelined apply over a ``seq`` axis of a model with expert banks, an
    ``expert`` axis that does not divide ``num_experts``."""
    from ddim_cold_torch.parallel.layout import layout_for_mesh

    out = {}
    for key, spec, extra in (("pipe_seq", {"pipe": 2, "seq": 2}, {}),
                             ("expert", {"data": 2, "expert": 2}, {"num_experts": 3})):
        try:
            model, mesh = sharded_model(dev, spec, dict(cfg, **extra),
                                        sp_mode="ring" if "seq" in spec else None)
            layout_for_mesh(model, mesh)
            out[key] = ""
        except ValueError as e:
            out[key] = str(e)
    return out


def tp_pp_errors(dev, cfg: dict) -> dict:
    """The messages of the layouts JAX refuses on a four-rank world: depth
    not divisible by the stages, a batch not divisible by the microbatches,
    Ulysses over more seq ranks than a tp rank's heads, a non-sp model's
    trunk under ``seq_axis``."""
    from ddim_cold_torch.parallel.pipeline import pipeline_blocks

    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = ""
        except (ValueError, NotImplementedError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    world = pmesh.make_mesh({"pipe": 4}, device=dev)
    catch("depth", lambda: sharded_model(dev, {"pipe": 4}, dict(cfg, depth=2), mesh=world))
    two = mesh_for({"pipe": 2, "model": 2}, dev)
    model, _ = sharded_model(dev, {}, cfg, mesh=two)
    x = torch.zeros(3, *cfg["img_size"], 3, device=dev)
    t = torch.zeros(3, dtype=torch.long, device=dev)
    catch("batch", lambda: pipeline_blocks(model, model(x, t, stage="embed"), two,
                                           n_microbatch=2))
    catch("seq_axis", lambda: pipeline_blocks(model, model(x[:2], t[:2], stage="embed"),
                                              two, seq_axis="seq"))
    sm = mesh_for({"seq": 2, "model": 2}, dev)
    catch("ulysses", lambda: sharded_model(dev, {}, dict(cfg, num_heads=2), sp_mode="ulysses",
                                           mesh=sm))
    return out


def sample(dev, spec: dict, cfg: dict, state_dict: dict, x_init, fn: str = "ddim_sample",
           sp_mode: Optional[str] = None, head_axis: Optional[str] = None,
           **kwargs) -> dict:
    """``sampling.<fn>(model, x_init=..., mesh=..., **kwargs)`` (``ddim_sample``,
    ``ddim_sample_fewstep``, ``cold_sample`` or ``sample_from``), the model
    ``sp_clone``d onto the mesh when ``sp_mode`` is given (tensor-parallel
    over ``head_axis`` too, if given): the whole batch, and with
    ``telemetry`` each step's branch and gate drift."""
    from ddim_cold_torch.ops import sampling

    mesh = mesh_for(spec, dev)
    model = _model(dev, cfg, state_dict, mesh, sp_mode, head_axis=head_axis)
    out = getattr(sampling, fn)(model, x_init=x_init, mesh=mesh, device=dev, **kwargs)
    if kwargs.get("telemetry"):
        out, tel = out
        return {"images": _np(out), "branch": tel.branch.tolist(),
                "drift": _np(tel.drift)}
    return {"images": _np(out)}


def quant_sample(dev, spec: dict, cfg: dict, state_dict: dict, x_init, quant: str,
                 fused: bool = False, sp_mode: Optional[str] = None, **kwargs) -> dict:
    """``ddim_sample`` of the ``quant``/``fused`` model on the mesh (its
    ``sp_clone`` with ``sp_mode``), and the one-process call of the same
    model on the whole batch in this rank (with ``sp_mode``, its
    ``sp_clone`` over a mesh of this rank alone: under sequence parallelism
    the fused attention is gated off): a w8a8 model's activation scale must
    be the whole batch's on both."""
    from ddim_cold_torch.ops import sampling

    mesh = mesh_for(spec, dev)
    alone = (pmesh.submesh([dist.get_rank()], {"seq": 1}, device=dev)
             if sp_mode is not None else None)
    one = _model(dev, cfg, state_dict, alone, sp_mode, quant=quant, fused=fused)
    model = _model(dev, cfg, state_dict, mesh, sp_mode, quant=quant, fused=fused)
    return {"mesh": _np(sampling.ddim_sample(model, x_init=x_init, mesh=mesh, device=dev,
                                             **kwargs)),
            "one": _np(sampling.ddim_sample(one, x_init=x_init, device=dev, **kwargs))}


def cli_sample(dev, spec: dict, cfg: dict, state_dict: dict, x_init, acc_k: int) -> dict:
    """The ``sample`` command's samples (``cli.sample.samples``) over the
    mesh's data axis, and the same call without a mesh in this rank."""
    from ddim_cold_torch.cli import sample as command

    model = _model(dev, cfg, state_dict)
    return {"mesh": _np(command.samples(model, x_init, acc_k=acc_k,
                                        mesh=mesh_for(spec, dev))),
            "one": _np(command.samples(model, x_init, acc_k=acc_k))}


# ------------------------------------------------------------ the engine

def _engine(dev, spec: dict, cfg: dict, state_dict: dict, buckets, configs: list,
            **engine_kw):
    """Every rank's engine on ``spec``'s mesh, warmed with ``configs``
    (SamplerConfig kwargs): the engine, its configs and warmup's report."""
    from ddim_cold_torch import serve

    model = _model(dev, cfg, state_dict)
    configs = [serve.SamplerConfig(**c) for c in configs]
    eng = serve.Engine(model, buckets=tuple(buckets), mesh=mesh_for(spec, dev),
                       device=dev, **engine_kw)
    return eng, configs, serve.warmup(eng, configs)


def _outcomes(tickets: list) -> list:
    """Each ticket's rows, or the name of its exception's type."""
    out = []
    for t in tickets:
        exc = t.exception(timeout=60)
        out.append(type(exc).__name__ if exc is not None else t.result(timeout=1))
    return out


def _one_process(dev, cfg: dict, state_dict: dict, buckets, configs: list,
                 requests: list) -> list:
    """The one-process engine's rows of ``requests`` (``(config index,
    x_init[, submit kwargs])``), each config at degree 1: the reference a
    mesh row is held to at the same bucket."""
    import dataclasses

    from ddim_cold_torch import serve

    model = _model(dev, cfg, state_dict)
    flat = [dataclasses.replace(c, sp_mode="none", sp_degree=1) for c in configs]
    eng = serve.Engine(model, buckets=tuple(buckets), device=dev)
    serve.warmup(eng, list(dict.fromkeys(flat)))
    tickets = _submit(eng, flat, requests)
    eng.run()
    return _outcomes(tickets)


def _submit(eng, configs: list, requests: list) -> list:
    """Each request ``(config index, x_init[, submit kwargs])`` submitted."""
    return [eng.submit(x_init=x, config=configs[i], **(kw[0] if kw else {}))
            for i, x, *kw in requests]


def serve_engine(dev, spec: dict, cfg: dict, state_dict: dict, buckets, configs: list,
                 requests: list, faults: tuple = (), probe_buckets: tuple = (),
                 stall_s: float = 0.0, reference: bool = True) -> dict:
    """An engine across the ranks of ``spec``'s mesh: every rank warms
    ``configs``; rank 0 serves ``requests`` (``(config index, x_init[,
    submit kwargs])``)
    under the fault specs ``faults`` (``FaultSpec`` kwargs), drains, and
    with ``reference`` serves them again on a one-process engine; the other
    ranks follow. Rank 0 returns the rows (or exception type names), the
    report, the stats, each config's resolved sp_mode, the spare-cache
    keys, the ``ensure_program`` errors of ``probe_buckets`` (``(config
    index, bucket)``); every rank its programs after warmup, and the others
    their ``follow()`` reports."""
    from ddim_cold_torch.utils import faults as fault_mod

    eng, configs, wu = _engine(dev, spec, cfg, state_dict, buckets, configs,
                               stall_s=stall_s, retry_base_s=0.0)
    res = {"warm_programs": eng.stats["programs"], "sp_meshes": wu["sp_meshes"]}
    if not eng.is_leader:
        res["follow"] = eng.follow()
        res["programs_after_warmup"] = eng.stats["programs"] - res["warm_programs"]
        return res
    res["sp_modes"] = [eng._model_for(c).sp_mode if c.sp_degree > 1 else None
                       for c in configs]
    res["spare"] = sorted(repr(k) for k in eng._spare_caches)
    res["probe_errors"] = []
    for i, bucket in probe_buckets:
        try:
            eng.ensure_program(configs[i], bucket)
            res["probe_errors"].append("")
        except ValueError as e:
            res["probe_errors"].append(str(e))
    specs = [fault_mod.FaultSpec(**f) for f in faults]
    with fault_mod.inject(*specs):
        tickets = _submit(eng, configs, requests)
        report = eng.run()
    res["rows"] = _outcomes(tickets)
    res["report"] = {k: v for k, v in report.items() if k != "latency"}
    res["stats"] = {k: v for k, v in eng.stats.items() if k != "latencies_s"}
    res["quarantined"] = list(eng.quarantined)
    eng.drain()
    res["programs_after_warmup"] = eng.stats["programs"] - res["warm_programs"]
    if reference:
        res["one_process"] = _one_process(dev, cfg, state_dict, buckets, configs,
                                          requests)
    return res


def bucket_error(dev, spec: dict, cfg: dict, state_dict: dict, buckets) -> str:
    """The message of an engine whose buckets do not divide the mesh's data
    axis (raised before any collective, on every rank)."""
    from ddim_cold_torch import serve

    try:
        serve.Engine(_model(dev, cfg, state_dict), buckets=tuple(buckets),
                     mesh=mesh_for(spec, dev), device=dev)
    except ValueError as e:
        return str(e)
    return ""


def serve_follower_fault(dev, spec: dict, cfg: dict, state_dict: dict, buckets,
                         config: dict, requests: list, where: str, after: int,
                         stall_s: float, reference: bool = False) -> dict:
    """A follower that fails once it has run ``after`` programs after
    warmup: ``where="prepare"`` it cannot ready the next program (once),
    ``"forward"`` its model raises inside the next one, ``"exit"`` it leaves
    the process (exit code 0, no result). Every rank warms ``config``; rank
    0 serves ``requests`` (x_init arrays) and returns each ticket's outcome,
    the run's wall time, its failure counters, whether the engine closed
    and, with ``reference``, the one-process engine's rows; a follower
    returns its ``follow()`` report, or the type of what it raised and its
    errors."""
    from ddim_cold_torch.serve.errors import RankLostError

    eng, configs, _ = _engine(dev, spec, cfg, state_dict, buckets, [config],
                              stall_s=stall_s, retry_base_s=0.0)
    if not eng.is_leader:
        prepare, launch, runs, failed = eng._prepare, eng._launch, [0], [False]

        def prepare_once_failing(*args):
            if where == "prepare" and runs[0] == after and not failed[0]:
                failed[0] = True
                raise RuntimeError("injected: this rank cannot ready its program")
            return prepare(*args)

        def broken_forward(*args, **kwargs):
            raise RuntimeError("injected: this rank's forward raised")

        def launch_then_fail(*args):
            if runs[0] == after:
                if where == "exit":
                    os._exit(0)
                if where == "forward":
                    eng._model_for(configs[0]).forward = broken_forward
            runs[0] += 1
            return launch(*args)

        eng._prepare, eng._launch = prepare_once_failing, launch_then_fail
        try:
            out = {"follow": eng.follow()}
        except RankLostError as e:
            out = {"raised": type(e).__name__, "errors": list(eng._follow_errors)}
        dist.barrier()  # the next case's engine groups wait stall_s at most
        return out
    tickets = [eng.submit(x_init=x, config=configs[0]) for x in requests]
    t0 = time.perf_counter()
    report = eng.run()
    wall = time.perf_counter() - t0
    out = {"rows": _outcomes(tickets), "wall_s": wall, "stalled": report["stalled"],
           "stats": {k: eng.stats[k] for k in ("failed_batches", "quarantined",
                                               "dispatches")},
           "health": {k: eng.health()[k] for k in ("closed", "stalled", "stalls")}}
    try:
        eng.submit(x_init=requests[0], config=configs[0])
        out["submit_after"] = ""
    except Exception as e:  # noqa: BLE001 — the refusal is the finding
        out["submit_after"] = type(e).__name__
    eng.drain(timeout=stall_s)
    if reference:
        out["one_process"] = _one_process(dev, cfg, state_dict, buckets, configs,
                                          [(0, x) for x in requests])
    if where != "exit":
        dist.barrier()
    return out


def token_selection(dev, spec: dict, cases: list) -> list:
    """The token cache's live positions under sequence parallelism: for each
    case ``{"stream", "ref", "k"[, "pad_score"]}`` (whole (B, N+1, E)
    arrays) this rank's blocks of the stream and the reference go through
    the model's global selection (``vit._live_tokens_sp``); with
    ``pad_score`` this rank's padding rows of the stream are set far from
    the reference first (the largest score a padding row could have)."""
    from ddim_cold_torch.models import vit

    mesh = mesh_for(spec, dev)
    out = []
    for case in cases:
        stream, ref = (torch.from_numpy(case[k]).to(dev) for k in ("stream", "ref"))
        shard = pmesh.seq_shard(mesh, "seq", stream.shape[1])
        blk, ref_blk = shard.take(stream), shard.take(ref)
        if case.get("pad_score") and shard.n_real < shard.n_local:
            blk[:, shard.n_real:] = 1e6
        out.append(vit._live_tokens_sp(blk, ref_blk, case["k"], shard).cpu().numpy())
    return out


def sp_probe(dev, spec: dict, cfg: dict, state_dict: dict, x, t, sp_mode: str,
             layers: tuple, head_axis: Optional[str] = None) -> dict:
    """The attention probe of the model ``sp_clone``d onto ``spec``'s mesh
    (tensor-parallel over ``head_axis`` too, if given): each of ``layers``'
    weights on this rank, and the message of a training forward with
    attention dropout active that probes the last layer."""
    mesh = mesh_for(spec, dev)
    model = _model(dev, cfg, state_dict, mesh, sp_mode, head_axis=head_axis)
    x, t = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    with torch.no_grad():
        res = {"weights": {i: _np(model(x, t, return_attention_layer=i)) for i in layers}}
        gen = torch.Generator(device=dev).manual_seed(0)
        try:
            model(x, t, deterministic=False, generator=gen, return_attention_layer=-1)
            res["dropout_error"] = ""
        except ValueError as e:
            res["dropout_error"] = str(e)
    return res


def _groups() -> int:
    """The process groups alive in this process."""
    from torch.distributed import distributed_c10d

    return len(distributed_c10d._world.pg_names)


def _fleet_threads() -> list:
    """The names of the fleet's threads alive in this process."""
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(("replica-", "follow-", "router")))


def _fleet(dev, spec: dict, cfg: dict, state_dict: dict, buckets, stall_s: float):
    """Every rank's part of a fleet across ``spec``'s mesh: the model, the
    mesh, the engines' keyword arguments and whether this rank leads."""
    model = _model(dev, cfg, state_dict)
    mesh = mesh_for(spec, dev)
    kw = dict(buckets=tuple(buckets), device=dev, stall_s=stall_s, retry_base_s=0.0)
    return model, mesh, kw, dist.get_rank() == pmesh.mesh_ranks(mesh)[0]


def _poll(pred, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def serve_fleet(dev, spec: dict, cfg: dict, state_dict: dict, buckets, configs: list,
                requests: list, fault: dict, after: list, stall_s: float = 30.0) -> dict:
    """A fleet of two replicas across ``spec``'s mesh
    (``serve.local_factory(mesh=)`` on rank 0, ``serve.follow_replicas`` on
    the others), every replica warmed with ``configs``. Rank 0: ``requests``
    (``(config index, x_init)``) through the router under the fault
    ``fault`` (``FaultSpec`` kwargs): the rows, the faults realized and the
    router's hedges; then r0 retired (``scale_to(1)``), the replacement
    spawned (``scale_to(2)``) and ``after`` submitted at once (the
    least-loaded placement spreads them); each replica's dispatches and the
    router's health after its drain. Every rank: the process groups and
    fleet threads alive before the fleet and after the drain; a follower
    its ``follow_replicas`` report."""
    from ddim_cold_torch import serve
    from ddim_cold_torch.serve.router import Router
    from ddim_cold_torch.utils import faults as fault_mod

    model, mesh, kw, lead = _fleet(dev, spec, cfg, state_dict, buckets, stall_s)
    res = {"groups_before": _groups()}
    if not lead:
        res["follow"] = serve.follow_replicas(model, mesh=mesh, **kw)
        res.update(groups_after=_groups(), threads_after=_fleet_threads())
        return res
    configs = [serve.SamplerConfig(**c) for c in configs]
    router = Router(serve.local_factory(model, mesh=mesh, **kw), replicas=2,
                    configs=configs, drain_timeout_s=stall_s)
    with fault_mod.inject(fault_mod.FaultSpec(**fault)) as plan:
        tickets = [router.submit(x_init=x, config=configs[i]) for i, x in requests]
        res["rows"] = _outcomes(tickets)
        res["realized"] = len(plan.realized)
    res["hedges"] = router.stats["hedges"]
    router.scale_to(1)
    router.scale_to(2)
    res["replaced"] = _poll(lambda: router.stats["replicas_spawned"] == 3
                            and router.health()["active_replicas"] == 2, 4 * stall_s)
    # before the drain, whose closing replicas the supervisor may retire too
    res["retired"] = router.stats["replicas_retired"]
    res["replicas"] = sorted(router.health()["replicas"])
    tickets = [router.submit(x_init=x, config=configs[i]) for i, x in after]
    res["rows_after"] = _outcomes(tickets)
    placed = router.health()["replicas"]
    res["dispatches"] = {rid: h.get("dispatches", 0) for rid, h in placed.items()}
    health = router.drain(timeout=stall_s)
    res["health"] = {"programs_after_warmup": health["programs_after_warmup"],
                     "states": {rid: h["state"] for rid, h in health["replicas"].items()},
                     "stats": {k: health[k] for k in ("hedges", "failovers",
                                                      "replicas_spawned",
                                                      "replicas_retired", "failed")}}
    _poll(lambda: not _fleet_threads(), stall_s)
    res.update(groups_after=_groups(), threads_after=_fleet_threads())
    return res


def serve_fleet_lost(dev, spec: dict, cfg: dict, state_dict: dict, buckets,
                     config: dict, x_init, stall_s: float) -> dict:
    """A fleet of one replica across ``spec``'s mesh whose follower rank
    leaves the process (exit code 0) at its first program after warmup.
    Rank 0: the ticket's exception (type, message, seconds after submit),
    the supervisor's spawn failures, a spawn's own exception and seconds,
    and the fleet threads and groups after the router's drain."""
    from ddim_cold_torch import serve
    from ddim_cold_torch.serve.engine import Engine
    from ddim_cold_torch.serve.router import Router

    model, mesh, kw, lead = _fleet(dev, spec, cfg, state_dict, buckets, stall_s)
    if not lead:
        follow = Engine.follow

        def follow_then_leave(self):
            self._launch = lambda *args: os._exit(0)
            return follow(self)

        Engine.follow = follow_then_leave  # this spawned rank's own class
        serve.follow_replicas(model, mesh=mesh, **kw)
        return {}
    res = {"groups_before": _groups()}
    factory = serve.local_factory(model, mesh=mesh, **kw)
    # no failover: the ticket fails through with the replica's own error
    router = Router(factory, replicas=1, configs=[serve.SamplerConfig(**config)],
                    max_failovers=0, drain_timeout_s=stall_s)
    t0 = time.perf_counter()
    exc = router.submit(x_init=x_init, config=serve.SamplerConfig(**config)).exception(
        timeout=10 * stall_s)
    res["ticket"] = (type(exc).__name__, str(exc), time.perf_counter() - t0)
    res["spawn_failures"] = _poll(lambda: router.stats["spawn_failures"] >= 1, 4 * stall_s)
    t0 = time.perf_counter()
    try:
        factory("r9")
        res["spawn"] = ("", "", 0.0)
    except Exception as e:  # noqa: BLE001 — the refusal is the finding
        res["spawn"] = (type(e).__name__, str(e), time.perf_counter() - t0)
    router.drain(timeout=stall_s)
    _poll(lambda: not _fleet_threads(), stall_s)
    res.update(groups_after=_groups(), threads_after=_fleet_threads())
    return res


# ------------------------------------------------------------ card cases

#: the collectives a backend may carry on CUDA tensors, probed in order
#: (point to point last: gloo may refuse it on CUDA tensors)
PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "all_to_all_single", "batch_isend_irecv")


def probe(dev, ops=PROBE_OPS) -> dict:
    """Which collectives the world's backend carries on ``dev`` tensors at
    this torch, each checked for the right values: ``{op: "ok" | error}``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    got = {"backend": dist.get_backend(), "torch": torch.__version__}
    x = torch.full((4,), float(rank + 1), device=dev)
    for op in ops:
        try:
            if op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = bool((y == world * (world + 1) / 2).all())
            elif op == "broadcast":
                y = x.clone()
                dist.broadcast(y, src=0)
                ok = bool((y == 1).all())
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
            elif op == "all_gather_into_tensor":
                y = torch.empty(world * 4, device=dev)
                dist.all_gather_into_tensor(y, x)
                ok = bool((y.view(world, 4)[:, 0].cpu()
                           == torch.arange(1, world + 1).float()).all())
            elif op == "all_to_all_single":
                y = pmesh.ring_shift(x, dist.group.WORLD)
                ok = bool((y == (rank - 1) % world + 1).all())
            else:
                y = torch.empty_like(x)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, y, (rank - 1) % world)])
                for r in reqs:
                    r.wait()
                ok = bool((y == (rank - 1) % world + 1).all())
            got[op] = "ok" if ok else "wrong values"
        except Exception as e:  # noqa: BLE001 — a refused op is the finding
            got[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return got


def cold_batches(n: int, batch: int, seed: int, size: int = 200) -> list:
    """Synthetic raw cold batches: uint8 (batch, size, size, 3) bases and t
    in [1, 7] from a seeded numpy generator (``chip_smoke.py``'s training
    input, the same in every rank)."""
    rs = np.random.default_rng(seed)
    return [(rs.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
             rs.integers(1, 8, (batch,), dtype=np.int32)) for _ in range(n)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def card_train(dev, layouts: list, model_cfg: dict, warm: int, steps: int, batch: int,
               seed: int, lr: float, total_steps: int, trace_dir: Optional[str] = None,
               microbatches: Optional[dict] = None, checkpoint_dir: Optional[str] = None,
               model_extra: Optional[dict] = None, moe_aux_weight: float = 0.0,
               dispatch: Optional[dict] = None) -> dict:
    """Training steps of the full-width model on each layout ``(name, mesh,
    sp_mode or None)``, built as the trainer builds it (sharded over
    ``model``/``pipe``, the pipelined apply under ``pipe`` with
    ``microbatches[name]`` microbatches, default 2·pipe): ``warm`` + ``steps``
    steps of ``batch``-row cold batches corrupted on the device, every drop
    rate 0. Rank 0 also runs the one-process step on the same batches from
    the same weights after each of them (outside the timed and counted
    windows) and records, step by step, both losses and gradient norms and
    the cumulative updates' relative L2 distance and largest element gap
    (a sharded layout's parameters gathered whole on every rank first);
    every rank reports its whole parameters' float64 sums after the steps.
    Launch counts cover the timed steps of this rank only; ms/step is the
    barrier-to-barrier wall of a step; peak memory is this rank's over the
    layout. With ``trace_dir``, one more step of each sequence-parallel
    layout is traced on rank 0 and attributed (``obs/attrib``): its scopes'
    events and self seconds. With ``checkpoint_dir``, a sharded layout's
    gathered state_dict after the steps is written there by rank 0
    (``utils/checkpoint.save_checkpoint``), read back into a one-process
    model (``strict=True``), and its largest gap to the one-process twin's
    parameters, in units of lr, recorded. ``model_extra[name]``: model
    options of that layout on top of ``model_cfg`` (a Switch-MoE bank: both
    sides then step with ``moe_aux_weight``). ``dispatch[name]`` = n > 1:
    that layout calls the step with ``steps_per_dispatch=n`` on n stacked
    batches a call (each rank its rows of every inner step,
    ``shard_batch(grouped=True)``), ``warm`` + ``steps`` calls; the
    one-process twin takes the same batches one step a call, and a record
    holds the call's mean loss against the mean of the twin's n losses,
    the last inner step's gradient norm against the twin's."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.obs import attrib
    from ddim_cold_torch.ops import degrade
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.parallel import sharding
    from ddim_cold_torch.parallel.layout import layout_for_mesh, model_axes
    from ddim_cold_torch.train.step import (create_train_state, make_train_step,
                                            step_generator)
    from ddim_cold_torch.utils import checkpoint as ckpt
    from ddim_cold_torch.utils import profiling

    rank = dist.get_rank()
    size = int(model_cfg["img_size"][0])
    prepare = degrade.make_cold_prepare(size, max_step=7, chain=True)
    most = max((dispatch or {}).values(), default=1)
    host = cold_batches((warm + steps) * most + 1, batch, seed, size)
    out = {}
    for name, spec, mode in layouts:
        cfg = dict(model_cfg, **(model_extra or {}).get(name, {}))
        n = (dispatch or {}).get(name, 1)
        aux_weight = moe_aux_weight if cfg.get("num_experts", 1) > 1 else 0.0
        mesh = pmesh.make_mesh(spec, device=dev)
        sharded = bool(model_axes(mesh))
        model, _ = sharded_model(dev, spec, cfg, sp_mode=mode, mesh=mesh)
        _, apply_fn = layout_for_mesh(
            model, mesh, n_microbatch=(microbatches or {}).get(
                name, 2 * pmesh.axis_size(mesh, "pipe")))
        state = pmesh.shard_train_state(create_train_state(model, lr, total_steps), mesh)
        step = make_train_step(model, apply_fn, prepare=prepare, mesh=mesh,
                               moe_aux_weight=aux_weight, steps_per_dispatch=n)
        stream = pmesh.axis_index(mesh, "data") if pmesh.data_axis_size(mesh) > 1 else None
        rec = torch.tensor(5.0, device=dev)

        def whole() -> dict:  # every rank calls it at once
            part = {n: p.detach() for n, p in model.named_parameters()}
            if not sharded:
                return part
            return sharding.gather_state_dict(part, mesh, model.plan, depth=model.depth)

        if rank == 0:
            ref = DiffusionViT(**cfg, device=dev)
            ref_state = create_train_state(ref, lr, total_steps)
            ref_step = make_train_step(ref, prepare=prepare, moe_aux_weight=aux_weight)
            ref_rec = torch.tensor(5.0, device=dev)
            p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
        counts = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0)
        times, per_step = [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(warm + steps):
            group = host[i * n:(i + 1) * n]
            call = next(group_batches(group, n))
            local = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in pmesh.shard_batch(call, mesh, grouped=n > 1))
            gen = (functools.partial(step_generator, seed, device=dev, data_index=stream)
                   if n > 1 else step_generator(seed, state.step, dev, stream))
            before = dict(fa.LAUNCHES)
            _sync(dev)
            t0 = time.perf_counter()
            state, loss, rec = step(state, local, gen, rec)
            _sync(dev)
            dt = time.perf_counter() - t0
            got = {k: fa.LAUNCHES[k] - before.get(k, 0) for k in counts}
            if i >= warm:
                times.append(dt)
                counts = {k: counts[k] + got[k] for k in counts}
            cur = whole()
            if rank == 0:
                ref_losses = []
                for base, t in group:
                    full = (torch.from_numpy(base).to(dev), torch.from_numpy(t).to(dev))
                    ref_state, ref_loss, ref_rec = ref_step(
                        ref_state, full, step_generator(seed, ref_state.step, dev), ref_rec)
                    ref_losses.append(ref_loss)
                ref_loss = torch.stack(ref_losses).mean()
                names = list(p0)
                upd = [cur[n].to(dev) - p0[n] for n in names]
                rupd = [dict(ref.named_parameters())[n].detach() - p0[n] for n in names]
                gap = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(upd, rupd)))
                norm = math.sqrt(sum(float((b ** 2).sum()) for b in rupd))
                per_step.append({
                    "loss": float(loss), "loss_one_process": float(ref_loss),
                    "grad_norm": float(state.grad_norm),
                    "grad_norm_one_process": float(ref_state.grad_norm),
                    "upd_rel": gap / norm,
                    "max_param_gap_lr": max(float((a - b).abs().max())
                                            for a, b in zip(upd, rupd)) / lr})
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
        res = {"mesh": spec, "sp_mode": mode, "launches": counts, "ms_per_step":
               [1e3 * s for s in times], "peak_mem_gib": peak, "per_step": per_step,
               "local_params": sum(p.numel() for p in model.parameters()),
               "local_moments": sum(m.numel() for m in state.mu),
               # every rank's whole parameters after the steps, key by key
               "param_sums": [float(v.double().sum()) for v in cur.values()]}
        if checkpoint_dir is not None and sharded:
            full = sharding.gather_state_dict(model.state_dict(), mesh, model.plan,
                                              depth=model.depth)
            if rank == 0:
                path = os.path.join(checkpoint_dir, f"{name}.ckpt")
                ckpt.save_checkpoint(path, full)
                one = DiffusionViT(**cfg, device=dev)
                one.load_state_dict(ckpt.load_checkpoint(path), strict=True)
                res["checkpoint"] = {
                    "keys": len(full), "one_process_keys": len(one.state_dict()),
                    "max_gap_lr": max(float((p.detach() - q.detach()).abs().max())
                                      for p, q in zip(one.parameters(), ref.parameters()))
                    / lr}
            pmesh.barrier()
        if trace_dir is not None and mode is not None:
            base, t = host[-1]
            local = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in pmesh.shard_batch((base, t), mesh))
            gen = step_generator(seed, state.step, dev, stream)
            where = os.path.join(trace_dir, name)
            _sync(dev)
            if rank == 0:
                with profiling.trace(where):
                    state, _, rec = step(state, local, gen, rec)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            else:
                state, _, rec = step(state, local, gen, rec)
            _sync(dev)
            if rank == 0:
                kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
                report = attrib.attribute(where, device_kind=kind)
                res["attrib"] = {s: {"events": node["events"], "self_s": node["self_s"],
                                     "share_of_busy": node["share_of_busy"]}
                                 for s, node in report["scopes"].items()}
                res["attrib_coverage"] = report["coverage"]
        out[name] = res
        del model, state, step
        if rank == 0:
            del ref, ref_state, ref_step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def card_sample(dev, layouts: list, model_cfg: dict, n: int, k: int, seed: int) -> dict:
    """``ddim_sample(mesh=)`` of the full-width model on each layout ``(name,
    mesh, sp_mode or None)`` from one seeded ``x_init`` of ``n`` rows:
    this rank's flash_fwd launches and wall, and (rank 0) the largest
    |Δ| against the one-process ``ddim_sample`` on the same start, run
    once before the layouts, outside their windows."""
    from ddim_cold_torch.models import DiffusionViT, sp_clone
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.ops import sampling

    x = np.random.default_rng(seed).standard_normal(
        (n, *model_cfg["img_size"], 3)).astype(np.float32)
    base = DiffusionViT(**model_cfg, device=dev)
    ref = None
    if dist.get_rank() == 0:
        ref = sampling.ddim_sample(base, x_init=x, k=k, device=dev)
    out = {}
    for name, spec, mode in layouts:
        mesh = pmesh.make_mesh(spec, device=dev)
        model = sp_clone(base, mesh, sp_mode=mode) if mode else base
        before = dict(fa.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        got = sampling.ddim_sample(model, x_init=x, k=k, mesh=mesh, device=dev)
        _sync(dev)
        res = {"mesh": spec, "sp_mode": model.sp_mode if mode else None,
               "wall_s": time.perf_counter() - t0,
               "launches": fa.LAUNCHES["flash_fwd"] - before.get("flash_fwd", 0),
               "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
               "in_unit_range": bool(((got >= 0) & (got <= 1)).all())}
        if ref is not None:
            res["max_abs_err"] = float((got - ref).abs().max())
        out[name] = res
        del model
    return out


def _kernel_counts() -> dict:
    """Every kernel's launch count so far in this rank."""
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.ops import quant

    return {**{k: fa.LAUNCHES[k] for k in ("flash_fwd", "fused_trunk")},
            **{k: quant.LAUNCHES[k] for k in ("dequant_mm", "mlp_fused")}}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _kernel_counts().items()}


def card_serve(dev, model_cfg: dict, bucket: int, configs: list, seed: int,
               rows: tuple = (3, 5)) -> dict:
    """The serving engine across the world's ranks (``{data: world}``) on
    the full-width model: every rank warms ``configs`` (SamplerConfig
    kwargs, sp ones included); rank 0 serves, config by config, one batch
    of two requests of ``rows`` rows each (seeded starts), recording its
    wall, img/s, p50 latency and this rank's kernel launches, then drains
    and runs each config's one-process twin (degree 1, the engine's own
    variant, ``ddim_sample`` on the same 8-row start: the engine's
    dispatch shape) for the largest |Δ| of the served rows. The other
    ranks follow and record each run's launches. Every rank reports its
    programs after warmup."""
    import dataclasses

    from ddim_cold_torch import serve
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.ops import sampling

    model = DiffusionViT(**model_cfg, device=dev)
    configs = [serve.SamplerConfig(**c) for c in configs]
    mesh = pmesh.make_mesh({"data": dist.get_world_size()}, device=dev)
    eng = serve.Engine(model, buckets=(bucket,), mesh=mesh, device=dev)
    _sync_cuda(dev)
    t0 = time.perf_counter()
    wu = serve.warmup(eng, configs)
    res = {"warmup_s": time.perf_counter() - t0, "sp_meshes": wu["sp_meshes"],
           "warm_programs": eng.stats["programs"]}
    shapes = _record_flash_shapes()
    if not eng.is_leader:
        runs, launch = [], eng._launch

        def counted(config, b, *args):
            before = _kernel_counts()
            shapes.clear()
            out = launch(config, b, *args)
            _sync_cuda(dev)
            runs.append({"config": configs.index(config), "launches": _delta(before),
                         "flash_shapes": dict(shapes)})
            return out

        eng._launch = counted
        res["follow"] = eng.follow()
        res["runs"] = runs
        res["programs_after_warmup"] = eng.stats["programs"] - res["warm_programs"]
        return res
    rs = np.random.default_rng(seed)
    H, W = model.img_size
    starts = [[rs.standard_normal((n, H, W, 3)).astype(np.float32) for n in rows]
              for _ in configs]
    served = []
    for config, xs in zip(configs, starts):
        _sync_cuda(dev)
        before = _kernel_counts()
        shapes.clear()
        tickets = [eng.submit(x_init=x, config=config) for x in xs]
        report = eng.run()
        _sync_cuda(dev)
        got = [t.result(timeout=60) for t in tickets]
        served.append({"sp_mode": (eng._model_for(config).sp_mode
                                   if config.sp_degree > 1 else None),
                       "launches": _delta(before), "flash_shapes": dict(shapes),
                       "wall_s": report["wall_s"],
                       "img_per_sec": report["img_per_sec"],
                       "p50_s": report["latency"]["p50_s"], "batches": report["batches"],
                       "failed_tickets": report["failed_tickets"],
                       "shapes": [list(g.shape) for g in got],
                       "finite": all(bool(np.isfinite(g).all()) for g in got),
                       "in_unit_range": all(bool((g >= 0).all() and (g <= 1).all())
                                            for g in got),
                       "rows": got})
    res["stats"] = {k: v for k, v in eng.stats.items() if k != "latencies_s"}
    eng.drain()
    res["programs_after_warmup"] = eng.stats["programs"] - res["warm_programs"]
    for config, xs, rec in zip(configs, starts, served):
        twin = dataclasses.replace(config, sp_mode="none", sp_degree=1)
        kw = dict(k=twin.k, t_start=twin.t_start)
        if twin.cached:
            kw.update(cache_interval=twin.cache_interval, cache_mode=twin.cache_mode,
                      cache_tokens=twin.cache_tokens or None)
        ref = sampling.ddim_sample(eng._model_for(twin), x_init=np.concatenate(xs),
                                   device=dev, **kw).cpu().numpy()
        rec["max_abs_err"] = float(np.abs(np.concatenate(rec.pop("rows")) - ref).max())
    res["served"] = served
    return res


def _sync_cuda(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _record_flash_shapes() -> dict:
    """From now on in this rank, every ``flash_forward`` launch's q shape
    counted in the returned dict (``"(B, N, H, D)" → launches``); a
    comparison's plain version is not a launch and is not counted."""
    from ddim_cold_torch.ops import flash_attention as fa

    shapes: dict = {}
    if getattr(fa.flash_forward, "_records", None) is not None:
        return fa.flash_forward._records
    orig = fa.flash_forward

    def recording(q, k, v, scale, *args, **kwargs):
        if q.is_cuda:
            key = str(tuple(q.shape))
            shapes[key] = shapes.get(key, 0) + 1
        return orig(q, k, v, scale, *args, **kwargs)

    recording._records = shapes
    fa.flash_forward = recording
    return shapes


def card_fleet(dev, model_cfg: dict, bucket: int, configs: list, fault: dict,
               fault_config: int, seed: int, rows: int = 3,
               stall_s: float = 300.0) -> dict:
    """The fleet across the world's ranks (``{data: world}``) on the
    full-width model: rank 0 a ``Router`` over two replicas of
    ``serve.local_factory(mesh=)``, the others ``serve.follow_replicas``,
    every replica warmed with ``configs`` (SamplerConfig kwargs) at one
    bucket. Rank 0 serves one request of ``rows`` rows per config in turn,
    config ``fault_config``'s under ``fault`` (``FaultSpec`` kwargs: it
    hedges), retires r0 (``scale_to(1)``), waits for the replacement
    (``scale_to(2)``), serves one request per config again and drains; then
    holds every row against the one-process call of its config's variant
    on its dispatch shape (the start zero-padded to the bucket). Every rank
    counts its kernel launches from the initial replicas' warmup to the
    drain (a follower without the initial warmups it ran), and reports the
    process groups and fleet threads left."""
    import dataclasses
    import importlib

    from ddim_cold_torch import serve
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.ops import quant as quant_ops
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.serve.router import Router
    from ddim_cold_torch.utils import faults as fault_mod

    model = DiffusionViT(**model_cfg, device=dev)
    mesh = pmesh.make_mesh({"data": dist.get_world_size()}, device=dev)
    kw = dict(buckets=(bucket,), device=dev, stall_s=stall_s)
    configs = [serve.SamplerConfig(**c) for c in configs]
    res = {"groups_before": _groups()}
    _sync_cuda(dev)
    t0 = time.perf_counter()
    if dist.get_rank() != 0:
        # the module (the package exports its function under the same name)
        warmup_mod = importlib.import_module("ddim_cold_torch.serve.warmup")
        warm, orig = {}, warmup_mod.warmup

        def counted(engine, *args, **kwargs):
            before = _kernel_counts()
            out = orig(engine, *args, **kwargs)
            _sync_cuda(dev)
            warm[engine.replica_id] = _delta(before)
            return out

        warmup_mod.warmup = counted
        try:
            before = _kernel_counts()
            res["follow"] = serve.follow_replicas(model, mesh=mesh, **kw)
            total = _delta(before)
        finally:
            warmup_mod.warmup = orig
        res["launches"] = {k: v - warm.get("r0", {}).get(k, 0) - warm.get("r1", {}).get(k, 0)
                           for k, v in total.items()}
        res.update(warm_launches=warm, wall_s=time.perf_counter() - t0,
                   groups_after=_groups(), threads_after=_fleet_threads())
        return res
    router = Router(serve.local_factory(model, mesh=mesh, **kw), replicas=2,
                    configs=configs, drain_timeout_s=stall_s)
    _sync_cuda(dev)
    res["warmup_s"] = time.perf_counter() - t0
    rs = np.random.default_rng(seed)
    H, W = model.img_size
    served = []
    before = _kernel_counts()  # the fleet's main path starts here

    def serve_one(i: int, spec: Optional[dict] = None) -> None:
        x = rs.standard_normal((rows, H, W, 3)).astype(np.float32)
        t1 = time.perf_counter()
        with fault_mod.inject(*([fault_mod.FaultSpec(**spec)] if spec else [])) as plan:
            ticket = router.submit(x_init=x, config=configs[i])
            exc = ticket.exception(timeout=10 * stall_s)
        served.append({"config": i, "x": x, "latency_s": time.perf_counter() - t1,
                       "realized": len(plan.realized),
                       "error": None if exc is None else repr(exc),
                       "rows": None if exc is not None else ticket.result(timeout=1)})

    for i in range(len(configs)):
        serve_one(i, fault if i == fault_config else None)
    res["hedges"] = router.stats["hedges"]
    router.scale_to(1)
    router.scale_to(2)
    res["replaced"] = _poll(lambda: router.stats["replicas_spawned"] == 3
                            and router.health()["active_replicas"] == 2, 2 * stall_s)
    # before the drain, whose closing replicas the supervisor may retire too
    res["retired"] = router.stats["replicas_retired"]
    for i in range(len(configs)):
        serve_one(i)
    health = router.drain(timeout=stall_s)
    _sync_cuda(dev)
    res["launches"] = _delta(before)
    res["serve_s"] = time.perf_counter() - t0 - res["warmup_s"]
    res["wall_s"] = time.perf_counter() - t0
    res["health"] = {"programs_after_warmup": health["programs_after_warmup"],
                     "dispatches": {rid: h.get("dispatches", 0)
                                    for rid, h in health["replicas"].items()},
                     "states": {rid: h["state"] for rid, h in health["replicas"].items()},
                     **{k: health[k] for k in ("hedges", "failovers", "replicas_spawned",
                                               "replicas_retired", "failed")}}
    _poll(lambda: not _fleet_threads(), 30.0)
    res.update(groups_after=_groups(), threads_after=_fleet_threads())
    twins = {}
    for rec in served:
        config = configs[rec["config"]]
        twin = dataclasses.replace(config, sp_mode="none", sp_degree=1)
        if twin not in twins:
            variant = model
            if twin.quant is not None or twin.fused:
                variant = model.clone(quant=twin.quant, fused=twin.fused)
                state = model.state_dict()
                variant.load_state_dict(quant_ops.quantize_state_dict(state)
                                        if twin.quant else state)
            twins[twin] = variant
        padded = np.concatenate([rec["x"], np.zeros((bucket - rows, H, W, 3), np.float32)])
        rows_out = rec.pop("rows")
        rec.pop("x")
        if rows_out is None:
            continue
        ref = sampling.ddim_sample(twins[twin], x_init=padded, k=twin.k,
                                   t_start=twin.t_start, device=dev)[:rows].cpu().numpy()
        rec.update(max_abs_err=float(np.abs(rows_out - ref).max()),
                   shape=list(rows_out.shape),
                   finite=bool(np.isfinite(rows_out).all()),
                   in_unit_range=bool(((rows_out >= 0) & (rows_out <= 1)).all()))
    res["served"] = served
    return res


def card_probe(dev, model_cfg: dict, n: int, layers: tuple, control: int, seed: int,
               sp_mode: str = "ulysses") -> dict:
    """The attention probe of the full-width model ``sp_clone``d onto
    ``{seq: world}`` against the one-process probe of the same model in
    this rank, on ``n`` seeded images: per layer the weights' shape, the
    largest |Δ|, the rows' largest distance from summing to 1, this rank's
    kernel launches of the sequence-parallel call and its wall; and the
    control, the last layer's weights against the one-process probe of
    layer ``control``."""
    from ddim_cold_torch.models import DiffusionViT, sp_clone

    model = DiffusionViT(**model_cfg, device=dev)
    sp = sp_clone(model, pmesh.make_mesh({"seq": dist.get_world_size()}, device=dev),
                  sp_mode=sp_mode)
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, W = model.img_size
    x = torch.randn((n, H, W, 3), generator=gen, device=dev)
    t = torch.randint(0, model.total_steps, (n,), generator=gen, device=dev)
    out = {"sp_mode": sp.sp_mode, "layers": {}}
    with torch.no_grad():
        for layer in layers:
            _sync_cuda(dev)
            before, t0 = _kernel_counts(), time.perf_counter()
            got = sp(x, t, return_attention_layer=layer)
            _sync_cuda(dev)
            rec = {"launches": _delta(before), "wall_s": time.perf_counter() - t0,
                   "shape": list(got.shape)}
            want = model(x, t, return_attention_layer=layer)
            rec["max_abs_err"] = (got - want).abs().max().item()
            rec["row_sum_err"] = (got.float().sum(-1) - 1).abs().max().item()
            if layer == layers[-1]:
                other = model(x, t, return_attention_layer=control)
                rec["control_err"] = (got - other).abs().max().item()
                del other
            out["layers"][layer] = rec
            del got, want
    return out
