"""The training loop (counterpart of ``ddim_cold_tpu/train/trainer.py``,
which replaced ``multi_gpu_trainer.main``).

    run(config)
    ├─ one process per device: spawned workers over a local TCP rendezvous
    │  (or torchrun's), each a rank of a data/seq/model/pipe mesh (parallel/)
    ├─ datasets (native decode tier) + ShardedLoader + device_prefetch   (data/)
    ├─ build_model + create_train_state            (models/, train/step.py)
    ├─ optional warm-start / resume                (utils/checkpoint.py)
    └─ epoch loop: train_step → evaluate → log → checkpoint

Behavioural parity with the reference: the EMA(0.99) train loss starting at
5.0, the every-100-step ``steps:`` line, the per-epoch ``epoch:`` line,
best/last dual checkpoints, epoch-granular resume restoring the step count
(the cosine position), the best metric and the EMA loss
(multi_gpu_trainer.py:53-55,94-106,126,135-163). The step never syncs with
the host except at log points and epoch ends. The datasets decode through
the native C++ tier, PIL only for the files it rejects, as JAX's trainer
builds them. Checkpoints are crash-safe: each file is renamed into place
whole, and ``lastepoch.ckpt``/``bestloss.ckpt`` pass through the
``ckpt.save`` fault site's four crash windows (``utils/checkpoint.py``).
``remat`` reaches the model (activation checkpointing per block). Each
step draws from its own generator, made from (seed, step) and the rank's
``data`` coordinate (``train/step.step_generator``), so a resumed run draws
what the uninterrupted run draws.

Several devices (``num_gpus: N``, or ``mesh: {data: d, seq: s}`` with
``sp_mode: ring|ulysses``), as the reference's DDP trainer ran them: one
process per device, spawned here (``torch.multiprocessing``, spawn) over a
local TCP rendezvous, or started by torchrun (whose environment names the
rank; nothing is spawned). Each rank takes ``cuda:<local rank>`` over NCCL,
or with ``device="cpu"`` the CPU over gloo. JAX's rules hold: ``num_gpus``
above the visible count is clamped with JAX's log line (the lr follows the
batch trained), a ``mesh`` larger than the visible devices is JAX's error,
the global batch is ``effective_batch × data`` and a rank's loader shard is
its ``data`` coordinate, a ``seq`` axis builds the model sequence-parallel
with attention dropout 0. Only rank 0 writes ``train.log``, the scalars and
the checkpoints (synchronously, as JAX's multi-host saves; the others meet
it at a barrier); a resume loads one file on every rank; a stop signal is
agreed across ranks at the loop points every rank reaches; the validation
loss is reduced over the ranks weighted by rows.

``profile_steps=N`` traces the run's first N steps into
``<run_dir>/trace/trace.json`` (``utils/profiling.start_trace``; read it with
``obs/attrib.load_trace``; rank 0 only). ``nan_checks`` raises where the
first non-finite value appears, forward or backward
(``utils/profiling.enable_nan_checks``), for the whole run; both are
process-wide and put back when ``run`` returns or raises.

Tensor and pipeline parallelism (``mesh: {model: m, pipe: p, data: d, seq:
s}``, ``microbatches``): the model is built sharded
(``parallel.layout.model_axes``: each rank holds its heads and hidden
units along ``model``, its stage's blocks along ``pipe``), the step runs
the pipelined apply under ``pipe`` and reduces the gradients by parameter
class (``train/step.py``), and AdamW's moments and the EMA shadow are
co-sharded with the parameters. JAX's checks hold: the global batch divides
into the microbatches (default 2·pipe) and each microbatch over ``data``,
``grad_accum`` does not compose with ``pipe``. Every checkpoint (``bestloss``,
``lastepoch``, the epoch snapshots, the ``.pkl`` files) holds the gathered
one-process state_dict (``parallel.sharding.gather_state_dict``: every rank
gathers, rank 0 writes), and a warm start or a resume cuts it to the run's
own layout, whatever layout wrote it.

Switch-MoE (``num_experts`` > 1): the step adds ``moe_aux_weight`` times
the load-balance aux; an ``expert`` axis keeps each rank's experts of every
bank (``parallel.layout.model_axes``) and needs ``num_experts`` divisible by
it (JAX's check, trainer.py:263-268). As in JAX, an MoE run writes no
``.pkl`` (the reference layout has no experts): a warm start that finds no
``initializing`` file persists the init in the checkpoint format instead,
with JAX's log line, and reads it back on the next run.

``flash_blocks`` reaches the model (the w8a8 requant block and the
blockwise route's key block; the CUDA kernels' tiles are fixed, so a flash
run with them trains what one without them trains). ``steps_per_dispatch:
n`` stacks n loader batches into one call of n optimizer steps
(``data/loader.group_batches``, ``train/step.make_train_step``) with JAX's
rules (trainer.py:347-356, :453-467, :498-530): an epoch's tail shorter
than n is dropped and the cosine schedule is sized to the steps that run,
(batches // n)·n an epoch; an n larger than an epoch, or a ``max_steps``
not reachable in whole dispatches from the (possibly resumed) start step,
raises; the log line, the stop vote and the profiling window fire when a
dispatch crosses their step boundary. Each inner step draws from its own
step's generator, so a dispatch is n single steps bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ddim_cold_torch.config import ExperimentConfig
from ddim_cold_torch.data import ColdDownSampleDataset, DiffusionDataset, ShardedLoader
from ddim_cold_torch.data.loader import device_prefetch, group_batches
from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.ops import degrade
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel import sharding
from ddim_cold_torch.parallel.layout import layout_for_mesh, model_axes
from ddim_cold_torch.train.step import (create_train_state, make_eval_step,
                                        make_train_step, step_generator)
from ddim_cold_torch.utils import checkpoint as ckpt
from ddim_cold_torch.utils import profiling
from ddim_cold_torch.utils.logging import ScalarWriter, asctime, print_log
from ddim_cold_torch.utils.platform import resolve_device


@dataclass
class TrainResult:
    best_loss: float
    last_val_loss: float
    steps: int
    run_dir: str


class _GracefulStop:
    """SIGTERM/SIGINT → set a flag; the epoch loop finishes the current step,
    evaluates, checkpoints and returns normally, leaving a resumable
    lastepoch.ckpt. A second signal restores the previous dispositions and
    re-delivers itself. Handlers can only be installed from the main thread;
    elsewhere this is a no-op (``requested`` stays False)."""

    def __init__(self):
        self.requested = False
        self._prev: dict = {}

    def agreed(self, device) -> bool:
        """The stop flag agreed across ranks: True when ANY rank was
        signalled. Every rank calls this at the same loop point (JAX
        ``_GracefulStop.agreed``): gating the loop on the local flag would
        leave one rank's loop alone and hang the others' collectives."""
        if not dist.is_initialized():
            return self.requested
        flag = torch.tensor([float(self.requested)], device=device)
        return bool(pmesh.all_reduce_max(flag).item())

    def __enter__(self):
        import signal

        def handler(signum, frame):
            if self.requested:  # second signal: restore + re-deliver → die now
                for s, h in self._prev.items():
                    signal.signal(s, h)
                os.kill(os.getpid(), signum)
                return
            self.requested = True

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                self._prev[s] = signal.signal(s, handler)
        except ValueError:  # not the main thread
            self._prev = {}
        return self

    def __exit__(self, *exc):
        import signal

        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class _AsyncSaver:
    """Runs each epoch's checkpoint writes in a background thread, so the
    device→host copy and serialization overlap the next epoch's compute. At
    most one epoch's saves are in flight (``wait`` before the next
    ``submit``); a save error re-raises at the next wait."""

    def __init__(self, sync: bool):
        self.sync = sync
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn) -> None:
        if self.sync:
            fn()
            return

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread at wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


def _check_expert_axis(config: ExperimentConfig, shape: Optional[dict]) -> None:
    """JAX's check of an ``expert`` mesh axis (trainer.py:263-268)."""
    exp_size = int((shape or {}).get("expert", 1))
    if exp_size > 1 and (config.num_experts <= 1 or config.num_experts % exp_size):
        raise ValueError(
            f"mesh 'expert' axis of {exp_size} needs num_experts (got "
            f"{config.num_experts}) set and divisible by it")


def _build_dataset(config: ExperimentConfig, root: str):
    cache = config.cache_images
    if config.dataset == "cold":
        return ColdDownSampleDataset(root, imgSize=config.image_size,
                                     target_mode="chain", cache_images=cache)
    if config.dataset == "cold_direct":
        return ColdDownSampleDataset(root, imgSize=config.image_size,
                                     target_mode="direct", cache_images=cache)
    if config.dataset == "gaussian":
        return DiffusionDataset(root, imgSize=config.image_size,
                                max_step=config.total_steps, cache_images=cache)
    raise ValueError(f"unknown dataset kind {config.dataset!r}")


def build_model(config: ExperimentConfig, device=None, mesh=None) -> DiffusionViT:
    """The model from the config, bf16 compute under AMP, weights from
    ``config.seed``. The JAX drop-rate defaults apply (0.1 each; the config
    has no key for them), so a training forward with ``use_flash`` takes the
    dense path, as in the JAX trainer on one device. With a ``seq`` axis on
    ``mesh`` the model is sequence-parallel over it (``config.sp_mode``) and
    attention dropout is 0, as JAX's ``build_model`` makes it; a ``model``
    axis makes it tensor-parallel (heads sharded inside the sequence-parallel
    attention too), a ``pipe`` axis builds the stacked layout with this
    rank's stage of blocks (``parallel.layout.model_axes``)."""
    kwargs = dict(config.model_kwargs())
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if "seq" in names:
        kwargs.update(seq_mesh=mesh, seq_axis="seq",
                      batch_axis="data" if "data" in names else None,
                      attn_drop_rate=0.0, sp_mode=config.sp_mode)
    axes = model_axes(mesh) if mesh is not None else {}
    if axes:
        kwargs.update(seq_mesh=mesh, **axes)
    return DiffusionViT(dtype=torch.bfloat16 if config.amp else torch.float32,
                        device=device, seed=config.seed, **kwargs)


def _visible_devices(dev: torch.device) -> int:
    """The devices a run can span: under torchrun the world it launched, on
    every host (JAX's ``jax.devices()``); else this host's cards (CPU
    cores for ``--device cpu``), one spawned process each."""
    if "RANK" in os.environ:
        return int(os.environ.get("WORLD_SIZE", 1))
    return torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)


def _mesh_shape(config: ExperimentConfig, dev: torch.device, log: Optional[str]):
    """``(shape, config)``: the mesh to run, None for one device, with the
    config's device count clamped to the visible devices (JAX trainer.py:
    241-262; ``log`` None writes no line)."""
    avail = _visible_devices(dev)
    if config.mesh:
        shape = {k: int(v) for k, v in dict(config.mesh).items()}
        need = math.prod(shape.values())
        if need > avail:
            raise ValueError(f"config.mesh {shape} needs {need} devices, "
                             f"only {avail} visible")
        return shape, config
    ndev = config.num_devices
    if ndev > avail:
        if log is not None:
            print_log(f"requested {ndev} devices, only {avail} visible — clamping", log)
        ndev = avail
        # keep the lr↔global-batch linear-scaling rule consistent with the
        # batch actually trained (config.lr derives from num_devices)
        config = dataclasses.replace(config, num_devices=ndev)
    return ({"data": ndev} if ndev > 1 else None), config


def _batching(config: ExperimentConfig, shape: Optional[dict]) -> tuple[int, int]:
    """``(global batch, microbatches)`` of the run on the mesh ``shape``,
    with JAX's checks (trainer.py:279-293): under ``pipe`` the global batch
    divides into ``microbatches`` (default 2·pipe) and each microbatch over
    ``data``; ``grad_accum`` does not compose with ``pipe`` and its slices
    divide over ``data``."""
    shape = shape or {}
    data, pipe = int(shape.get("data", 1)), int(shape.get("pipe", 1))
    global_batch = config.effective_batch * data
    n_micro = (config.microbatches or 2 * pipe) if pipe > 1 else 1
    if pipe > 1 and (global_batch % n_micro or (global_batch // n_micro) % data):
        raise ValueError(
            f"pipeline needs global batch {global_batch} divisible by "
            f"microbatches {n_micro} and each microbatch by data={data}")
    if config.grad_accum > 1:
        if pipe > 1:
            raise ValueError(
                "grad_accum composes with dp/tp/sp only — the pipe axis has "
                "its own microbatching (config.microbatches)")
        if global_batch % config.grad_accum or (global_batch // config.grad_accum) % data:
            raise ValueError(
                f"grad_accum needs global batch {global_batch} divisible by "
                f"{config.grad_accum} and each slice by data={data}")
    return global_batch, n_micro


def _snapshot(model, state, whole) -> tuple:
    """``(params, opt_state, ema or None)`` to save: the one-process
    state_dicts (``whole`` of this rank's parts), copied on the device,
    since the next step updates the parameters in place."""
    def copy(d: dict) -> dict:
        return {k: v.detach().clone() for k, v in whole(d).items()}

    opt_state = state.opt_state_dict()
    opt = {"count": opt_state["count"], "mu": copy(opt_state["mu"]),
           "nu": copy(opt_state["nu"])}
    ema = (copy(dict(zip(state.names, state.ema_params)))
           if state.ema_params is not None else None)
    return copy(model.state_dict()), opt, ema


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    rank_dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(rank_dev)
    return rank_dev


def _worker(rank: int, world: int, init_method: str, config, base_dir, shape,
            max_steps, log_every, device: str, results) -> None:
    """One spawned rank: join the group, train, hand rank 0's result back."""
    dev = _rank_device(torch.device(device), rank)
    pmesh.initialize_distributed(init_method=init_method, world_size=world, rank=rank,
                                 device=dev)
    try:
        result = _train(config, base_dir, shape, max_steps, log_every, dev)
        if rank == 0:
            results.put(result)
    finally:
        dist.destroy_process_group()


def run(config: ExperimentConfig, base_dir: str, *, max_steps: Optional[int] = None,
        log_every: int = 100, device=None) -> TrainResult:
    """Train per the config (``device`` None means ``"cuda"``); returns the
    best/final metrics (rank 0's). ``max_steps`` bounds the optimizer steps
    (a test/bench hook, not in the reference). Several devices run one
    process each (see the module); under torchrun this process is one of
    them."""
    dev = resolve_device(device)
    run_dir = os.path.join(base_dir, "Saved_Models", config.run_name)
    os.makedirs(run_dir, exist_ok=True)
    launched = "RANK" in os.environ
    log = os.path.join(run_dir, "train.log") if int(os.environ.get("RANK", 0)) == 0 else None
    shape, config = _mesh_shape(config, dev, log)
    _check_expert_axis(config, shape)
    _batching(config, shape)  # before any rank starts
    if launched:  # torchrun started every rank: this process is one
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world != (math.prod(shape.values()) if shape else 1):
            raise ValueError(f"launched as {world} ranks; the config asks for "
                             f"{shape or {'data': 1}}")
        dev = _rank_device(dev, int(os.environ.get("LOCAL_RANK", 0)))
        if shape is None:
            return _train(config, base_dir, None, max_steps, log_every, dev)
        created = pmesh.initialize_distributed(device=dev)
        try:
            return _train(config, base_dir, shape, max_steps, log_every, dev)
        finally:
            if created:
                dist.destroy_process_group()
    if shape is None:
        return _train(config, base_dir, None, max_steps, log_every, dev)
    world = math.prod(shape.values())
    init_method = f"tcp://localhost:{pmesh.free_port()}"
    if world == 1:  # a mesh of one device: a group of one, in this process
        pmesh.initialize_distributed(init_method=init_method, world_size=1, rank=0,
                                     device=dev)
        try:
            return _train(config, base_dir, shape, max_steps, log_every, dev)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_worker, args=(world, init_method, config, base_dir, shape,
                                      max_steps, log_every, dev.type, results),
                       nprocs=world, join=True, start_method="spawn")
    return results.get()


def _train(config: ExperimentConfig, base_dir: str, shape: Optional[dict],
           max_steps: Optional[int], log_every: int, dev: torch.device) -> TrainResult:
    """One rank's run (the whole run on one device): ``shape`` None, or the
    mesh of a process group already joined."""
    mesh = pmesh.make_mesh(shape, device=dev) if shape is not None else None
    rank0 = pmesh.is_rank0()
    model = build_model(config, device=dev, mesh=mesh)
    saved_dir = os.path.join(base_dir, "Saved_Models")
    run_dir = os.path.join(saved_dir, config.run_name)
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "train.log")

    def log(line: str) -> None:
        if rank0:
            print_log(line, log_path)

    data = pmesh.data_axis_size(mesh)
    data_index = pmesh.axis_index(mesh, "data")
    global_batch, n_micro = _batching(config, shape)
    # sharded over model/pipe: each rank holds its part; files hold the whole
    sharded = mesh is not None and bool(model_axes(mesh))

    def whole(part: dict) -> dict:
        """The one-process state_dict of a dict of this rank's parts (every
        rank calls it at once)."""
        if not sharded:
            return part
        return sharding.gather_state_dict(part, mesh, model.plan, depth=model.depth)

    def mine(full: dict) -> dict:
        return sharding.shard_state_dict(full, mesh, model.plan) if sharded else full
    train_set = _build_dataset(config, config.data_storage[0])
    test_set = _build_dataset(config, config.data_storage[1])
    # device-side corruption: the datasets ship clean bases and the step
    # rebuilds the corrupted batch on the device (cold: bit-identical
    # gathers, both loaders; gaussian: device-drawn ε, train loader only)
    is_cold = config.dataset in ("cold", "cold_direct")
    raw_train = config.device_degrade
    raw_eval = config.device_degrade and is_cold
    prepare = eval_prepare = None
    if raw_train:
        if is_cold:
            prepare = eval_prepare = degrade.make_cold_prepare(
                size=int(config.image_size[0]), max_step=train_set.max_step,
                chain=(config.dataset == "cold"))
        else:
            prepare = degrade.make_gaussian_prepare(config.total_steps)
    # a rank's shard is its data coordinate: the seq ranks of a data row
    # read the same rows (JAX trainer.py:277-278, :297)
    shard = dict(shard_index=data_index, shard_count=data)
    train_loader = ShardedLoader(train_set, global_batch // data, shuffle=True,
                                 seed=config.seed, drop_last=True, raw=raw_train, **shard)
    test_loader = ShardedLoader(test_set, global_batch // data, shuffle=False,
                                drop_last=False, pad_final_batch=True, raw=raw_eval,
                                **shard)
    train_batches, test_batches = len(train_loader), len(test_loader)
    if train_batches == 0:
        raise ValueError("dataset smaller than one global batch (drop_last)")

    # the cosine runs the steps that will run: a grouped epoch drops its
    # tail shorter than steps_per_dispatch (JAX trainer.py:347-356)
    spd = config.steps_per_dispatch
    steps_per_epoch = (train_batches // spd) * spd
    if steps_per_epoch == 0:
        raise ValueError(
            f"steps_per_dispatch {spd} exceeds the "
            f"{train_batches} batches in an epoch — every epoch would drop")
    state = create_train_state(model, config.lr, steps_per_epoch * config.epoch[1])

    # warm start (the reference's `initializing` key): load if present, else
    # persist this init for future runs
    epoch_start = config.epoch[0]
    steps, loss_rec, best_loss = 0, 5.0, 5.0
    template = whole(model.state_dict()) if (
        config.initializing not in ("", "none") or config.resume != "none") else None
    if config.initializing not in ("", "none"):
        init_path = os.path.join(saved_dir, config.initializing)
        if os.path.isfile(init_path):
            loaded = ckpt.load_torch_pkl(init_path)
            ckpt.check_loaded_params(loaded, template, init_path)
            model.load_state_dict(mine(loaded), strict=True)
        elif rank0:
            try:
                ckpt.save_torch_pkl(template, init_path)
            except ValueError as e:  # MoE params: no reference layout (JAX's fallback)
                log(f"init pkl export unavailable ({e}); persisting the checkpoint "
                    "format instead")
                ckpt.save_checkpoint(init_path, template)
        pmesh.barrier()  # no rank reads a file rank 0 is still writing

    restored = None
    if config.resume != "none":
        restored = ckpt.load_checkpoint(config.resume)
        ckpt.check_loaded_params(restored["params"], template, config.resume)
        model.load_state_dict(mine(restored["params"]), strict=True)
        opt = restored["opt_state"]
        state.load_opt_state_dict({"count": opt["count"], "mu": mine(opt["mu"]),
                                   "nu": mine(opt["nu"])})
        epoch_start = int(restored["epoch"]) + 1
        steps = int(restored["steps"])
        loss_rec = float(restored["loss_rec"])
        best_loss = float(restored["metric"])
        state.step = steps
        if config.ema_decay and "ema_params" in restored:
            ema = mine(restored["ema_params"])
            state.ema_params = [ema[n].to(dev) for n in state.names]
        elif config.ema_decay:
            log("resume checkpoint has no ema_params — re-seeding the "
                "EMA shadow from the restored params")
        elif "ema_params" in restored:
            log("resume checkpoint carries ema_params but ema_decay is "
                "off — dropping the shadow")
        log(f"resuming from epoch {epoch_start:8d} of " + config.resume)
        log(f"recovering best_loss {best_loss:4f}")
    else:
        log(f"Date: {asctime()}")
        log("TrainSet batchs:" + str(train_batches))
        log("TestSet batchs:" + str(test_batches))
    if mesh is not None:
        log(f"process group: {dist.get_backend()}, {dist.get_world_size()} ranks, "
            f"mesh {shape}, sp_mode {config.sp_mode}")
    if config.ema_decay and state.ema_params is None:
        # seed the shadow from whatever params the run starts with (fresh
        # init, warm start, or an ema-less resume)
        state.seed_ema()
    if mesh is not None:
        # every replica from its first rank's tensors (rank 0's unsharded)
        pmesh.shard_train_state(state, mesh)
    # the layout of the mesh: the pipelined apply under pipe (JAX trainer.py:
    # 447-451); the params, moments and EMA are co-sharded by construction
    _, apply_fn = layout_for_mesh(model, mesh, n_microbatch=n_micro) if (
        mesh is not None) else (None, None)

    if max_steps is not None and spd > 1 and max_steps > steps and (max_steps - steps) % spd:
        # a bound between dispatches would run up to spd - 1 steps past it
        raise ValueError(
            f"max_steps={max_steps} is not reachable in whole dispatches of "
            f"steps_per_dispatch={spd} from start step {steps}; the dispatch "
            "granularity makes the bound inexact — use a compatible bound, "
            "or steps_per_dispatch=1")
    train_step = make_train_step(model, apply_fn, prepare=prepare,
                                 ema_decay=config.ema_decay,
                                 grad_accum=config.grad_accum,
                                 moe_aux_weight=(config.moe_aux_weight
                                                 if config.num_experts > 1 else 0.0),
                                 steps_per_dispatch=spd,
                                 mesh=mesh)
    eval_step = make_eval_step(model, apply_fn, prepare=eval_prepare)
    writer = ScalarWriter(run_dir) if rank0 else None
    # the data coordinate separates the data ranks' streams; seq ranks of a
    # row share theirs (and one device folds in nothing)
    stream = data_index if data > 1 else None

    def generator_of(step: int) -> torch.Generator:
        return step_generator(config.seed, step, dev, stream)

    vloss = float("nan")
    loss_rec_dev = torch.tensor(loss_rec, dtype=torch.float32, device=dev)
    time_start = time.time()
    done = False
    saver = _AsyncSaver(sync=mesh is not None or not config.async_checkpoint)
    stopper = _GracefulStop()
    stopper.__enter__()  # released after the finally block below: a signal
    # during the last in-flight checkpoint write stays graceful too
    # step-bounded trace of the run's first profile_steps steps
    profiling_until = steps + config.profile_steps if config.profile_steps else 0
    try:
        if config.nan_checks:
            profiling.enable_nan_checks(True, model)
        if profiling_until and rank0:
            profiling.start_trace(os.path.join(run_dir, "trace"))
        for epoch in range(epoch_start, config.epoch[1]):
            train_loader.set_epoch(epoch)
            # n loader batches a dispatch; the log, the stop vote and the
            # profiling window fire when a dispatch crosses their boundary
            for batch in device_prefetch(
                    group_batches(train_loader, spd) if spd > 1 else train_loader, dev):
                state, _, loss_rec_dev = train_step(
                    state, batch, generator_of if spd > 1 else generator_of(state.step),
                    loss_rec_dev)
                prev_steps = steps
                steps += spd
                crossed = steps // log_every > prev_steps // log_every
                if profiling_until and steps >= profiling_until:
                    float(loss_rec_dev)  # the window's device work is done
                    if rank0:
                        profiling.stop_trace()
                    profiling_until = 0
                if crossed:
                    loss_rec = float(loss_rec_dev)  # the only per-step host sync
                    time_end = time.time()
                    log(f"steps: {steps:8d} loss: {loss_rec:.4f} "
                        f"time_cost: {time_end - time_start:.2f}")
                    time_start = time.time()
                    # every rank reaches this point at the same step
                    if stopper.agreed(dev):
                        done = True
                        log(f"stop signal at step {steps:8d} — "
                            "evaluating, checkpointing, exiting")
                        break
                if max_steps is not None and steps >= max_steps:
                    done = True
                    break
            if not done and stopper.agreed(dev):
                done = True
                log(f"stop signal at epoch {epoch:4d} end — "
                    "evaluating, checkpointing, exiting")
            loss_rec = float(loss_rec_dev)

            # -- evaluate: mean loss per batch, mean over batches; one host
            # sync for the whole val set. Across ranks: each batch's mean
            # weighted by its rows, so every row counts once per rank
            test_loader.set_epoch(epoch)
            batch_losses, rows = [], []
            for b in device_prefetch(test_loader, dev):
                batch_losses.append(eval_step(b))
                rows.append(b[0].shape[0])
            losses = torch.stack(batch_losses)
            if mesh is None:
                vloss = float(losses.mean())
            else:
                weights = torch.tensor(rows, dtype=losses.dtype, device=losses.device)
                total, count = pmesh.all_reduce_mesh(
                    [(losses * weights).sum(), weights.sum()], mesh)
                vloss = float(total / count)
            log(f"epoch: {epoch:4d}    loss: {vloss:.5f}    time:{asctime()}")
            if writer is not None:
                writer.add_scalar("loss", vloss, epoch)

            # NaN-safe: a diverged epoch (vloss NaN) compares False and
            # leaves best_loss finite
            improved = vloss < best_loss
            if improved:
                best_loss = vloss
            if sharded or rank0:  # a sharded run's every rank gathers
                params_snap, opt_snap, ema_snap = _snapshot(model, state, whole)
            if not rank0:
                pmesh.barrier()  # rank 0 saves the epoch
                if done:
                    break
                continue
            saver.wait()  # at most one epoch's saves in flight

            def save_epoch(epoch=epoch, steps=steps, loss_rec=loss_rec,
                           improved=improved, best=best_loss,
                           params=params_snap, opt_state=opt_snap, ema=ema_snap):
                if improved:
                    # MoE params have no reference torch layout: no .pkl
                    pkl = config.num_experts == 1
                    ckpt.save_checkpoint(os.path.join(run_dir, "bestloss.ckpt"), params)
                    if pkl:
                        ckpt.save_torch_pkl(params, os.path.join(run_dir, "bestloss.pkl"))
                    if ema is not None:  # the smoothed weights, beside the live best
                        ckpt.save_checkpoint(os.path.join(run_dir, "bestloss_ema.ckpt"), ema)
                        if pkl:
                            ckpt.save_torch_pkl(ema,
                                                os.path.join(run_dir, "bestloss_ema.pkl"))
                if config.snapshot_epochs and epoch % config.snapshot_epochs == 0:
                    snap_dir = os.path.join(run_dir, "snapshots")
                    os.makedirs(snap_dir, exist_ok=True)
                    ckpt.save_checkpoint(os.path.join(snap_dir, f"epoch_{epoch}.ckpt"), params)
                    if ema is not None:
                        ckpt.save_checkpoint(
                            os.path.join(snap_dir, f"epoch_{epoch}_ema.ckpt"), ema)
                ckpt.save_checkpoint(
                    os.path.join(run_dir, "lastepoch.ckpt"),
                    {"epoch": epoch, "steps": steps, "loss_rec": loss_rec,
                     "metric": best, "params": params, "opt_state": opt_state,
                     **({"ema_params": ema} if ema is not None else {})})

            saver.submit(save_epoch)
            if mesh is not None:
                pmesh.barrier()  # the others wait for the synchronous save
            if done:
                break
    finally:
        # every cleanup step runs even when an earlier one raises: an
        # abandoned checkpoint write loses the final epoch, a leaked signal
        # handler, profiler or nan check outlives run()
        try:
            try:
                if profiling_until and rank0:
                    profiling.stop_trace()  # the run ended inside the window
            finally:
                try:
                    if config.nan_checks:
                        profiling.enable_nan_checks(False)
                finally:
                    if writer is not None:
                        writer.close()
        finally:
            try:
                saver.wait()
            finally:
                stopper.__exit__()
    return TrainResult(best_loss=best_loss, last_val_loss=vloss, steps=steps,
                       run_dir=run_dir)
