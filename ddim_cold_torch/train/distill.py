"""Progressive distillation: the teacher takes two steps, the student learns
one (counterpart of ``ddim_cold_tpu/train/distill.py``).

The served few-step samplers (``ops/sampling.ddim_sample_fewstep``,
``SamplerConfig(steps=k, student=True)``) are only as good as the weights
behind them. Progressive distillation (Salimans & Ho) closes that gap with
a halving loop: each round the TEACHER runs two consecutive steps of its
2s-evaluation schedule and the STUDENT — the same architecture, started
as a copy of the teacher — learns to land on the teacher's two-step output
in one update of its s-evaluation schedule. The round's student becomes
the next round's teacher, so one model yields the whole k ∈ {…, 4, 2, 1}
family.

Every other entry of ``fewstep_time_sequence(T, 2s)`` IS
``fewstep_time_sequence(T, s)`` (ops/schedule.py), so student position j
sits at teacher position 2j, and the teacher's sub-steps (2j, 2j+1) end
where the student's single update j must land. The update is the
sampler's own affine form (``fewstep_coefficients``), the jump-to-clean
final row included.

* ``variant="ddim"`` — Gaussian forward noising at the drawn level (the
  dataset's ᾱ(t) = 1 − √((t+1)/T)), teacher sub-steps by the affine DDIM
  update.
* ``variant="cold"`` — the cold degradation (ops/degrade.cold_degrade) at
  the drawn level; the teacher's two steps are two model applications at
  consecutive levels and the student matches the second output directly.

The teacher runs under ``torch.no_grad()`` on a model of its own; the
student's forward is the evaluation forward (``deterministic=True``), so a
``use_flash`` model runs the flash kernels forward and backward, whatever
its ``attn_drop_rate`` (JAX vit.py:231). The optimizer is the port's
optax-equal chain (train/step.py ``create_train_state`` /
``apply_gradients``). Checkpoints are the port's own files
(utils/checkpoint.py) in JAX's layout: ``student_k<steps>/`` per finished
round and a mid-round ``live/``.

Randomness: iteration ``it`` of the round with ``steps`` draws its batch
and its positions and noise from streams folded from
``(seed, steps, it)``, so a resumed round draws what the uninterrupted one
would have. The bits differ from JAX's.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ddim_cold_torch.ops import degrade, schedule
from ddim_cold_torch.ops.sampling import _sampling_device, fold_in
from ddim_cold_torch.train.step import TrainState, apply_gradients, create_train_state
from ddim_cold_torch.utils import checkpoint as ckpt
from ddim_cold_torch.utils.logging import print_log

#: the files of a finished round's student and of the mid-round state
ROUND_FILE, LIVE_FILE = "params.ckpt", "state.ckpt"


def _log(msg: str, log: Optional[str]) -> None:
    print(msg, flush=True)
    if log:
        print_log(msg, log)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Knobs for one halving run. Defaults are CPU-smoke sized (seconds,
    not hours) — a real run raises ``iters``/``batch_size``/``lr`` and
    points ``checkpoint_dir`` somewhere durable."""

    start_steps: int = 4      # first student's evaluation count
    target_steps: int = 1     # halve until this count is reached
    iters: int = 60           # optimizer updates per round
    batch_size: int = 8
    lr: float = 1e-4
    variant: str = "ddim"     # "ddim" | "cold"
    cold_levels: int = 6      # cold: the start degradation level L
    ema_decay: float = 0.0    # > 0 keeps an EMA shadow of the student
    log_every: int = 20
    save_every: int = 0       # mid-round live-checkpoint cadence (0 = off)
    checkpoint_dir: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if self.target_steps < 1:
            raise ValueError(
                f"target_steps must be >= 1, got {self.target_steps}")
        s = self.start_steps
        if s < self.target_steps:
            raise ValueError(
                f"start_steps ({s}) must be >= target_steps "
                f"({self.target_steps})")
        while s > self.target_steps:
            if s % 2:
                raise ValueError(
                    f"start_steps ({self.start_steps}) must reach "
                    f"target_steps ({self.target_steps}) by halving")
            s //= 2
        if s != self.target_steps:
            raise ValueError(
                f"start_steps ({self.start_steps}) must reach target_steps "
                f"({self.target_steps}) by halving")
        if self.variant not in ("ddim", "cold"):
            raise ValueError(
                f"variant must be 'ddim' or 'cold', got {self.variant!r}")
        if self.variant == "cold":
            for s in self.round_steps():
                if self.cold_levels % (2 * s):
                    raise ValueError(
                        f"cold_levels ({self.cold_levels}) must divide into "
                        f"2x the round's step count (round steps={s}) so "
                        "teacher/student level strides stay integral")
        if self.iters < 1 or self.batch_size < 1:
            raise ValueError("iters and batch_size must be >= 1")

    def round_steps(self) -> list:
        """Student evaluation counts, one per round: start, start/2, …,
        target."""
        out, s = [], self.start_steps
        while s >= self.target_steps:
            out.append(s)
            if s == self.target_steps:
                break
            s //= 2
        return out


def synthetic_batch(generator: torch.Generator, n: int, img_size, chans: int):
    """Placeholder clean images: piecewise-constant [−1, 1] tiles (a 4×4
    uniform draw nearest-upsampled), on the generator's device, so the
    distill loss has structure to fit without a dataset."""
    H, _ = img_size
    tiles = torch.rand((n, min(4, H), min(4, H), chans), generator=generator,
                       device=generator.device)
    return degrade.upsample_nearest(tiles * 2.0 - 1.0, H)


def draw(x0: torch.Tensor, generator: torch.Generator, steps: int, variant: str):
    """One step's randomness: a student position j ∈ [0, steps) per example
    and, for ``ddim``, the forward noise ε (None for ``cold``)."""
    j = torch.randint(0, steps, (x0.shape[0],), generator=generator, device=x0.device)
    eps = (torch.randn(x0.shape, generator=generator, device=x0.device,
                       dtype=torch.float32) if variant == "ddim" else None)
    return j, eps


def _col(values: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=dev)


def make_distill_step(model, *, steps: int, variant: str = "ddim",
                      cold_levels: int = 6, ema_decay: float = 0.0) -> Callable:
    """``(state, teacher, x0, generator, loss_rec) → (state, loss,
    loss_rec)``: one update of ``state.model`` (the student), ``teacher`` a
    model of the same architecture as ``model``.

    Per example, a schedule position j is drawn uniformly, the clean image
    is corrupted to the student's level t_j, the teacher takes its two
    sub-steps (2j, 2j+1) under ``torch.no_grad()`` and the student's single
    update j is regressed onto the teacher's landing point: MSE in update
    space, so the final jump-to-clean position is plain x̂₀ matching. The
    loss record is 0.99·rec + 0.01·loss, a device scalar (no host sync)."""
    T = model.total_steps
    dev = model.device
    if variant == "ddim":
        c_s = schedule.fewstep_coefficients(T, steps)
        c_t = schedule.fewstep_coefficients(T, 2 * steps)
        t_s, t_t = c_s.t_seq, c_t.t_seq
        cx_s, cx0_s = _col(c_s.cx, dev), _col(c_s.cx0, dev)
        cx_t, cx0_t = _col(c_t.cx, dev), _col(c_t.cx0, dev)
    else:
        stride = cold_levels // steps
        t_s = np.arange(cold_levels, 0, -stride, dtype=np.int32)
        t_t = np.arange(cold_levels, 0, -stride // 2, dtype=np.int32)
    t_s = torch.as_tensor(t_s, dtype=torch.long, device=dev)
    t_t = torch.as_tensor(t_t, dtype=torch.long, device=dev)

    def forward(net, x, t):
        return net(x, t).clamp(-1.0, 1.0)

    @torch.no_grad()
    def teacher_target(teacher, x, j):
        """Two teacher sub-steps from student position j — the landing
        point the student must reach in one update."""
        if variant == "ddim":
            y = x
            for sub in (2 * j, 2 * j + 1):
                x0 = forward(teacher, y, t_t[sub])
                y = (cx_t[sub][:, None, None, None] * y
                     + cx0_t[sub][:, None, None, None] * x0)
            return y
        y = forward(teacher, x, t_t[2 * j])
        return forward(teacher, y, t_t[2 * j + 1])

    def step(state: TrainState, teacher, x0: torch.Tensor,
             generator: torch.Generator, loss_rec: torch.Tensor):
        if ema_decay and state.ema_params is None:
            raise ValueError("ema_decay > 0 but the state carries no ema_params")
        j, eps = draw(x0, generator, steps, variant)
        if variant == "ddim":
            t = t_s[j].float()
            alpha = (1.0 - torch.sqrt((t + 1.0) / T))[:, None, None, None]
            x_t = torch.sqrt(alpha) * x0 + torch.sqrt(1.0 - alpha) * eps
        else:
            x_t = degrade.cold_degrade(x0, t_s[j], size=x0.shape[1],
                                       max_step=cold_levels)
        target = teacher_target(teacher, x_t, j)
        x0_s = forward(state.model, x_t, t_s[j])
        if variant == "ddim":
            pred = (cx_s[j][:, None, None, None] * x_t
                    + cx0_s[j][:, None, None, None] * x0_s)
        else:
            pred = x0_s
        loss = torch.mean(torch.square(pred - target))
        grads = list(torch.autograd.grad(loss, state.params))
        apply_gradients(state, grads)
        if ema_decay:
            with torch.no_grad():  # ema ← d·ema + (1 − d)·p
                torch._foreach_mul_(state.ema_params, ema_decay)
                torch._foreach_add_(state.ema_params, state.params,
                                    alpha=1.0 - ema_decay)
        loss = loss.detach()
        return state, loss, 0.99 * loss_rec + 0.01 * loss

    return step


def make_student_state(teacher, lr: float, total_iters: int,
                       ema_decay: float = 0.0) -> TrainState:
    """A fresh optimizer around a COPY of the teacher model — the standard
    progressive-distillation init (the student starts as the teacher and
    only has to learn the schedule compression)."""
    return create_train_state(copy.deepcopy(teacher), lr, total_iters, ema_decay)


def _student_weights(state: TrainState, ema: bool) -> dict:
    """The round's result as a state_dict on the model's device: the EMA
    shadow when the run keeps one, else the params."""
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    if ema:
        sd.update({n: e.detach().clone() for n, e in zip(state.names, state.ema_params)})
    return sd


def _holding(model, state_dict: dict):
    """A copy of ``model`` holding ``state_dict`` (the next round's teacher)."""
    out = copy.deepcopy(model)
    out.load_state_dict(state_dict, strict=True)
    return out


def distill(model, config: DistillConfig = DistillConfig(), *,
            batches: Optional[Callable] = None, log=None,
            device=None) -> Dict[str, Any]:
    """Run the halving loop from the teacher ``model`` (never modified);
    returns ``{"students": {steps: state_dict}, "history": {steps: [logged
    losses]}, "final_steps": k}``, the state_dicts on the model's device,
    ready for ``Engine(student_params=...)`` or ``load_state_dict``.

    ``batches`` is ``(generator) → (batch_size, H, W, C)`` clean images in
    [−1, 1] on the model's device; the default draws
    :func:`synthetic_batch`. With ``config.checkpoint_dir`` set, each
    finished round lands in ``student_k<steps>/`` and a ``live/``
    checkpoint (every ``save_every`` iterations) makes a mid-round
    interrupt resumable: rerunning the same config restores finished rounds
    from disk and resumes the live round at its iteration. ``device`` (None
    means ``"cuda"``) must be the model's device."""
    dev = _sampling_device(model, device)
    cfg = config
    if batches is None:
        H, W = model.img_size

        def batches(generator):
            return synthetic_batch(generator, cfg.batch_size, (H, W), model.in_chans)

    base = torch.Generator(device=dev).manual_seed(cfg.seed)
    students: Dict[int, Any] = {}
    history: Dict[int, list] = {}
    teacher = model
    expected = model.state_dict()
    live_dir = (os.path.join(cfg.checkpoint_dir, "live")
                if cfg.checkpoint_dir else None)
    live_file = os.path.join(live_dir, LIVE_FILE) if live_dir else None
    for round_idx, steps in enumerate(cfg.round_steps()):
        round_dir = (os.path.join(cfg.checkpoint_dir, f"student_k{steps}")
                     if cfg.checkpoint_dir else None)
        round_file = os.path.join(round_dir, ROUND_FILE) if round_dir else None
        if round_file and os.path.isfile(round_file):
            sd = ckpt.load_checkpoint(round_file)["params"]
            ckpt.check_loaded_params(sd, expected, round_file)
            students[steps] = {k: v.to(dev) for k, v in sd.items()}
            teacher = _holding(model, students[steps])
            history[steps] = []
            _log(f"distill round {round_idx} (k={steps}): restored "
                 f"finished student from {round_dir}", log)
            continue
        state = make_student_state(teacher, cfg.lr, cfg.iters, cfg.ema_decay)
        start_iter = 0
        if live_file and os.path.isfile(live_file):
            live = ckpt.load_checkpoint(live_file)
            if int(live["steps"]) == steps:
                ckpt.check_loaded_params(live["params"], expected, live_file)
                state.model.load_state_dict(live["params"], strict=True)
                state.load_opt_state_dict(live["opt_state"])
                start_iter = int(live["iter"])
                _log(f"distill round {round_idx} (k={steps}): resumed "
                     f"at iter {start_iter}", log)
        step_fn = make_distill_step(model, steps=steps, variant=cfg.variant,
                                    cold_levels=cfg.cold_levels,
                                    ema_decay=cfg.ema_decay)
        loss_rec = torch.zeros((), dtype=torch.float32, device=dev)
        losses = []
        stream = fold_in(base, steps)
        for it in range(start_iter, cfg.iters):
            g = fold_in(stream, it)
            x0 = batches(fold_in(g, 0))
            state, loss, loss_rec = step_fn(state, teacher, x0, fold_in(g, 1), loss_rec)
            if cfg.log_every and (it + 1) % cfg.log_every == 0:
                val = float(loss)
                losses.append(val)
                _log(f"distill k={steps} iter {it + 1:5d}/{cfg.iters} "
                     f"loss {val:.6f}", log)
            if live_dir and cfg.save_every and (it + 1) % cfg.save_every == 0:
                os.makedirs(live_dir, exist_ok=True)
                ckpt.save_checkpoint(live_file, {
                    "steps": steps, "iter": it + 1, "loss": float(loss),
                    "params": state.model.state_dict(),
                    "opt_state": state.opt_state_dict()})
        student = _student_weights(state, bool(cfg.ema_decay))
        if round_dir:
            os.makedirs(round_dir, exist_ok=True)
            ckpt.save_checkpoint(round_file, {"params": student})
        students[steps] = student
        teacher = _holding(model, student)
        history[steps] = losses
    return {"students": students, "history": history,
            "final_steps": cfg.target_steps}
