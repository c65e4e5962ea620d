"""The port's multi-step dispatch (``steps_per_dispatch`` n > 1,
``train/step.make_train_step`` and ``train/trainer.py``) against the JAX
package's ``lax.scan`` dispatch, on the CPU.

* In the port an n-step call is n single calls bit for bit: parameters,
  AdamW moments, the EMA shadow, the EMA loss and the mean loss, at every
  drop rate 0.1 (each inner step draws from its own step's generator),
  with ``grad_accum`` and ``ema_decay`` too, and for a Switch-MoE model
  with its aux loss (the pipelined apply's case rides
  ``tests/test_torch_port_tp_pp.py``'s world).
* Against JAX's scan (dense route, drop rates 0, float32, the same params
  and stacked batches): the mean loss and the EMA loss within rtol 1e-5,
  parameters (and the EMA shadow) within ``tests/test_torch_port_train.py``'s
  step tolerance, atol 3e-3·lr·steps + rtol 1e-5 (the two frameworks' f32
  ops in another order, through Adam's first steps).
* The trainer: an n=2 run's step count, log lines and schedule length are
  JAX's (``tests/test_train.py::test_steps_per_dispatch_trainer_run``: 5
  batches of an epoch → 2 dispatches, the tail dropped, lines at steps 2
  and 4); a run whose epoch divides by n is bit for bit the n=1 run; JAX's
  two errors with JAX's messages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import config as port_config
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.train import step as port_step
from ddim_cold_torch.train import trainer as port_trainer
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT as JaxViT
from ddim_cold_tpu.train.step import create_train_state, make_train_step

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4,
            total_steps=8)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
LR = 1e-2


def _batches(n, b=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 16, 16, 3).astype(np.float32),
             rs.randn(b, 16, 16, 3).astype(np.float32),
             rs.randint(1, 7, size=(b,)).astype(np.int32)) for _ in range(n)]


def _stack(batches):
    return tuple(np.stack(leaves) for leaves in zip(*batches))


def _gen(step: int) -> torch.Generator:
    return port_step.step_generator(3, step, "cpu")


def _port_runs(n, steps, ema=0.0, grad_accum=1, use_flash=True, **drop):
    """The same 4-row batches through n=1 calls and through n-step calls,
    from one seeded model: (single state, single losses, single rec,
    dispatch state, dispatch losses, dispatch rec)."""
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches(steps)]
    out = []
    for per_call in (1, n):
        model = PortViT(**TINY, **drop, use_flash=use_flash, device="cpu", seed=1)
        state = port_step.create_train_state(model, LR, 10, ema_decay=ema)
        step = port_step.make_train_step(model, ema_decay=ema, grad_accum=grad_accum,
                                         steps_per_dispatch=per_call)
        rec, losses = torch.tensor(5.0), []
        for i in range(0, steps, per_call):
            group = batches[i:i + per_call]
            if per_call == 1:
                state, loss, rec = step(state, group[0], _gen(state.step), rec)
            else:
                state, loss, rec = step(state, tuple(map(torch.stack, zip(*group))),
                                        _gen, rec)
            losses.append(loss)
        out += [state, losses, rec]
    return out


def _assert_states_equal(a, b):
    assert a.step == b.step
    for which in ("params", "mu", "nu"):
        for x, y in zip(getattr(a, which), getattr(b, which)):
            assert torch.equal(x, y), which
    if a.ema_params is not None:
        for x, y in zip(a.ema_params, b.ema_params):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_is_n_single_calls_bitwise(n):
    single, s_losses, s_rec, multi, m_losses, m_rec = _port_runs(n, 4)
    _assert_states_equal(single, multi)
    assert torch.equal(s_rec, m_rec)
    for j, loss in enumerate(m_losses):
        assert torch.equal(loss, torch.stack(s_losses[j * n:(j + 1) * n]).mean())


def test_dispatch_composes_with_grad_accum_and_ema_bitwise():
    single, _, s_rec, multi, _, m_rec = _port_runs(2, 4, ema=0.9, grad_accum=2)
    _assert_states_equal(single, multi)
    assert torch.equal(s_rec, m_rec)


def test_dispatch_composes_with_the_moe_aux_bitwise():
    """A Switch-MoE model stepping with its load-balance aux (JAX's
    ``moe_aux_weight``): the dispatch is the single calls bit for bit."""
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches(2)]
    got = []
    for n in (1, 2):
        model = PortViT(**TINY, num_experts=2, device="cpu", seed=1)
        state = port_step.create_train_state(model, LR, 10)
        step = port_step.make_train_step(model, moe_aux_weight=0.01, steps_per_dispatch=n)
        rec = torch.tensor(5.0)
        if n == 1:
            for b in batches:
                state, _, rec = step(state, b, _gen(state.step), rec)
        else:
            state, _, rec = step(state, tuple(map(torch.stack, zip(*batches))), _gen, rec)
        got.append((state, rec))
    _assert_states_equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def _jax_and_port(n, ema=0.0, grad_accum=1, seed=0):
    """n steps through JAX's scan and the port's dispatch from the same
    params and stacked batches, dense route, drop rates 0."""
    batches = _batches(n, seed=seed)
    jm = JaxViT(**TINY, **NO_DROP)
    st = create_train_state(jm, jax.random.PRNGKey(0), LR, 10,
                            tuple(map(jnp.asarray, batches[0])), ema_decay=ema)
    pm = PortViT(**TINY, **NO_DROP, device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(st.params), 4), strict=True)
    pst = port_step.create_train_state(pm, LR, 10, ema_decay=ema)
    stacked = _stack(batches)
    jstep = make_train_step(jm, ema_decay=ema, grad_accum=grad_accum, steps_per_dispatch=n)
    st, jloss, jrec = jstep(st, tuple(map(jnp.asarray, stacked)), jax.random.PRNGKey(1),
                            jnp.float32(5.0))
    pstep = port_step.make_train_step(pm, ema_decay=ema, grad_accum=grad_accum,
                                      steps_per_dispatch=n)
    pst, ploss, prec = pstep(pst, tuple(map(torch.from_numpy, stacked)), _gen,
                             torch.tensor(5.0))
    return st, (float(jloss), float(jrec)), pst, (ploss.item(), prec.item())


def _assert_tree_close(jax_tree, tensors, names, steps):
    want = state_dict_from_flax(jax.device_get(jax_tree), 4)
    for name, got in zip(names, tensors):
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=3e-3 * LR * steps, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_matches_jaxs_scan(n):
    st, (jl, jr), pst, (pl, pr) = _jax_and_port(n)
    assert pl == pytest.approx(jl, rel=1e-5) and pr == pytest.approx(jr, rel=1e-5)
    assert pst.step == int(st.step) == n
    _assert_tree_close(st.params, pst.params, pst.names, n)


def test_dispatch_with_grad_accum_and_ema_matches_jax():
    """JAX's ``test_steps_per_dispatch_composes_with_grad_accum_and_ema``:
    n=2 × grad_accum=2 × ema_decay 0.9."""
    st, (_, jr), pst, (_, pr) = _jax_and_port(2, ema=0.9, grad_accum=2, seed=1)
    assert pr == pytest.approx(jr, rel=1e-5)
    _assert_tree_close(st.params, pst.params, pst.names, 2)
    _assert_tree_close(st.ema_params, pst.ema_params, pst.names, 2)


def test_dispatch_errors_are_jaxs():
    model = PortViT(**TINY, device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        port_step.make_train_step(model, steps_per_dispatch=0)
    step = port_step.make_train_step(model, steps_per_dispatch=2)
    state = port_step.create_train_state(model, LR, 10)
    stacked = tuple(map(torch.from_numpy, _stack(_batches(3))))
    with pytest.raises(ValueError, match="leading axis"):
        step(state, stacked, _gen, torch.tensor(5.0))


# ------------------------------------------------------------------ trainer

def _config(data_dir, **kw):
    return port_config.ExperimentConfig(**dict(
        dict(exp_name="dispatch", framework="port", batch_size=2, epoch=(0, 1),
             base_lr=0.005, data_storage=(data_dir, data_dir), image_size=(16, 16),
             patch_size=8, embed_dim=32, depth=1, head=2, use_flash=True), **kw))


def test_trainer_dispatch_run_is_jaxs(tmp_path, synthetic_image_dir, monkeypatch):
    """JAX's trainer test: 10 images at batch 2 → 5 batches → 2 dispatches
    of 2 (the tail dropped) → 4 steps, log lines at steps 2 and 4 with
    ``log_every=2``; the cosine runs those 4 steps."""
    lengths = []
    create = port_trainer.create_train_state
    monkeypatch.setattr(port_trainer, "create_train_state",
                        lambda model, lr, total, **kw: lengths.append(total)
                        or create(model, lr, total, **kw))
    cfg = _config(synthetic_image_dir, steps_per_dispatch=2)
    result = port_trainer.run(cfg, str(tmp_path), log_every=2, device="cpu")
    assert result.steps == 4 and lengths == [4] and np.isfinite(result.best_loss)
    text = open(os.path.join(result.run_dir, "train.log")).read()
    assert "steps:        2 " in text and "steps:        4 " in text
    assert "steps:        6 " not in text and "TrainSet batchs:5" in text
    last = port_ckpt.load_checkpoint(os.path.join(result.run_dir, "lastepoch.ckpt"))
    assert last["steps"] == last["opt_state"]["count"] == 4


def test_trainer_dispatch_is_bitwise_the_single_step_run(tmp_path, synthetic_image_dir):
    """Batch 1: 10 batches an epoch, so n=2 drops nothing and the schedule is
    the n=1 run's. Two epochs at every drop rate 0.1: the same parameters,
    moments, EMA loss and validation losses bit for bit; the log lines of
    the n=1 run at every second step."""
    runs = {}
    for n in (1, 2):
        cfg = _config(synthetic_image_dir, batch_size=1, epoch=(0, 2), steps_per_dispatch=n)
        runs[n] = port_trainer.run(cfg, str(tmp_path / f"n{n}"), log_every=4, device="cpu")
    a, b = runs[1], runs[2]
    assert a.steps == b.steps == 20
    assert a.last_val_loss == b.last_val_loss and a.best_loss == b.best_loss
    ca, cb = (port_ckpt.load_checkpoint(os.path.join(r.run_dir, "lastepoch.ckpt"))
              for r in (a, b))
    assert ca["loss_rec"] == cb["loss_rec"]
    for name in ca["params"]:
        assert torch.equal(ca["params"][name], cb["params"][name]), name
    for which in ("mu", "nu"):
        for name in ca["opt_state"][which]:
            assert torch.equal(ca["opt_state"][which][name], cb["opt_state"][which][name])
    steps_of = lambda r: [line.split("loss")[0] for line in  # noqa: E731
                          open(os.path.join(r.run_dir, "train.log")) if "steps:" in line]
    assert steps_of(a) == steps_of(b) and len(steps_of(a)) == 5


def test_trainer_errors_are_jaxs(tmp_path, synthetic_image_dir):
    with pytest.raises(ValueError, match=r"steps_per_dispatch 6 exceeds the 5 batches "
                                         r"in an epoch — every epoch would drop"):
        port_trainer.run(_config(synthetic_image_dir, steps_per_dispatch=6),
                         str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match=r"max_steps=3 is not reachable in whole "
                                         r"dispatches of steps_per_dispatch=2 from "
                                         r"start step 0"):
        port_trainer.run(_config(synthetic_image_dir, steps_per_dispatch=2),
                         str(tmp_path / "b"), max_steps=3, device="cpu")
    # a bound reachable from the start step runs exactly to it
    cfg = dataclasses.replace(_config(synthetic_image_dir, steps_per_dispatch=2),
                              exp_name="bound")
    assert port_trainer.run(cfg, str(tmp_path / "c"), max_steps=2,
                            device="cpu").steps == 2
