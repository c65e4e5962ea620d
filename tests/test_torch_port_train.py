"""The port's training path against the JAX package's, on the CPU.

* One and three optimizer steps of ``train/step.make_train_step`` against
  JAX's ``make_train_step`` from the same params (carried over with
  ``utils.weights.state_dict_from_flax``) and the same batches, every drop
  rate 0, float32, flash and dense attention; then three steps with the clip
  engaged (the head's weights scaled 100×, so ‖g‖ > 1 from the first step),
  ``grad_accum=2`` and ``ema_decay=0.5``. Tolerances: loss rtol 1e-5 (f32
  forward, the two frameworks' ops in another order); params and EMA atol
  3e-3·lr·steps + rtol 1e-5: Adam's first steps move each parameter by about
  lr·g/(|g|+ε), so gradients that agree to ~1e-5 relative give updates that
  agree to a small fraction of lr, except where a gradient is within that
  difference of zero (largest measured here: 1e-3·lr, one zero-initialised
  qkv bias element).
* ``remat``: one step of the remat model against JAX's ``nn.remat`` at the
  step tolerances above; and bit for bit the plain step (losses,
  parameters, the generator's state) over two steps at every drop rate 0.1
  on the dense route and the flash route's plain versions, with the forward
  run twice per block and step on the flash route.
* Dropout and stochastic depth, statistically (keep rate within 5σ, the
  1/keep scaling exact), and the routing rule: a training forward with
  attention dropout takes the dense path.
* ``config.py`` against JAX's on both YAMLs the repo ships.
* ``trainer.run`` at TINY for 2 epochs, then a resume: the log lines, the
  checkpoint files, and that resume restores the step count (the cosine
  position), the best metric and the EMA loss; ``bestloss.pkl`` loads into
  the JAX package's reference-name bridge. The loss itself is not compared
  with a JAX run: the dropout bits differ between the frameworks, and the
  config has no drop-rate key to turn dropout off.
"""

import dataclasses
import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddim_cold_torch import config as port_config
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.models import vit as port_vit
from ddim_cold_torch.train import step as port_step
from ddim_cold_torch.train import trainer as port_trainer
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import config as jax_config
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.train.step import create_train_state, make_train_step
from ddim_cold_tpu.utils import checkpoint as jax_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4,
            total_steps=8)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)


def _batches(n=3, b=8, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 16, 16, 3).astype(np.float32),
             rs.randn(b, 16, 16, 3).astype(np.float32),
             rs.randint(1, 7, size=(b,)).astype(np.int32)) for _ in range(n)]


def _run_both(use_flash, n_steps, lr, grad_accum=1, ema=0.0, head_scale=1.0, remat=False):
    batches = _batches(n_steps)
    jm = DiffusionViT(**TINY, **NO_DROP, use_flash=use_flash, remat=remat)
    st = create_train_state(jm, jax.random.PRNGKey(0), lr, 10,
                            tuple(map(jnp.asarray, batches[0])), ema_decay=ema)
    if head_scale != 1.0:
        params = dict(jax.device_get(st.params))
        params["head"] = dict(params["head"], kernel=params["head"]["kernel"] * head_scale)
        params = jax.tree.map(jnp.asarray, params)
        st = st.replace(params=params,
                        ema_params=jax.tree.map(jnp.copy, params) if ema else None)
    pm = PortViT(**TINY, **NO_DROP, use_flash=use_flash, remat=remat, device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(st.params), 4), strict=True)
    pst = port_step.create_train_state(pm, lr, 10, ema_decay=ema)
    jstep = make_train_step(jm, ema_decay=ema, grad_accum=grad_accum)
    pstep = port_step.make_train_step(pm, ema_decay=ema, grad_accum=grad_accum)
    jrec, prec = jnp.float32(5.0), torch.tensor(5.0)
    gen = torch.Generator()
    losses, norms = [], []
    for b in batches:
        st, jl, jrec = jstep(st, tuple(map(jnp.asarray, b)), jax.random.PRNGKey(1), jrec)
        pst, pl, prec = pstep(pst, tuple(map(torch.from_numpy, b)), gen, prec)
        losses.append((float(jl), pl.item()))
        norms.append(pst.grad_norm.item())
    return st, pst, losses, norms, (float(jrec), prec.item())


def _assert_params_close(jax_tree, port_tensors, names, lr, steps):
    want = state_dict_from_flax(jax.device_get(jax_tree), 4)
    for name, got in zip(names, port_tensors):
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=3e-3 * lr * steps, err_msg=name)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("use_flash", [False, True])
def test_train_steps_match_jax(use_flash, n_steps):
    lr = 1e-2
    st, pst, losses, _, recs = _run_both(use_flash, n_steps, lr)
    for jl, pl in losses:
        assert pl == pytest.approx(jl, rel=1e-5)
    assert recs[1] == pytest.approx(recs[0], rel=1e-6)
    assert pst.step == n_steps
    _assert_params_close(st.params, pst.params, pst.names, lr, n_steps)


@pytest.mark.parametrize("use_flash", [False, True])
def test_clipped_accumulated_ema_steps_match_jax(use_flash):
    lr = 1e-2
    st, pst, losses, norms, _ = _run_both(use_flash, 3, lr, grad_accum=2, ema=0.5,
                                          head_scale=100.0)
    assert min(norms) > 1.0  # clip_by_global_norm(1.0) engaged at every step
    for jl, pl in losses:
        assert pl == pytest.approx(jl, rel=1e-5)
    _assert_params_close(st.params, pst.params, pst.names, lr, 3)
    _assert_params_close(st.ema_params, pst.ema_params, pst.names, lr, 3)


def test_remat_step_matches_jax_remat():
    """One step of the remat model (JAX ``nn.remat(Block)``, the port's
    ``torch.utils.checkpoint``), dense route, drop rates 0: within the
    step's tolerances above."""
    lr = 1e-2
    st, pst, losses, _, _ = _run_both(False, 1, lr, remat=True)
    assert pst.model.remat
    assert losses[0][1] == pytest.approx(losses[0][0], rel=1e-5)
    _assert_params_close(st.params, pst.params, pst.names, lr, 1)


@pytest.mark.parametrize("use_flash", [False, True])
def test_remat_is_bitwise_the_plain_step(use_flash, monkeypatch):
    """Two steps with and without remat, dropout and drop path 0.1 (and
    attention dropout 0.1 on the dense route; 0 on the flash route, whose
    plain versions run here): losses, parameters and the generator's state
    after the steps bit for bit equal. The recomputation replays each
    block's masks; on the flash route the forward runs twice per block and
    step (2 × depth), the backward once."""
    from ddim_cold_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_forward, fa.flash_backward

    def spy(key, real):
        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "flash_forward", spy("fwd", real_fwd))
    monkeypatch.setattr(fa, "flash_backward", spy("bwd", real_bwd))
    rates = dict(drop_rate=0.1, drop_path_rate=0.1,
                 attn_drop_rate=0.0 if use_flash else 0.1)
    got = {}
    for remat in (False, True):
        model = PortViT(**TINY, **rates, use_flash=use_flash, remat=remat, device="cpu")
        state = port_step.create_train_state(model, 1e-2, 10)
        step = port_step.make_train_step(model)
        gen, rec = torch.Generator().manual_seed(7), torch.tensor(5.0)
        calls.update(fwd=0, bwd=0)
        losses = []
        for b in _batches(2):
            state, loss, rec = step(state, tuple(map(torch.from_numpy, b)), gen, rec)
            losses.append(loss)
        got[remat] = (losses, [p.detach().clone() for p in model.parameters()],
                      gen.get_state(), dict(calls))
    (l0, p0, g0, c0), (l1, p1, g1, c1) = got[False], got[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(g0, g1)
    depth, steps = TINY["depth"], 2
    if use_flash:
        assert c0 == {"fwd": depth * steps, "bwd": depth * steps}
        assert c1 == {"fwd": 2 * depth * steps, "bwd": depth * steps}
    else:
        assert c0 == c1 == {"fwd": 0, "bwd": 0}


def test_learning_rate_is_optax_cosine_before_the_update():
    """The port computes the cosine in float64, optax in float32: equal to
    f32's rounding of cos (abs 1e-9 ≈ 3e-7 of the initial lr near the end,
    where 1 + cos is small)."""
    sched = optax.cosine_decay_schedule(init_value=3e-3, decay_steps=37, alpha=0.0)
    st = port_step.create_train_state(PortViT(**TINY, device="cpu"), 3e-3, 37)
    for count in (0, 1, 18, 36, 37, 50):
        assert st.learning_rate(count) == pytest.approx(float(sched(count)), rel=1e-6, abs=1e-9)


def test_make_train_step_refuses():
    model = PortViT(**TINY, device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):  # JAX's
        port_step.make_train_step(model, steps_per_dispatch=0)
    moe = PortViT(**TINY, num_experts=2, device="cpu")
    with pytest.raises(ValueError, match="threads the 'losses' collection"):  # JAX's
        port_step.make_train_step(moe, lambda *a, **k: None, moe_aux_weight=0.01)
    with pytest.raises(ValueError, match="ema_decay"):
        port_step.make_train_step(model, ema_decay=1.0)
    with pytest.raises(ValueError, match="grad_accum"):
        port_step.make_train_step(model, grad_accum=0)
    st = port_step.create_train_state(model, 1e-2, 10)
    b = tuple(map(torch.from_numpy, _batches(1, 2)[0]))
    with pytest.raises(ValueError, match="no ema_params"):
        port_step.make_train_step(model, ema_decay=0.9)(st, b, torch.Generator(),
                                                        torch.tensor(5.0))


# ------------------------------------------------------- dropout and routing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_rate_and_scaling(dtype):
    x = torch.ones(200_000, dtype=dtype)
    out = port_vit._dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    frac = kept.float().mean().item()
    assert abs(frac - 0.9) < 5 * math.sqrt(0.9 * 0.1 / x.numel())
    assert out.dtype == dtype and torch.equal(out[kept], (x / 0.9)[kept])
    assert port_vit._dropout(x, 0.1, None) is x  # deterministic
    assert port_vit._dropout(x, 0.0, torch.Generator()) is x
    assert not port_vit._dropout(x, 1.0, torch.Generator()).any()


def test_drop_path_is_per_sample_at_linspace_rates():
    model = PortViT(**TINY, drop_path_rate=0.6, device="cpu")
    assert [blk.drop_path for blk in model.blocks] == pytest.approx(
        list(np.linspace(0.0, 0.6, TINY["depth"])))
    blk = model.blocks[-1]
    y = torch.ones(4000, 3, 5)
    out = blk._residual(y, torch.Generator().manual_seed(1))
    per_sample = out.reshape(4000, -1)
    # each sample is dropped or kept whole, survivors scaled by 1/keep
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.4).all(1))
    frac = (per_sample[:, 0] != 0).float().mean().item()
    assert abs(frac - 0.4) < 5 * math.sqrt(0.4 * 0.6 / 4000)


def _count_flash(monkeypatch):
    calls = []
    real = port_vit.flash_attention_qkv
    monkeypatch.setattr(port_vit, "flash_attention_qkv",
                        lambda qkv, scale: calls.append(1) or real(qkv, scale))
    return calls


@pytest.mark.parametrize("attn_drop,deterministic,flash", [
    (0.1, False, False),  # the JAX default in training: dense + attention dropout
    (0.1, True, True),    # evaluation: flash
    (0.0, False, True),   # training with attention dropout off: flash
])
def test_training_forward_routes_by_the_weightless_rule(monkeypatch, attn_drop,
                                                         deterministic, flash):
    calls = _count_flash(monkeypatch)
    model = PortViT(**TINY, use_flash=True, attn_drop_rate=attn_drop, device="cpu")
    x, t = torch.zeros(2, 16, 16, 3), torch.tensor([1, 2])
    model(x, t, deterministic=deterministic, generator=torch.Generator())
    assert (len(calls) == TINY["depth"]) if flash else not calls


def test_training_forward_draws_from_its_generator():
    model = PortViT(**TINY, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32))
    t = torch.tensor([3, 4])
    run = lambda seed: model(x, t, deterministic=False,  # noqa: E731
                             generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        assert torch.equal(run(0), run(0))
        assert not torch.equal(run(0), run(1))
        assert not torch.equal(run(0), model(x, t))
    with pytest.raises(ValueError, match="generator"):
        model(x, t, deterministic=False)


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("yaml_name", ["20220822.yaml", "20220822_200px.yaml"])
def test_config_matches_jax(yaml_name):
    path = os.path.join(ROOT, yaml_name)
    got, want = port_config.load_config(path), jax_config.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in ("effective_batch", "lr", "total_steps", "run_name",
                 "data_parallel_size"):
        assert getattr(got, attr) == getattr(want, attr)
    assert got.model_kwargs() == want.model_kwargs()  # flash_blocks included


def test_config_validators_match_jax(tmp_path):
    import yaml

    for bad in ({"use_flahs": True}, {"ema_decay": 1.0}, {"grad_accum": 0},
                {"flash_blocks": [512, 1024]}, {"sp_mode": "x"}):
        path = tmp_path / "bad.yaml"
        path.write_text(yaml.safe_dump(bad))
        with pytest.raises(ValueError) as port_err:
            port_config.load_config(str(path))
        with pytest.raises(ValueError) as jax_err:
            jax_config.load_config(str(path))
        assert str(port_err.value) == str(jax_err.value)


# ----------------------------------------------------------------- trainer


def _tiny_config(data_dir, **kw):
    return port_config.ExperimentConfig(
        exp_name="tiny", framework="port", batch_size=2, epoch=(0, 2), base_lr=0.005,
        data_storage=(data_dir, data_dir), image_size=(16, 16), patch_size=8,
        embed_dim=32, depth=1, head=2, use_flash=True, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, synthetic_image_dir):
    base = str(tmp_path_factory.mktemp("port_run"))
    cfg = _tiny_config(synthetic_image_dir, initializing="tiny_init.pkl", ema_decay=0.5)
    return base, cfg, port_trainer.run(cfg, base, log_every=2, device="cpu")


def test_trainer_run_logs_and_checkpoints(trained):
    base, cfg, result = trained
    assert result.steps == 2 * (10 // 2)  # 2 epochs × 5 batches of 2
    assert math.isfinite(result.last_val_loss) and result.best_loss < 5.0
    files = set(os.listdir(result.run_dir))
    assert {"bestloss.ckpt", "bestloss.pkl", "bestloss_ema.ckpt", "bestloss_ema.pkl",
            "lastepoch.ckpt", "train.log", "metrics.jsonl"} <= files
    assert os.path.isfile(os.path.join(base, "Saved_Models", "tiny_init.pkl"))
    log = open(os.path.join(result.run_dir, "train.log")).read().splitlines()
    assert re.fullmatch(r"Date: .+", log[0])
    assert log[1:3] == ["TrainSet batchs:5", "TestSet batchs:5"]
    steps = [ln for ln in log if ln.startswith("steps:")]
    assert len(steps) == 5  # every log_every=2 of 10 steps
    assert all(re.fullmatch(r"steps: +\d+ loss: \d+\.\d{4} time_cost: \d+\.\d{2}", ln)
               for ln in steps)
    assert float(steps[0].split()[3]) < 5.0  # the EMA loss starts from 5.0
    epochs = [ln for ln in log if ln.startswith("epoch:")]
    assert [ln[:11] for ln in epochs] == ["epoch:    0", "epoch:    1"]
    assert all(re.fullmatch(r"epoch: +\d+    loss: \d+\.\d{5}    time:.+", ln)
               for ln in epochs)
    last = port_ckpt.load_checkpoint(os.path.join(result.run_dir, "lastepoch.ckpt"))
    assert last["epoch"] == 1 and last["steps"] == 10
    assert last["opt_state"]["count"] == 10
    assert last["metric"] == pytest.approx(result.best_loss)
    assert set(last["ema_params"]) == set(last["params"])


def test_bestloss_pkl_loads_through_the_reference_names(trained):
    """bestloss.pkl is a reference torch state_dict: the JAX package's
    bridge reads it into its parameter tree, equal to the port's params."""
    _, cfg, result = trained
    path = os.path.join(result.run_dir, "bestloss.pkl")
    tree = jax_ckpt.load_torch_pkl(path, cfg.patch_size)
    back = state_dict_from_flax(tree, cfg.patch_size)
    best = port_ckpt.load_checkpoint(os.path.join(result.run_dir, "bestloss.ckpt"))
    assert back.keys() == best.keys()
    for k in back:
        torch.testing.assert_close(back[k], best[k], rtol=0, atol=0)


def test_trainer_resume_restores_step_lr_and_best(trained, synthetic_image_dir, monkeypatch):
    base, cfg, result = trained
    last = port_ckpt.load_checkpoint(os.path.join(result.run_dir, "lastepoch.ckpt"))
    seen = []
    real = port_step.apply_gradients

    def spy(state, grads):  # the schedule position each update reads
        seen.append((state.step, state.learning_rate(), state.total_steps))
        real(state, grads)

    monkeypatch.setattr(port_step, "apply_gradients", spy)
    resume = dataclasses.replace(cfg, epoch=(0, 3), resume=os.path.join(
        result.run_dir, "lastepoch.ckpt"))
    r2 = port_trainer.run(resume, base, log_every=2, device="cpu")
    assert r2.steps == 15  # resumed at epoch 2: 5 more steps on the restored 10
    assert seen[0][0] == 10
    assert seen[0][1] == pytest.approx(cfg.lr * 0.5 * (1 + math.cos(math.pi * 10 / 15)))
    log = open(os.path.join(r2.run_dir, "train.log")).read()
    assert f"recovering best_loss {last['metric']:4f}" in log
    assert "resuming from epoch        2 of" in log and "epoch:    2" in log
    first = [ln for ln in log.splitlines() if ln.startswith("steps:")][5]
    # the EMA loss resumes from the saved one, not from 5.0
    assert float(first.split()[3]) < float(last["loss_rec"]) + 0.5


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, synthetic_image_dir):
    """Each step's generator comes from (seed, step) (``step.step_generator``,
    JAX's ``fold_in(rng, state.step)``): two epochs straight, and the same
    run stopped after its first epoch (``max_steps``; the cosine schedule
    keeps its two-epoch length) then resumed to the second, leave the same
    parameters, moments, EMA loss and validation losses bit for bit, with
    every drop rate at the trainer's 0.1."""
    cfg = _tiny_config(synthetic_image_dir)  # epochs (0, 2) of 5 steps
    straight = port_trainer.run(cfg, str(tmp_path / "a"), log_every=2, device="cpu")
    first = port_trainer.run(cfg, str(tmp_path / "b"), max_steps=5, log_every=2,
                             device="cpu")
    resumed = port_trainer.run(
        dataclasses.replace(cfg, resume=os.path.join(first.run_dir, "lastepoch.ckpt")),
        str(tmp_path / "b"), log_every=2, device="cpu")
    assert resumed.steps == straight.steps == 10
    assert resumed.last_val_loss == straight.last_val_loss
    assert resumed.best_loss == straight.best_loss
    a, b = (port_ckpt.load_checkpoint(os.path.join(r.run_dir, "lastepoch.ckpt"))
            for r in (straight, resumed))
    assert a["loss_rec"] == b["loss_rec"] and a["metric"] == b["metric"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for which in ("mu", "nu"):
        for name in a["opt_state"][which]:
            assert torch.equal(a["opt_state"][which][name], b["opt_state"][which][name])


def test_step_generators_fold_the_step_and_the_data_rank():
    """Distinct streams per step and per data coordinate, each reproducible."""
    draw = lambda *a: torch.rand(4, generator=port_step.step_generator(7, *a)).tolist()  # noqa: E731
    assert draw(3, "cpu") == draw(3, "cpu")
    assert len({tuple(draw(s, "cpu", d)) for s in (0, 1) for d in (None, 0, 1)}) == 6


def test_torchrun_world_counts_every_hosts_devices(monkeypatch, synthetic_image_dir):
    """Under torchrun a run spans its ``WORLD_SIZE`` (every host's cards, as
    JAX counts ``jax.devices()``), not this host's: a launch of 2 hosts × 8
    cards takes ``mesh: {data: 16}`` and ``num_gpus: 16`` unclamped, and a
    larger mesh is JAX's error against the world. Spawned, the count is this
    host's cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cuda = torch.device("cuda")
    shape = lambda **kw: port_trainer._mesh_shape(  # noqa: E731
        _tiny_config(synthetic_image_dir, **kw), cuda, None)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "16")
    assert shape(mesh={"data": 16})[0] == {"data": 16}
    got, cfg = shape(num_devices=16)
    assert got == {"data": 16} and cfg.num_devices == 16
    with pytest.raises(ValueError, match=r"needs 32 devices, only 16 visible"):
        shape(mesh={"data": 32})
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match=r"needs 16 devices, only 8 visible"):
        shape(mesh={"data": 16})
    got, cfg = shape(num_devices=16)
    assert got == {"data": 8} and cfg.num_devices == 8


def test_warm_start_refuses_a_mismatched_pkl(trained, synthetic_image_dir):
    base, cfg, _ = trained
    bigger = dataclasses.replace(cfg, depth=2, framework="other")
    with pytest.raises(ValueError, match="does not match this model config"):
        port_trainer.run(bigger, base, log_every=2, device="cpu")


# the expert axis landed with JAX's checks: an expert axis needs num_experts
# set and divisible by it, and the pipeline refuses a seq axis under MoE;
# flash_blocks and steps_per_dispatch landed and train (a dispatch of 2
# steps runs to max_steps=2)
@pytest.mark.parametrize("later,exc,match", [
    (dict(mesh={"expert": 2}), ValueError, r"needs num_experts \(got 1\) set"),
    (dict(mesh={"pipe": 2, "expert": 2}, num_experts=3), ValueError,
     r"needs num_experts \(got 3\) set and divisible"),
    (dict(flash_blocks=(512, 1024)), None, None),
    (dict(steps_per_dispatch=2), None, None),
    (dict(num_experts=2, mesh={"pipe": 1, "seq": 1, "expert": 1}), None, None),
])
def test_trainer_refuses_later_options(tmp_path, synthetic_image_dir, later, exc, match):
    cfg = _tiny_config(synthetic_image_dir, **later)
    if exc is None:  # trains
        n = cfg.steps_per_dispatch
        assert port_trainer.run(cfg, str(tmp_path), max_steps=n, device="cpu").steps == n
        return
    with pytest.raises(exc, match=match):
        port_trainer.run(cfg, str(tmp_path), device="cpu")


# --------------------------------------------- profile_steps and nan_checks


def _flash_training(monkeypatch):
    """Build the trainer's model with attention dropout 0 (the config has no
    key for it), so a training step runs the flash path and its scopes."""
    monkeypatch.setattr(port_trainer, "DiffusionViT",
                        functools.partial(PortViT, attn_drop_rate=0.0))


def _checks_released():
    """No profiler, nan-check hook or anomaly mode outlives a run."""
    from torch.nn.modules import module as nn_module

    from ddim_cold_torch.utils import profiling

    assert not torch.autograd._profiler_enabled()
    assert not profiling._ACTIVE and not profiling._NAN
    assert not torch.is_anomaly_enabled()
    assert not nn_module._global_forward_hooks


def test_profile_steps_writes_a_trace_attrib_reads(tmp_path, synthetic_image_dir,
                                                   monkeypatch):
    """profile_steps=2 traces exactly the first two of three steps into
    <run_dir>/trace: ``obs.attrib`` loads it, and its flash scopes hold
    depth × 2 ranges each (one forward and one backward a layer a step)."""
    from ddim_cold_torch.obs import attrib

    _flash_training(monkeypatch)
    cfg = _tiny_config(synthetic_image_dir, profile_steps=2)
    result = port_trainer.run(cfg, str(tmp_path), max_steps=3, log_every=100,
                              device="cpu")
    assert result.steps == 3
    _checks_released()
    trace = attrib.load_trace(os.path.join(result.run_dir, "trace"))
    counts: dict = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev["name"] in attrib.REGISTERED_SCOPES:
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    two_steps = cfg.depth * 2
    assert counts == {"flash_attention/fwd": two_steps, "flash_attention/dq": two_steps,
                      "flash_attention/dkv": two_steps}
    report = attrib.attribute(trace)  # a CPU capture has no device lanes
    assert report["device_lanes"] == 0 and report["coverage"] is None


def test_nan_checks_runs_clean_and_raises_on_nan(tmp_path, synthetic_image_dir,
                                                 monkeypatch):
    """nan_checks: a clean run trains as without it (no false positive, the
    same loss); a NaN in one weight (through the warm start) raises
    FloatingPointError naming the module whose output it reached; the
    checks are off again after either run."""
    _flash_training(monkeypatch)
    losses = []
    for nan_checks in (False, True):
        cfg = _tiny_config(synthetic_image_dir, nan_checks=nan_checks)
        result = port_trainer.run(cfg, str(tmp_path / str(nan_checks)), max_steps=2,
                                  log_every=2, device="cpu")
        _checks_released()
        log = open(os.path.join(result.run_dir, "train.log")).read()
        losses.append(([ln.split()[3] for ln in log.splitlines()
                        if ln.startswith("steps:")], result.last_val_loss))
        assert math.isfinite(result.last_val_loss)
    assert losses[0] == losses[1] and losses[0][0]

    cfg = _tiny_config(synthetic_image_dir, nan_checks=True, initializing="nan.pkl")
    sd = port_trainer.build_model(cfg, device="cpu").state_dict()
    sd["blocks.0.mlp.fc1.weight"][3, 5] = float("nan")
    os.makedirs(tmp_path / "nan" / "Saved_Models")
    port_ckpt.save_torch_pkl(sd, str(tmp_path / "nan" / "Saved_Models" / "nan.pkl"))
    with pytest.raises(FloatingPointError, match=r"'blocks\.0\.mlp'"):
        port_trainer.run(cfg, str(tmp_path / "nan"), max_steps=2, device="cpu")
    _checks_released()
