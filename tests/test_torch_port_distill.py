"""The port's progressive distillation against the JAX package's
``train/distill.py``, on the CPU.

* ``DistillConfig``: every refusal's message equal to JAX's, and
  ``round_steps`` equal, over valid and invalid halving chains, variants,
  cold level counts and sizes.
* One step of each variant (``ddim`` with an EMA shadow, ``cold``) on a
  TINY flash model whose weights are carried over from JAX: the port is fed
  the positions j and the noise ε that JAX's step draws from the same key
  (redrawn here; the two RNGs differ), through a monkeypatched
  ``distill.draw``. JAX's side runs its Pallas flash kernels (forward and
  backward) in interpret mode, the port's side their plain versions.
  Tolerances, as for the training step (tests/test_torch_port_train.py):
  loss and loss record rtol 1e-5; student params and EMA atol 3e-3·lr +
  rtol 1e-5 (one Adam step moves each parameter by about lr·g/(|g|+ε), so
  gradients that agree to ~1e-5 relative give updates within a small part
  of lr).
* ``distill`` at TINY: the loss falls in both rounds; a run interrupted in
  its second round restarts by restoring the finished first round from
  ``student_k2/`` and resuming ``live/`` at its iteration, and ends bit for
  bit where the uninterrupted run ends (each iteration's randomness is
  keyed by (seed, steps, iteration)); the k=1 student serves through
  ``ddim_sample_fewstep``; without CUDA it raises unless told the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.train import distill as port_distill
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.train import distill as jax_distill

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4,
            total_steps=2000)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)


@pytest.mark.parametrize("kw", [
    dict(start_steps=4, target_steps=3), dict(start_steps=6, target_steps=1),
    dict(start_steps=1, target_steps=2), dict(target_steps=0),
    dict(variant="sde"), dict(start_steps=4, target_steps=1, variant="cold",
                              cold_levels=6),
    dict(start_steps=2, target_steps=1, variant="cold", cold_levels=6),
    dict(iters=0), dict(batch_size=0)])
def test_distill_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_distill.DistillConfig(**kw)
    with pytest.raises(ValueError) as got:
        port_distill.DistillConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, dict(start_steps=8, target_steps=2), dict(start_steps=1),
    dict(start_steps=16, target_steps=1, variant="cold", cold_levels=32),
    dict(start_steps=3, target_steps=3)])
def test_distill_config_round_steps_match_jax(kw):
    got, want = port_distill.DistillConfig(**kw), jax_distill.DistillConfig(**kw)
    assert got.round_steps() == want.round_steps()
    assert all(getattr(got, f) == getattr(want, f)
               for f in want.__dataclass_fields__)


@pytest.fixture(scope="module")
def teacher():
    jmodel = DiffusionViT(**TINY, **NO_DROP, use_flash=True)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                                        jnp.zeros((2,), jnp.int32))["params"])
    pmodel = PortViT(**TINY, **NO_DROP, use_flash=True, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, 4), strict=True)
    return jmodel, params, pmodel


@pytest.mark.parametrize("variant,levels,ema", [("ddim", 6, 0.5), ("cold", 4, 0.0)])
def test_distill_step_matches_jax(teacher, monkeypatch, variant, levels, ema):
    jmodel, params, pmodel = teacher
    lr, steps = 1e-2, 2
    x0 = np.random.RandomState(7).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    rj, re = jax.random.split(rng)  # what JAX's step draws from rng
    j = np.asarray(jax.random.randint(rj, (4,), 0, steps))
    eps = np.asarray(jax.random.normal(re, x0.shape, jnp.float32))
    assert len(set(j.tolist())) == steps  # both positions, the final jump included
    monkeypatch.setattr(port_distill, "draw", lambda x, g, s, v: (
        torch.from_numpy(j.copy()).long(),
        torch.from_numpy(eps.copy()) if v == "ddim" else None))

    jstate = jax_distill.make_student_state(jmodel, params, lr, 10, ema)
    jstep = jax_distill.make_distill_step(jmodel, steps=steps, variant=variant,
                                          cold_levels=levels, ema_decay=ema)
    jstate, jloss, jrec = jstep(jstate, params, jnp.asarray(x0), rng, jnp.float32(0.5))
    pstate = port_distill.make_student_state(pmodel, lr, 10, ema)
    pstep = port_distill.make_distill_step(pmodel, steps=steps, variant=variant,
                                           cold_levels=levels, ema_decay=ema)
    pstate, ploss, prec = pstep(pstate, pmodel, torch.from_numpy(x0), torch.Generator(),
                                torch.tensor(0.5))
    assert float(jloss) > 0.0
    assert ploss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert prec.item() == pytest.approx(float(jrec), rel=1e-5)
    assert pstate.step == 1
    trees = [(jstate.params, pstate.params)]
    if ema:
        trees.append((jstate.ema_params, pstate.ema_params))
    for jtree, tensors in trees:
        want = state_dict_from_flax(jax.device_get(jtree), 4)
        for name, got in zip(pstate.names, tensors):
            np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=3e-3 * lr, err_msg=name)
    # the student moved away from the teacher it started as
    moved = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                zip(pstate.params, pmodel.parameters()))
    assert moved > 0.5 * lr


def test_distill_step_keeps_the_teacher(teacher):
    pmodel = teacher[2]
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    state = port_distill.make_student_state(pmodel, 1e-2, 4)
    step = port_distill.make_distill_step(pmodel, steps=2)
    x0 = port_distill.synthetic_batch(torch.Generator().manual_seed(1), 4, (16, 16), 3)
    assert x0.shape == (4, 16, 16, 3) and float(x0.abs().max()) <= 1.0
    step(state, pmodel, x0, torch.Generator().manual_seed(2), torch.tensor(0.0))
    assert all(torch.equal(before[k], v) for k, v in pmodel.state_dict().items())
    assert state.model is not pmodel


def _config(tmp_path, **kw):
    return port_distill.DistillConfig(**{**dict(
        start_steps=2, target_steps=1, iters=4, batch_size=2, lr=1e-3, log_every=2,
        save_every=2, checkpoint_dir=str(tmp_path), seed=5), **kw})


def test_distill_restores_a_finished_round_and_resumes_live(teacher, tmp_path):
    pmodel = teacher[2]
    full = port_distill.distill(pmodel, _config(tmp_path / "a"), device="cpu")
    assert set(full["students"]) == {2, 1} and full["final_steps"] == 1
    assert all(len(h) == 2 for h in full["history"].values())

    calls = []

    class Interrupted(Exception):
        pass

    def interrupted(generator):
        calls.append(1)
        if len(calls) == 7:  # round k=1, iteration 2: after its live save
            raise Interrupted
        return port_distill.synthetic_batch(generator, 2, (16, 16), 3)

    cfg = _config(tmp_path / "b")
    with pytest.raises(Interrupted):
        port_distill.distill(pmodel, cfg, batches=interrupted, device="cpu")
    assert (tmp_path / "b" / "student_k2" / port_distill.ROUND_FILE).is_file()
    assert not (tmp_path / "b" / "student_k1").exists()
    log = tmp_path / "b.log"
    again = port_distill.distill(pmodel, cfg, log=str(log), device="cpu")
    text = log.read_text()
    assert "(k=2): restored finished student" in text
    assert "(k=1): resumed at iter 2" in text
    assert again["history"][2] == [] and len(again["history"][1]) == 1
    for steps in (2, 1):
        a, b = full["students"][steps], again["students"][steps]
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), steps
    # the k=1 student serves through the few-step sampler
    student = pmodel.clone()
    student.load_state_dict(again["students"][1], strict=True)
    img = port_sampling.ddim_sample_fewstep(student, torch.Generator().manual_seed(0),
                                            steps=1, n=2, device="cpu")
    assert img.shape == (2, 16, 16, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("variant,levels", [("ddim", 6), ("cold", 4)])
def test_distill_loss_falls(teacher, variant, levels):
    pmodel = teacher[2]
    cfg = port_distill.DistillConfig(start_steps=2, target_steps=1, iters=12, batch_size=4,
                                     lr=1e-3, variant=variant, cold_levels=levels,
                                     log_every=3, seed=3)
    out = port_distill.distill(pmodel, cfg, device="cpu")
    for steps, losses in out["history"].items():
        assert len(losses) == 4 and all(np.isfinite(losses))
        assert losses[-1] < losses[0], (steps, losses)


def test_distill_needs_cuda_unless_told(teacher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_distill.distill(teacher[2], port_distill.DistillConfig(iters=1))
