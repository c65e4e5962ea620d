"""The port's few-step and cold samplers, its slerp interpolation and their
schedule tables, against the JAX package's.

One JAX model at the TINY geometry (16px, patch 4, C=32, depth 2, 4 heads)
is initialised and its parameter tree carried into the port by
``state_dict_from_flax``; both packages then see the same numpy inputs, the
starts passed from the JAX side (the two RNGs differ). JAX runs on the CPU
at float32 matmul precision (tests/conftest.py), its flash path through the
Pallas kernel in interpret mode. Tolerances: the schedule tables and index
tables bit-equal; samplers atol 1e-4 over their 1-4 steps (as in
tests/test_torch_port_model.py); slerp atol 1e-5 (float32 trigonometry of
two libraries). Port-only identities (a 1×1 super-resolution is
``cold_sample``; a direct call equals its composition) hold bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import degrade as port_degrade
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.ops import schedule as port_schedule
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_torch.workloads import tasks as port_tasks
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import degrade, sampling, schedule

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = DiffusionViT(**TINY, use_flash=True)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
        jnp.zeros((2,), jnp.int32))["params"])
    pmodel = PortViT(**TINY, use_flash=True, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]), strict=True)
    return jmodel, params, pmodel


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("levels", [1, 3, 6, 7])
def test_cold_time_sequence_matches_jax(levels):
    got, want = port_schedule.cold_time_sequence(levels), schedule.cold_time_sequence(levels)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("T,steps,t_start,eta", [
    (2000, 1, None, 0.0), (2000, 2, None, 0.0), (2000, 4, None, 0.0),
    (2000, 4, 1800, 0.0), (1000, 3, 501, 0.0), (2000, 4, None, 0.7),
    (50, 8, 9, 1.0)])
def test_fewstep_tables_match_jax(T, steps, t_start, eta):
    seq = port_schedule.fewstep_time_sequence(T, steps, t_start)
    want_seq = schedule.fewstep_time_sequence(T, steps, t_start)
    assert seq.dtype == want_seq.dtype and seq.tobytes() == want_seq.tobytes()
    got = port_schedule.fewstep_coefficients(T, steps, t_start, eta)
    want = schedule.fewstep_coefficients(T, steps, t_start, eta)
    for name in ("t_seq", "cx", "cx0", "cz"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("T,steps,t_start", [(2000, 0, None), (2000, 4, 0),
                                             (2000, 4, 2000), (2000, 8, 5)])
def test_fewstep_schedule_errors_match_jax(T, steps, t_start):
    with pytest.raises(ValueError) as want:
        schedule.fewstep_time_sequence(T, steps, t_start)
    with pytest.raises(ValueError) as got:
        port_schedule.fewstep_time_sequence(T, steps, t_start)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,size", [((2, 4, 4, 3), 16), ((1, 1, 1, 3), 16),
                                        ((5, 3, 3), 16), ((1, 25, 25, 3), 200)])
def test_upsample_nearest_matches_jax(shape, size):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    got = port_degrade.upsample_nearest(x, size)
    want = np.asarray(degrade.upsample_nearest(x, size))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ cold


def test_cold_sample_default_init_matches_jax(models):
    """JAX's default start (one N(0, 1) colour per sample, broadcast) given
    to the port as x_init: the last frame and the whole trajectory."""
    jmodel, params, pmodel = models
    rng = jax.random.PRNGKey(4)
    color = np.asarray(jax.random.normal(rng, (2, 1, 1, 3), jnp.float32))
    x = np.broadcast_to(color, (2, 16, 16, 3)).copy()
    want = sampling.cold_sample(jmodel, params, rng, n=2, levels=3)
    _close(port_sampling.cold_sample(pmodel, x_init=x, levels=3, device="cpu"), want)
    seq = port_sampling.cold_sample(pmodel, x_init=x, levels=3, return_sequence=True,
                                    device="cpu")
    want_seq = sampling.cold_sample(jmodel, params, rng, n=2, levels=3,
                                    return_sequence=True)
    assert seq.shape == (4, 2, 16, 16, 3)
    _close(seq, want_seq)
    np.testing.assert_array_equal(seq[0].numpy(), (x + 1.0) / 2.0)


def test_cold_sample_guided_start_matches_jax(models):
    jmodel, params, pmodel = models
    x = np.random.RandomState(5).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    keep = x.copy()
    got = port_sampling.cold_sample(pmodel, x_init=x, levels=2, device="cpu")
    _close(got, sampling.cold_sample(jmodel, params, x_init=jnp.asarray(x), levels=2))
    np.testing.assert_array_equal(x, keep)  # the caller's start survives


def test_cold_sample_fresh_start_is_a_broadcast_colour(models):
    pmodel = models[2]
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    x = port_sampling.cold_init(pmodel, gen(), 3, "cpu")
    assert x.shape == (3, 16, 16, 3) and bool((x == x[:, :1, :1]).all())
    torch.testing.assert_close(
        port_sampling.cold_sample(pmodel, gen(), n=3, levels=2, device="cpu"),
        port_sampling.cold_sample(pmodel, x_init=x, levels=2, device="cpu"),
        rtol=0, atol=0)


@pytest.mark.parametrize("level", [2, 3])
def test_super_resolve_matches_jax(models, level):
    jmodel, params, pmodel = models
    low = np.random.RandomState(level).uniform(-1, 1, (2, 16 >> level, 16 >> level, 3))
    low = low.astype(np.float32)
    from ddim_cold_tpu import workloads

    want = workloads.super_resolve(jmodel, params, low, level=level)
    _close(port_tasks.super_resolve(pmodel, low, level=level, device="cpu"), want)


def test_super_resolve_of_one_pixel_is_cold_sample(models):
    """A 1×1 input at the full level count is ``cold_sample`` bit for bit:
    its upsampling is the broadcast colour start."""
    pmodel = models[2]
    color = port_sampling.cold_init(pmodel, torch.Generator().manual_seed(2), 2, "cpu")
    got = port_tasks.super_resolve(pmodel, color[:, :1, :1], level=4, device="cpu")
    want = port_sampling.cold_sample(pmodel, torch.Generator().manual_seed(2), n=2,
                                     levels=4, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------- few-step


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_fewstep_matches_jax(models, steps):
    jmodel, params, pmodel = models
    x = np.random.RandomState(10 + steps).randn(2, 16, 16, 3).astype(np.float32)
    got = port_sampling.ddim_sample_fewstep(pmodel, x_init=x, steps=steps, device="cpu")
    want = sampling.ddim_sample_fewstep(jmodel, params, x_init=jnp.asarray(x), steps=steps)
    assert got.shape == (2, 16, 16, 3)
    _close(got, want)
    seq = port_sampling.ddim_sample_fewstep(pmodel, x_init=x, steps=steps, t_start=1500,
                                            return_sequence=True, device="cpu")
    want_seq = sampling.ddim_sample_fewstep(jmodel, params, x_init=jnp.asarray(x),
                                            steps=steps, t_start=1500,
                                            return_sequence=True)
    assert seq.shape == (steps + 1, 2, 16, 16, 3)
    _close(seq, want_seq)


def test_fewstep_fresh_start_and_eta_streams(models):
    pmodel = models[2]
    run = lambda seed, **kw: port_sampling.ddim_sample_fewstep(  # noqa: E731
        pmodel, torch.Generator().manual_seed(seed), steps=2, n=2, device="cpu", **kw)
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    torch.testing.assert_close(run(0, eta=0.5), run(0, eta=0.5), rtol=0, atol=0)
    assert not torch.equal(run(0, eta=0.5), run(0))
    assert not torch.equal(run(0), run(1))
    # the start is the plain sampler's fresh start of the same seed
    start = port_sampling.fresh_start(pmodel, torch.Generator().manual_seed(0), 2, "cpu")
    torch.testing.assert_close(run(0), port_sampling.ddim_sample_fewstep(
        pmodel, x_init=start, steps=2, device="cpu"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        port_sampling.ddim_sample_fewstep(pmodel, x_init=start, steps=2, eta=0.5,
                                          device="cpu")


def test_fold_in_streams_are_reproducible_and_distinct():
    g = torch.Generator().manual_seed(7)
    draw = lambda gen: torch.randn(4, generator=gen)  # noqa: E731
    a, b = port_sampling.fold_in(g, 1), port_sampling.fold_in(g, 1)
    torch.testing.assert_close(draw(a), draw(b), rtol=0, atol=0)
    assert not torch.equal(draw(port_sampling.fold_in(g, 1)),
                           draw(port_sampling.fold_in(g, 2)))
    assert not torch.equal(draw(port_sampling.fold_in(g, 1)),
                           draw(torch.Generator().manual_seed(7)))
    assert g.initial_seed() == 7


@pytest.mark.parametrize("fn,kw", [
    ("cold_sample", dict(levels=3)), ("ddim_sample_fewstep", dict(steps=3))])
@pytest.mark.parametrize("options", [
    dict(cache_interval=2), dict(cache_interval=2, cache_mode="token", cache_tokens=9)])
def test_cached_cold_and_fewstep_match_jax(models, fn, kw, options):
    """The step-cache options this slice refused before, run: the cached
    cold and few-step samplers against JAX's from JAX's start."""
    jmodel, params, pmodel = models
    x = np.random.RandomState(21).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = getattr(sampling, fn)(jmodel, params, x_init=jnp.asarray(x), **kw, **options)
    got = getattr(port_sampling, fn)(pmodel, x_init=x, device="cpu", **kw, **options)
    assert got.shape == want.shape
    _close(got, want)


# ---------------------------------------------------------- interpolation


def _endpoints(seed=20):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-1, 1, (16, 16, 3)).astype(np.float32) for _ in range(2)]


def test_slerp_of_jax_noisy_pair_matches_jax():
    """JAX's encoded pair, mixed by both packages' slerp at 5 fractions."""
    a, b = _endpoints()
    noisy = np.array(sampling.forward_noise(jax.random.PRNGKey(1),
                                              jnp.stack([a, b]), 1500))
    frac = np.linspace(0, 1, 5, dtype=np.float32).reshape(-1, 1, 1, 1, 1)
    got = port_sampling.slerp(torch.from_numpy(noisy[0][None]),
                              torch.from_numpy(noisy[1][None]), torch.from_numpy(frac))
    want = sampling.slerp(jnp.asarray(noisy[0][None]), jnp.asarray(noisy[1][None]),
                          jnp.asarray(frac))
    assert got.shape == (5, 1, 16, 16, 3)
    _close(got, want, atol=1e-5)
    _close(got[0, 0], noisy[0], atol=1e-5)
    _close(got[-1, 0], noisy[1], atol=1e-5)


def test_slerp_parallel_endpoints_fall_back_to_lerp():
    a = torch.from_numpy(_endpoints()[0])[None]
    frac = torch.tensor([0.0, 0.25, 1.0]).reshape(-1, 1, 1, 1, 1)
    got = port_sampling.slerp(a, 2.0 * a, frac)
    want = sampling.slerp(jnp.asarray(a.numpy()), 2.0 * jnp.asarray(a.numpy()),
                          jnp.asarray(frac.numpy()))
    assert bool(torch.isfinite(got).all())
    _close(got, want, atol=1e-5)
    torch.testing.assert_close(got[1], 1.25 * a, rtol=0, atol=1e-6)


def test_interp_states_is_slerp_of_one_encoding_draw():
    a, b = _endpoints(21)
    got = port_sampling.interp_states(torch.Generator().manual_seed(3), a, b, 4, 1500)
    noisy = port_sampling.forward_noise(torch.Generator().manual_seed(3),
                                        torch.from_numpy(np.stack([a, b])), 1500)
    frac = torch.linspace(0, 1, 4).reshape(-1, 1, 1, 1, 1)
    want = port_sampling.slerp(noisy[:1], noisy[1:], frac)[:, 0]
    assert got.shape == (4, 16, 16, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sample_from_jax_interp_states_matches_jax(models):
    """JAX's slerp-mixed encodings decoded by both packages' sample_from,
    last frame and trajectory: the decode half of ``slerp_interpolate``."""
    jmodel, params, pmodel = models
    a, b = _endpoints(22)
    mixed = np.asarray(sampling.interp_states(jax.random.PRNGKey(5), jnp.asarray(a),
                                              jnp.asarray(b), 3, 1500))
    want = sampling.sample_from(jmodel, params, jnp.asarray(mixed), 1500, k=500)
    _close(port_sampling.sample_from(pmodel, mixed, 1500, k=500, device="cpu"), want)
    want_seq = sampling.sample_from(jmodel, params, jnp.asarray(mixed), 1500, k=500,
                                    return_sequence=True)
    got_seq = port_sampling.sample_from(pmodel, mixed, 1500, k=500,
                                        return_sequence=True, device="cpu")
    assert got_seq.shape == (4, 3, 16, 16, 3)
    _close(got_seq, want_seq)


def test_slerp_interpolate_decodes_interp_states(models):
    pmodel = models[2]
    a, b = _endpoints(23)
    got = port_sampling.slerp_interpolate(pmodel, torch.Generator().manual_seed(6), a, b,
                                          n_interp=3, t_start=1500, k=500, device="cpu")
    mixed = port_sampling.interp_states(torch.Generator().manual_seed(6), a, b, 3, 1500)
    want = port_sampling.sample_from(pmodel, mixed, 1500, k=500, device="cpu")
    assert got.shape == (3, 16, 16, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # η > 0 decodes from fold_in(generator, 1): reproducible, and not η = 0
    noisy = [port_sampling.slerp_interpolate(pmodel, torch.Generator().manual_seed(6), a, b,
                                             n_interp=3, t_start=1500, k=500, eta=1.0,
                                             device="cpu") for _ in range(2)]
    torch.testing.assert_close(noisy[0], noisy[1], rtol=0, atol=0)
    assert not torch.equal(noisy[0], got)
