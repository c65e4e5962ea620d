"""The port's FID statistics, extractor and quality guards against the JAX
package's ``eval/fid.py`` and ``eval/inception.py``, on the CPU.

* Statistics: ``ActivationStats`` (chunked updates, merge, mean, cov),
  ``trace_sqrt_product`` and ``frechet_distance`` on seeded numpy inputs,
  equal to JAX's to 1e-10 relative (both float64 numpy; the port's copy
  runs the same operations).
* The resize: ``resize_bilinear`` against ``jax.image.resize(...,
  "bilinear")`` upsampling 16→299 and 200→299 and downsampling 400→299
  (antialiased), to 1e-5; one axis up and one down, 64×320→299, to 2e-5.
* The extractor: JAX's seeded random-init proxy ``init_variables(
  PRNGKey(0))`` carried over by ``inception_state_dict_from_flax`` loads
  with ``strict=True``; its features on 2 seeded 299×299 images match
  JAX's within JAX's own parity tolerance, rtol 2e-3 and atol 2e-4
  (tests/test_inception_parity.py:232). One JAX extractor is built and
  compiled for the module; the file runs three 299×299 forwards of 2
  images in all.
* The guards, on TINY (16 px) models with random weights ×3 (so the
  streams differ visibly; the dense route: no kernel is under test here),
  ``n_samples`` 2, ``sample_batch`` 2, k=500 (4 steps), both packages'
  guards extracting the same seeded 64-dim projection (``PROJ``, through
  monkeypatched ``make_feature_fn``s: a 2048-dim distance costs seconds of
  ``eigh`` and six test workers share the CPU): the port is fed
  JAX's per-batch start ``normal(sub, (2, 16, 16, 3))`` (and, for inpaint,
  JAX's known batch) through monkeypatched ``sampling.fresh_start`` /
  ``fid.inpaint_known``, since the two RNGs differ. Reports: every
  configuration key equal, ``max_abs_pixel_delta`` within 1e-4 (images
  agree to ~1e-6 over 4 steps, as in the sampler tests), the Fréchet
  distance (0.016–0.62 here) within 1e-3 relative plus 2e-4 absolute: two
  reports rounded to 4 decimals may straddle a rounding boundary, and the
  features agree to ~1e-6 relative; the calibrated worst layer the same.
* ``cache_interval=1`` reads exactly 0, end to end on the default
  extractor; ``compute_fid`` keeps ``n_samples`` rows of full batches; the
  superres guard is bit-exact on
  projected outputs, false on a swapped row, and equals JAX's report; the
  entry points raise without CUDA unless ``device="cpu"`` is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.eval import fid as port_fid
from ddim_cold_torch.eval import inception as port_inception
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_torch.workloads import tasks as port_tasks
from ddim_cold_tpu.eval import fid as jax_fid
from ddim_cold_tpu.eval import inception as jax_inception
from ddim_cold_tpu.models import DiffusionViT

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4,
            total_steps=2000)
GAIN = 3.0
K = 500
FID_RTOL, FID_ATOL, DELTA_ATOL = 1e-3, 2e-4, 1e-4


# ------------------------------------------------------------ statistics


def _psd(rs, d):
    a = rs.randn(d, d)
    return a @ a.T + 0.1 * np.eye(d)


@pytest.mark.parametrize("d", [12, 64])
def test_activation_stats_match_jax(d):
    x = np.random.RandomState(d).randn(333, d).astype(np.float32)
    got, want = port_fid.ActivationStats(d), jax_fid.ActivationStats(d)
    for chunk in np.array_split(x, 7):
        got.update(chunk)
        want.update(chunk)
    got.update(torch.from_numpy(x[:5]))  # a tensor batch takes the same path
    want.update(x[:5])
    assert got.count == want.count
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-10, atol=1e-12)
    a, b = port_fid.ActivationStats(d), port_fid.ActivationStats(d)
    a.update(x[:100])
    b.update(x[100:])
    ja, jb = jax_fid.ActivationStats(d), jax_fid.ActivationStats(d)
    ja.update(x[:100])
    jb.update(x[100:])
    np.testing.assert_allclose(a.merge(b).cov, ja.merge(jb).cov, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="expected"):
        got.update(x[:, :-1])


@pytest.mark.parametrize("d", [8, 48])
def test_frechet_math_matches_jax(d):
    rs = np.random.RandomState(100 + d)
    s1, s2 = _psd(rs, d), _psd(rs, d)
    mu1, mu2 = rs.randn(d), rs.randn(d)
    assert port_fid.trace_sqrt_product(s1, s2) == pytest.approx(
        jax_fid.trace_sqrt_product(s1, s2), rel=1e-10)
    assert port_fid.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(
        jax_fid.frechet_distance(mu1, s1, mu2, s2), rel=1e-10)
    a, b = port_fid.ActivationStats(d), port_fid.ActivationStats(d)
    ja, jb = jax_fid.ActivationStats(d), jax_fid.ActivationStats(d)
    for acc, jacc, shift in ((a, ja, 0.0), (b, jb, 0.5)):
        feats = rs.randn(200, d) + shift
        acc.update(feats)
        jacc.update(feats)
    assert port_fid.fid_from_stats(a, b) == pytest.approx(
        jax_fid.fid_from_stats(ja, jb), rel=1e-10)


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("shape,atol", [((2, 16, 16, 3), 1e-5), ((1, 200, 200, 3), 1e-5),
                                        ((1, 400, 400, 3), 1e-5),
                                        ((1, 64, 320, 3), 2e-5)])
def test_resize_matches_jax_image_resize(shape, atol):
    """The mixed case (64 up, 320 down to 299) sits within 2e-5: at so mild
    a shrink the two libraries' float32 antialiasing weights, computed by
    different formulas, differ by up to 1.2e-5."""
    x = np.random.RandomState(shape[1]).rand(*shape).astype(np.float32)
    got = port_fid.resize_bilinear(torch.from_numpy(x), 299).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], 299, 299, 3),
                                       method="bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ------------------------------------------------------------- extractor


@pytest.fixture(scope="module")
def extractor():
    """JAX's seeded proxy extractor, compiled once for (2, 299, 299, 3)
    batches, and its variables carried into the port."""
    model, variables = jax_inception.init_variables(jax.random.PRNGKey(0))
    jax_fn, _ = jax_fid.make_feature_fn(model, variables)
    sd = port_inception.inception_state_dict_from_flax(jax.device_get(variables))
    return jax_fn, sd


def test_extractor_carried_over_matches_jax(extractor, tmp_path):
    jax_fn, sd = extractor
    net = port_inception.InceptionV3Features()
    net.load_state_dict(sd, strict=True)
    x = np.random.RandomState(0).rand(2, 299, 299, 3).astype(np.float32)
    want = np.asarray(jax_fn(jnp.asarray(x)))
    fn, dim = port_fid.make_feature_fn(variables=sd, device="cpu")
    got = fn(x).numpy()
    assert dim == port_inception.FEATURE_DIM == 2048 and got.shape == (2, 2048)
    assert got.std() > 0.05  # the √2 gain keeps the features from collapsing
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    # a torchvision-layout file: the aux head and classifier are dropped,
    # the rest loads strict
    path = tmp_path / "inception.pth"
    torch.save({**sd, "fc.weight": torch.zeros(1000, 2048),
                "AuxLogits.conv0.conv.weight": torch.zeros(1)}, path)
    _, loaded = port_inception.load_torch_inception(str(path))
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    torch.save({k: v for k, v in sd.items() if not k.startswith("Mixed_7c")}, path)
    with pytest.raises(ValueError, match="Mixed_7c"):
        port_inception.load_torch_inception(str(path))


def test_compute_fid_keeps_n_samples_of_its_sampled_stream(projected):
    """``compute_fid`` samples full batches from ``fold_in(generator, b)``
    and keeps ``n_samples`` rows: its distance is that of the kept rows'
    statistics (the same features; relative 1e-9 for the float64 sums)."""
    imgs = np.random.RandomState(1).rand(4, 16, 16, 3).astype(np.float32)
    seeds = []

    def sampler(generator, n):
        b = len(seeds)
        seeds.append(generator.initial_seed())
        return torch.from_numpy(imgs[2 * b:2 * b + n])

    real = [imgs[:2], imgs[2:]]
    got = port_fid.compute_fid(None, real, generator=torch.Generator().manual_seed(5),
                               n_samples=3, sample_batch=2, sampler=sampler, device="cpu")
    fn, dim = port_fid.make_feature_fn(device="cpu")
    fake = port_fid.ActivationStats(dim)
    for batch in real:
        fake.update(fn(batch)[:3 - fake.count])
    want = port_fid.fid_from_stats(port_fid.stats_for_batches(real, fn, dim), fake)
    assert got == pytest.approx(want, rel=1e-9) and got > 0.0
    assert len(seeds) == 2 and seeds[0] != seeds[1]


def test_make_feature_fn_refuses_a_model_without_variables():
    with pytest.raises(ValueError) as want:
        jax_fid.make_feature_fn(jax_inception.InceptionV3Features())
    with pytest.raises(ValueError) as got:
        port_fid.make_feature_fn(port_inception.InceptionV3Features(), device="cpu")
    assert str(got.value) == str(want.value)


def test_proxy_init_is_seeded_and_lecun_he_scaled():
    _, a = port_inception.init_variables(0)
    _, b = port_inception.init_variables(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["Mixed_6b.branch7x7_2.conv.weight"]  # fan_in 128·1·7
    std = float(w.std())
    assert std == pytest.approx(np.sqrt(2.0 / (128 * 7)), rel=0.05)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(2.0 / (128 * 7)) / 0.8796 + 1e-6
    assert torch.equal(a["Conv2d_1a_3x3.bn.running_var"], torch.ones(32))


# ---------------------------------------------------------------- guards


def _scaled(tree, gain):
    return jax.tree.map(lambda a: np.asarray(a) * gain, tree)


@pytest.fixture(scope="module")
def models():
    jmodel = DiffusionViT(**TINY, use_flash=False)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                                        jnp.zeros((2,), jnp.int32))["params"])
    params = _scaled(params, GAIN)
    pmodel = PortViT(**TINY, use_flash=False, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, 4), strict=True)
    return jmodel, params, pmodel


#: the guards' feature map in their parity tests: a seeded projection of the
#: flattened 16×16 image to 64 dims through tanh, the same numbers in both
#: packages (the extractor itself is held to JAX's above)
PROJ = (np.random.RandomState(21).randn(16 * 16 * 3, 64) / np.sqrt(768)).astype(np.float32)


def _jax_features(imgs):
    return jnp.tanh(jnp.reshape(imgs, (imgs.shape[0], -1)) @ PROJ)


def _port_features(imgs):
    x = torch.as_tensor(imgs, dtype=torch.float32)
    return torch.tanh(x.reshape(x.shape[0], -1) @ torch.from_numpy(PROJ))


@pytest.fixture
def projected(monkeypatch):
    """Both packages' guards extract ``PROJ`` features."""
    monkeypatch.setattr(jax_fid, "make_feature_fn", lambda m=None, v=None: (_jax_features, 64))
    monkeypatch.setattr(port_fid, "make_feature_fn",
                        lambda m=None, v=None, device=None: (_port_features, 64))


@pytest.fixture
def fed(monkeypatch, projected):
    """The port is fed JAX's per-batch start (and known batch) for the one
    batch of 2."""
    rng = jax.random.PRNGKey(11)
    _, sub = jax.random.split(rng)
    start = np.asarray(jax.random.normal(sub, (2, 16, 16, 3), jnp.float32))
    known = np.asarray(jax.random.uniform(jax.random.fold_in(sub, 0xFACE), (2, 16, 16, 3),
                                          jnp.float32, -1.0, 1.0))
    monkeypatch.setattr(port_sampling, "fresh_start",
                        lambda *a, **kw: torch.from_numpy(start.copy()))
    monkeypatch.setattr(port_fid, "inpaint_known",
                        lambda *a, **kw: torch.from_numpy(known.copy()))
    common = dict(n_samples=2, sample_batch=2, k=K)
    return (dict(rng=rng, **common),
            dict(generator=torch.Generator().manual_seed(11), device="cpu", **common))


def _same_report(got, want, fid_key):
    assert set(got) == set(want)
    for key in set(want) - {fid_key, "max_abs_pixel_delta",
                            "calibration_worst_layer", "calibration_max_abs_err"}:
        assert got[key] == want[key], key
    assert got["max_abs_pixel_delta"] == pytest.approx(want["max_abs_pixel_delta"],
                                                       abs=DELTA_ATOL)
    assert got[fid_key] == pytest.approx(want[fid_key], rel=FID_RTOL, abs=FID_ATOL)


@pytest.mark.parametrize("task,mode", [("sample", "full"), ("inpaint", "delta")])
def test_cached_sampler_guard_matches_jax(models, fed, task, mode):
    jmodel, params, pmodel = models
    jkw, pkw = fed
    want = jax_fid.cached_sampler_guard(jmodel, params, cache_mode=mode, task=task, **jkw)
    got = port_fid.cached_sampler_guard(pmodel, cache_mode=mode, task=task, **pkw)
    _same_report(got, want, "fid_exact_vs_cached")
    assert got["max_abs_pixel_delta"] > 1e-3  # the cache moved the images


def test_cached_sampler_guard_at_interval_1_reads_zero(models):
    """End to end on the default extractor (the seeded proxy, 2048 dims)."""
    pmodel = models[2]
    got = port_fid.cached_sampler_guard(pmodel, generator=torch.Generator().manual_seed(3),
                                        n_samples=2, sample_batch=2, k=K,
                                        cache_interval=1, device="cpu")
    assert got["fid_exact_vs_cached"] == 0.0 and got["max_abs_pixel_delta"] == 0.0
    assert got["extractor"].startswith("seeded random-init proxy")
    with pytest.raises(ValueError, match="task"):
        port_fid.cached_sampler_guard(pmodel, generator=torch.Generator(), task="draft",
                                      device="cpu")


def test_quantized_sampler_guard_matches_jax(models, fed):
    jmodel, params, pmodel = models
    jkw, pkw = fed
    want = jax_fid.quantized_sampler_guard(jmodel, params, quant="pallas", **jkw)
    got = port_fid.quantized_sampler_guard(pmodel, quant="pallas", **pkw)
    _same_report(got, want, "fid_exact_vs_quant")
    # the same layer, in each package's naming
    assert got["calibration_worst_layer"] == want["calibration_worst_layer"].replace(
        "blocks_", "blocks.").replace("/", ".")
    assert got["calibration_max_abs_err"] == pytest.approx(
        want["calibration_max_abs_err"], rel=1e-6)


def test_distilled_sampler_guard_matches_jax(models, fed):
    jmodel, params, pmodel = models
    jkw, pkw = fed
    student = _scaled(params, 1.05)
    pstudent = pmodel.clone()
    pstudent.load_state_dict(state_dict_from_flax(student, 4), strict=True)
    want = jax_fid.distilled_sampler_guard(jmodel, params, student, steps=2, **jkw)
    got = port_fid.distilled_sampler_guard(pmodel, pstudent, steps=2, **pkw)
    _same_report(got, want, "fid_teacher_vs_student")


def test_superres_consistency_guard_matches_jax():
    rs = np.random.RandomState(4)
    low = rs.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    raw = rs.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    projected = port_tasks.superres_project(raw, low)
    for out in (raw, projected, projected[[1, 0, 2]], projected[0]):
        lo = low if out.ndim == 4 else low[0]
        got = port_fid.superres_consistency_guard(torch.from_numpy(out.copy()), lo)
        assert got == jax_fid.superres_consistency_guard(out, lo)
    assert port_fid.superres_consistency_guard(projected, low)["bit_exact"]
    assert not port_fid.superres_consistency_guard(projected[[1, 0, 2]], low)["bit_exact"]
    assert not port_fid.superres_consistency_guard(raw, low)["bit_exact"]


# ----------------------------------------------------------- device rule


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_told(no_cuda, models):
    pmodel = models[2]
    g = torch.Generator()
    calls = {
        "make_feature_fn": lambda: port_fid.make_feature_fn(),
        "fid_between": lambda: port_fid.fid_between([], []),
        "compute_fid": lambda: port_fid.compute_fid(pmodel, [], generator=g),
        "cached": lambda: port_fid.cached_sampler_guard(pmodel, generator=g),
        "quantized": lambda: port_fid.quantized_sampler_guard(pmodel, generator=g),
        "distilled": lambda: port_fid.distilled_sampler_guard(pmodel, pmodel, generator=g,
                                                              steps=1),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
