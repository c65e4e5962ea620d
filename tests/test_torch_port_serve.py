"""The port's serving core against the JAX package's and against itself.

Planner: the port's verbatim copy of ``serve/batching.py`` must produce the
JAX planner's plans on the cases of tests/test_serve.py. Engine (CPU, two
buckets): rows are bitwise equal to a direct port ``ddim_sample`` at the
same dispatch shape, allclose (atol 1e-4) to the JAX sampler on the same
start, and a warmed engine adds no program while serving.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve as port_serve
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.serve import batching as port_batching
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.serve import batching

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K = 500  # 4 reverse steps

# --------------------------------------------------------------- planning


@pytest.mark.parametrize("rows,buckets", [
    (5, (4, 8)), (5, (4, 32, 128)), (11, (4, 8)), (8, (8,)),
    (260, (8, 32, 128)), (1, (8, 32)), (9, (4, 8)), (3, ()), (3, (0, 4))])
def test_cover_rows_matches_jax(rows, buckets):
    try:
        want = batching.cover_rows(rows, buckets)
    except ValueError:
        with pytest.raises(ValueError):
            port_batching.cover_rows(rows, buckets)
        return
    assert port_batching.cover_rows(rows, buckets) == want


@pytest.mark.parametrize("n", [1, 8, 9, 128, 129])
def test_select_bucket_matches_jax(n):
    assert (port_batching.select_bucket(n, (8, 32, 128))
            == batching.select_bucket(n, (8, 32, 128)))


def _plan_shape(plans, reqs):
    index = {id(r): i for i, r in enumerate(reqs)}
    return [(p.bucket, p.rows, p.padded_rows,
             [(index[id(r)], lo, hi, off) for r, lo, hi, off in p.entries])
            for p in plans]


@pytest.mark.parametrize("case", [
    [({}, 11), ({}, 3)],                                   # split + pad
    [({}, 2), ({"cache_interval": 2}, 2), ({}, 2),
     ({"sampler": "cold"}, 2)],                            # mixed configs
    [({"cache_interval": 4, "cache_mode": "adaptive",
       "cache_threshold": 0.1}, 3)] * 2,                   # batch-coupled
    [],                                                    # empty queue
])
def test_plan_batches_matches_jax(case):
    def plans(mod, cfg_cls, req_cls):
        reqs = [req_cls(config=cfg_cls(k=K, **cfg), n=n) for cfg, n in case]
        return _plan_shape(mod.plan_batches(reqs, (4, 8)), reqs)

    assert (plans(port_batching, port_batching.SamplerConfig, port_batching.Request)
            == plans(batching, batching.SamplerConfig, batching.Request))


def test_config_validation_matches_jax():
    for kw in (dict(k=0), dict(cache_mode="bogus"), dict(sp_degree=2),
               dict(sp_mode="ring"), dict(student=True), dict(quant="int4")):
        with pytest.raises(ValueError) as want:
            batching.SamplerConfig(**kw)
        with pytest.raises(ValueError) as got:
            port_batching.SamplerConfig(**kw)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def models():
    jmodel = DiffusionViT(**TINY)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
        jnp.zeros((2,), jnp.int32))["params"])
    pmodel = PortViT(**TINY, use_flash=True, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]),
                           strict=True)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def warmed(models):
    eng = port_serve.Engine(models[2], buckets=(4, 8), device="cpu")
    cfg = port_serve.SamplerConfig(k=K)
    report = port_serve.warmup(eng, [cfg])
    assert report["new_programs"] == 2 and eng.stats["programs"] == 2
    return eng, cfg


def _direct(pmodel, x):
    return port_sampling.ddim_sample(pmodel, x_init=x, k=K, device="cpu").numpy()


def test_engine_rows_bitwise_at_dispatch_shape_and_close_to_jax(models, warmed):
    """x_init requests of 5 and 3 rows fill bucket 8 exactly; a lone 3-row
    request then pads to bucket 4. Each row equals the direct port sampler
    run on the same padded batch bit for bit, and the JAX sampler on the
    request's own start to 1e-4."""
    jmodel, params, pmodel = models
    eng, cfg = warmed
    rs = np.random.RandomState(11)
    xs = [rs.randn(n, 16, 16, 3).astype(np.float32) for n in (5, 3, 3)]

    tickets = [eng.submit(x_init=xs[0], config=cfg),
               eng.submit(x_init=xs[1], config=cfg)]
    report = eng.run()
    assert (report["batches"], report["rows"], report["padded_rows"]) == (1, 8, 0)
    full = _direct(pmodel, np.concatenate(xs[:2]))
    np.testing.assert_array_equal(tickets[0].result(timeout=5), full[:5])
    np.testing.assert_array_equal(tickets[1].result(timeout=5), full[5:])

    t3 = eng.submit(x_init=xs[2], config=cfg)
    report = eng.run()
    assert (report["batches"], report["padded_rows"]) == (1, 1)
    padded = np.concatenate([xs[2], np.zeros((1, 16, 16, 3), np.float32)])
    np.testing.assert_array_equal(t3.result(timeout=5), _direct(pmodel, padded)[:3])
    assert report["programs"] == 0 and eng.stats["programs"] == 2

    for ticket, x in zip(tickets + [t3], xs):
        want = np.asarray(sampling.ddim_sample(jmodel, params,
                                               x_init=jnp.asarray(x), k=K))
        np.testing.assert_allclose(ticket.result(), want, rtol=0, atol=1e-4)


def test_engine_fresh_starts_and_split_add_no_program(models, warmed):
    """Seeded fresh starts: a request exactly filling bucket 4 equals the
    direct sampler with the same seeded generator, bit for bit; an 11-row
    request splits over [8, 4] and reassembles; no program is added."""
    pmodel = models[2]
    eng, cfg = warmed
    t4 = eng.submit(seed=7, n=4, config=cfg)
    t11 = eng.submit(seed=8, n=11, config=cfg)
    report = eng.run()
    assert report["programs"] == 0 and eng.stats["programs"] == 2
    assert report["rows"] == 15 and report["failed_tickets"] == 0
    assert report["latency"]["count"] == 2
    want = port_sampling.ddim_sample(pmodel, torch.Generator().manual_seed(7),
                                     n=4, k=K, device="cpu").numpy()
    np.testing.assert_array_equal(t4.result(timeout=5), want)
    got = t11.result(timeout=5)
    assert got.shape == (11, 16, 16, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("kw", [
    dict(cache_interval=2), dict(cache_interval=2, quant="pallas"),
    dict(cache_interval=4, cache_mode="token", cache_tokens=3),
    dict(cache_interval=2, telemetry=True)])
def test_cached_configs_are_served(models, kw):
    """The cached configs this slice refused before, served: two 2-row
    requests share a bucket-4 batch, the rows equal the direct cached
    sampler on that batch and, for the float configs, JAX's cached sampler
    on the same start (atol 1e-4); telemetry reaches the tickets."""
    jmodel, params, pmodel = models
    eng = port_serve.Engine(pmodel, buckets=(4, 8), device="cpu")
    config = port_serve.SamplerConfig(k=K, **kw)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    tickets = [eng.submit(x_init=x, config=config) for _ in range(2)]
    report = eng.run()
    assert (report["batches"], report["failed_tickets"]) == (1, 0)
    options = {k: v for k, v in kw.items() if k != "quant"}
    want = port_sampling.ddim_sample(eng._model_for(config), x_init=np.concatenate([x, x]),
                                     k=K, device="cpu", **options)
    if config.telemetry:
        want, tel = want
        assert tickets[0].telemetry["branch"] == list(tel.branch)
    for ticket in tickets:
        np.testing.assert_array_equal(ticket.result(timeout=5), want[:2].numpy())
    if not config.quant:
        jwant = sampling.ddim_sample(jmodel, params, x_init=jnp.asarray(x), k=K, **options)
        jwant = jwant[0] if config.telemetry else jwant
        np.testing.assert_allclose(tickets[0].result(timeout=5), np.asarray(jwant),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(steps=2), dict(task="draft", t_start=500), dict(sampler="cold"),
    dict(preview_every=1)])
def test_formerly_refused_configs_are_served(models, kw):
    """Few-step, draft, cold and preview configs, refused before their
    slice, now serve: two 2-row requests of one seed share a bucket-4 batch
    and come back finite, in [0, 1] and equal."""
    eng = port_serve.Engine(models[2], buckets=(4, 8), device="cpu")
    x = np.random.RandomState(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    extra = dict(x_init=x) if kw.get("task") == "draft" else dict(n=2)
    tickets = [eng.submit(seed=3, k=K, **extra, **kw) for _ in range(2)]
    report = eng.run()
    assert (report["batches"], report["programs"], report["failed_tickets"]) == (1, 1, 0)
    got = tickets[0].result(timeout=5)
    assert got.shape == (2, 16, 16, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_array_equal(tickets[1].result(timeout=5), got)


def test_student_without_a_student_tree_raises_at_submit(warmed):
    eng, _ = warmed
    with pytest.raises(ValueError, match="no student tree"):
        eng.submit(seed=0, n=1, k=K, steps=2, student=True)
    assert eng.queue_depth() == 0


def test_submit_validation(warmed):
    eng, cfg = warmed
    with pytest.raises(ValueError, match="seed"):
        eng.submit(n=2, config=cfg)
    with pytest.raises(ValueError, match="x_init"):
        eng.submit(x_init=np.zeros((1, 8, 8, 3)), config=cfg)
    with pytest.raises(ValueError, match="OR"):
        eng.submit(seed=0, config=cfg, k=K)
    with pytest.raises(ValueError):
        port_serve.Engine(eng.model, buckets=(), device="cpu")


def test_jax_engine_report_keys_carry_over(warmed):
    """The port's report keeps the JAX engine's keys where they apply."""
    eng, cfg = warmed
    eng.submit(seed=1, n=1, config=cfg)
    report = eng.run()
    jax_keys = {"batches", "rows", "padded_rows", "wall_s", "img_per_sec",
                "latency", "max_queue_depth", "failed_tickets"}
    assert jax_keys <= report.keys()
