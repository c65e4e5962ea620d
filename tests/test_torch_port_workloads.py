"""The port's editing workloads, direct and served, against the JAX
package's, and the engine's task, preview and student paths against the
port's direct calls.

TINY geometry (16px, patch 4, C=32, depth 2, 4 heads); the JAX parameter
tree carried into the port by ``state_dict_from_flax``. JAX runs on the CPU
at float32 matmul precision (tests/conftest.py), its flash path through the
Pallas kernel in interpret mode. Direct workloads are held to the JAX
package's ``workloads.*`` / ``ops/sampling.*`` functions (its engine-level
workload tests fail on this tree, ROADMAP.md Queue 3), the start passed
from the JAX side since the two RNGs differ: samplers atol 1e-4 (as in
tests/test_torch_port_model.py), host helpers bit-equal. Engine rows are
held to the port's direct call at the same dispatch shape, bit for bit, and
known inpaint pixels to ``(known + 1) / 2`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve as port_serve
from ddim_cold_torch import workloads as port_workloads
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import quant as port_quant
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.serve import batching as port_batching
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import serve, workloads
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import sampling

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K, T_START = 500, 1500     # 4 reverse steps; 3 from t_start
ATOL = 1e-4


def _init(seed):
    jmodel = DiffusionViT(**TINY, use_flash=True)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 16, 16, 3)),
        jnp.zeros((2,), jnp.int32))["params"])
    return jmodel, params


@pytest.fixture(scope="module")
def models():
    jmodel, params = _init(0)
    pmodel = PortViT(**TINY, use_flash=True, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]), strict=True)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    imgs = rs.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((16, 16), np.float32)
    mask[:, :8] = 1.0   # the left half known
    return imgs, mask


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -------------------------------------------------------------- host side


def test_task_registry_matches_jax():
    assert port_workloads.EDIT_TASKS == workloads.EDIT_TASKS
    assert port_workloads.TASKS == workloads.TASKS == port_batching._TASKS


@pytest.mark.parametrize("shape,n", [((16, 16), 3), ((16, 16, 1), 2), ((1, 16, 16), 1),
                                     ((3, 16, 16), 3), ((3, 16, 16, 1), 3)])
def test_normalize_mask_shapes_match_jax(shape, n):
    mask = (np.random.RandomState(1).rand(*shape) > 0.5).astype(np.float32)
    got = port_workloads.normalize_mask(mask, n, (16, 16))
    want = workloads.normalize_mask(mask, n, (16, 16))
    assert got.shape == want.shape == (n, 16, 16, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask,n", [(np.full((16, 16), 0.5), 1),      # soft
                                    (np.ones((2, 16, 16)), 3),         # batch
                                    (np.ones((17, 16)), 1),            # size
                                    (np.ones((2, 2, 16, 16, 1)), 2)])  # rank
def test_normalize_mask_errors_match_jax(mask, n):
    with pytest.raises(ValueError) as want:
        workloads.normalize_mask(mask, n, (16, 16))
    with pytest.raises(ValueError) as got:
        port_workloads.normalize_mask(mask, n, (16, 16))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_steps,every", [(100, 10), (90, 10), (3, 1), (4, 0),
                                           (4, 4), (1, 1), (7, 3), (5, -1)])
def test_preview_indices_match_jax(n_steps, every):
    assert (port_workloads.preview_indices(n_steps, every)
            == workloads.preview_indices(n_steps, every))


def test_default_edit_configs_match_jax():
    got = port_workloads.default_edit_configs(k=K, t_start=T_START, sr_level=3,
                                              preview_every=2)
    want = workloads.default_edit_configs(k=K, t_start=T_START, sr_level=3,
                                          preview_every=2)
    assert [vars(c) for c in got] == [vars(c) for c in want]


@pytest.mark.parametrize("low_shape,size", [((2, 4, 4, 3), 16), ((1, 25, 25, 3), 200),
                                            ((3, 3, 3), 16)])
def test_superres_init_and_project_match_jax(low_shape, size):
    rs = np.random.RandomState(2)
    low = rs.uniform(-1, 1, low_shape).astype(np.float32)
    up = port_workloads.superres_init(low, size)
    np.testing.assert_array_equal(up, np.asarray(workloads.superres_init(low, size)))
    outs = rs.rand(*up.shape).astype(np.float32)
    got = port_workloads.superres_project(outs, low)
    np.testing.assert_array_equal(got, workloads.superres_project(outs, low))
    low4 = low if low.ndim == 4 else low[None]
    iy = np.floor(np.arange(low4.shape[1]) * size / low4.shape[1]).astype(int)
    np.testing.assert_array_equal(got[:, iy][:, :, iy], (low4 + 1.0) / 2.0)


# ------------------------------------------------------------ direct calls


def test_inpaint_matches_jax_and_keeps_known_pixels(models, images):
    """JAX's ``jax.random.normal(rng, ...)`` start through the port's
    inpaint loop against ``workloads.inpaint``; last frame and trajectory."""
    jmodel, params, pmodel = models
    imgs, mask = images
    known = imgs[:2]
    rng = jax.random.PRNGKey(1)
    start = np.asarray(jax.random.normal(rng, (2, 16, 16, 3), jnp.float32))
    m = port_workloads.normalize_mask(mask, 2, (16, 16))
    got = port_sampling.ddim_inpaint(pmodel, start, known, m, k=K, device="cpu")
    want = workloads.inpaint(jmodel, params, rng, known, mask, k=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    sel = mask.astype(bool)
    np.testing.assert_array_equal(got.numpy()[:, sel], (known[:, sel] + 1.0) / 2.0)
    assert not np.allclose(got.numpy()[:, ~sel], (known[:, ~sel] + 1.0) / 2.0)
    seq = port_sampling.ddim_inpaint(pmodel, start, known, m, k=K,
                                     return_sequence=True, device="cpu")
    want_seq = workloads.inpaint(jmodel, params, rng, known, mask, k=K,
                                 return_sequence=True)
    assert seq.shape == (5, 2, 16, 16, 3)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(seq[-1].numpy(), got.numpy())


def test_inpaint_workload_draws_its_start_from_the_generator(models, images):
    pmodel = models[2]
    imgs, mask = images
    got = port_workloads.inpaint(pmodel, _gen(3), imgs[:2], mask, k=K, device="cpu")
    start = port_sampling.fresh_start(pmodel, _gen(3), 2, "cpu")
    m = port_workloads.normalize_mask(mask, 2, (16, 16))
    torch.testing.assert_close(got, port_sampling.ddim_inpaint(
        pmodel, start, imgs[:2], m, k=K, device="cpu"), rtol=0, atol=0)


def test_draft_to_drawing_is_sample_from_of_draft_init(models, images):
    """The direct draft workload is ``sample_from`` of the forward-noised
    draft, bit for bit (``sample_from`` itself is held to JAX in
    tests/test_torch_port_samplers.py); the JAX draft init is the same
    formula."""
    jmodel, params, pmodel = models
    imgs, _ = images
    got = port_workloads.draft_to_drawing(pmodel, _gen(4), imgs[:2], t_start=T_START, k=K,
                                          device="cpu")
    enc = port_workloads.draft_init(_gen(4), imgs[:2], T_START)
    want = port_sampling.sample_from(pmodel, enc, T_START, k=K, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # JAX's encoding of the draft, decoded by both packages
    jenc = np.asarray(workloads.draft_init(jax.random.PRNGKey(4), jnp.asarray(imgs[:2]),
                                           T_START))
    np.testing.assert_allclose(
        port_sampling.sample_from(pmodel, jenc, T_START, k=K, device="cpu").numpy(),
        np.asarray(sampling.sample_from(jmodel, params, jnp.asarray(jenc), T_START, k=K)),
        rtol=0, atol=ATOL)


# ------------------------------------------------------------------ engine

#: label → (config, submit kwargs, direct call); every
#: request is 4 rows, one exact bucket-4 batch
def _cases(images, low):
    imgs, mask = images
    pair = np.stack([imgs[0], imgs[1]])
    C = port_serve.SamplerConfig
    return {
        "cold": (C(sampler="cold", levels=3), dict(seed=21, n=4),
                 lambda m, g: port_sampling.cold_sample(m, g, n=4, levels=3, device="cpu")),
        "superres": (C(task="superres", sampler="cold", levels=2, quant="pallas"),
                     dict(x_init=port_workloads.superres_init(low, 16)),
                     lambda m, g: port_workloads.super_resolve(m, low, level=2,
                                                               device="cpu")),
        "inpaint": (C(task="inpaint", k=K), dict(seed=22, x_init=imgs[:4], mask=mask),
                    lambda m, g: port_workloads.inpaint(m, g, imgs[:4], mask, k=K,
                                                        device="cpu")),
        "inpaint fused": (C(task="inpaint", k=K, quant="pallas", fused=True),
                          dict(seed=23, x_init=imgs[:4], mask=mask),
                          lambda m, g: port_workloads.inpaint(m, g, imgs[:4], mask, k=K,
                                                              device="cpu")),
        "draft": (C(task="draft", k=K, t_start=T_START, preview_every=1),
                  dict(seed=24, x_init=imgs[:4]),
                  lambda m, g: port_workloads.draft_to_drawing(
                      m, g, imgs[:4], t_start=T_START, k=K, return_sequence=True,
                      device="cpu")),
        "interp": (C(task="interp", k=K, t_start=T_START), dict(seed=25, n=4, x_init=pair),
                   lambda m, g: port_workloads.interpolate(
                       m, g, pair[0], pair[1], n_interp=4, t_start=T_START, k=K,
                       device="cpu")),
        "fewstep": (C(steps=2), dict(seed=26, n=4),
                    lambda m, g: port_sampling.ddim_sample_fewstep(m, g, steps=2, n=4,
                                                                   device="cpu")),
        "student": (C(steps=2, student=True), dict(seed=27, n=4),
                    lambda m, g: port_sampling.ddim_sample_fewstep(m, g, steps=2, n=4,
                                                                   device="cpu")),
    }


@pytest.fixture(scope="module")
def student_state():
    return state_dict_from_flax(_init(1)[1], TINY["patch_size"])


@pytest.fixture(scope="module")
def served(models, images, student_state):
    """One engine (buckets 4, 8) over the port model with a student weight
    set, warmed with every case's config, then serving one 4-row request of
    each in a single drain."""
    pmodel = models[2]
    low = np.random.RandomState(3).uniform(-1, 1, (4, 4, 4, 3)).astype(np.float32)
    cases = _cases(images, low)
    eng = port_serve.Engine(pmodel, buckets=(4, 8), student_params=student_state,
                            device="cpu")
    report = port_serve.warmup(eng, [c for c, _, _ in cases.values()])
    assert report["new_programs"] == 2 * len(cases) == eng.stats["programs"]
    tickets = {label: eng.submit(config=cfg, **kw) for label, (cfg, kw, _) in cases.items()}
    run = eng.run()
    return eng, cases, tickets, run, low


def _variant(pmodel, state, quant=None, fused=False):
    """A model of the port built independently of the engine, with a
    config's weights."""
    model = pmodel.clone(quant=quant, fused=fused)
    model.load_state_dict(state if quant is None else port_quant.quantize_state_dict(state),
                          strict=True)
    return model


def test_engine_adds_no_program_after_warmup(served):
    eng, cases, _, run, _ = served
    assert run["programs"] == 0 and eng.stats["programs"] == 2 * len(cases)
    assert run["batches"] == len(cases) and run["padded_rows"] == 0
    assert run["failed_tickets"] == 0


@pytest.mark.parametrize("label", ["cold", "superres", "inpaint", "inpaint fused",
                                   "draft", "interp", "fewstep", "student"])
def test_engine_rows_equal_the_direct_call(models, served, student_state, label):
    """Each 4-row request fills bucket 4: its rows equal the port's direct
    call with the request's seed, on a model built apart from the engine
    with the config's weights, bit for bit."""
    pmodel = models[2]
    eng, cases, tickets, _, _ = served
    cfg, kw, direct = cases[label]
    state = student_state if cfg.student else pmodel.state_dict()
    model = _variant(pmodel, state, cfg.quant, cfg.fused)
    want = direct(model, _gen(kw["seed"]) if "seed" in kw else None).numpy()
    if cfg.preview_every:
        want = want[-1]
    got = tickets[label].result(timeout=5)
    assert got.shape == (4, 16, 16, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_served_inpaint_keeps_known_pixels(served, images):
    _, _, tickets, _, _ = served
    imgs, mask = images
    sel = mask.astype(bool)
    for label in ("inpaint", "inpaint fused"):
        np.testing.assert_array_equal(tickets[label].result()[:, sel],
                                      (imgs[:4][:, sel] + 1.0) / 2.0)


def test_served_superres_projects_onto_its_input(served):
    _, _, tickets, _, low = served
    out = port_workloads.superres_project(tickets["superres"].result(), low)
    iy = np.arange(4) * 4
    np.testing.assert_array_equal(out[:, iy][:, :, iy], (low + 1.0) / 2.0)


def test_previews_are_the_direct_trajectory(models, served):
    """``preview_every=1`` over 3 steps streams frames 1 and 2 of the direct
    call's trajectory, bit for bit, and the result is its last frame."""
    pmodel = models[2]
    eng, cases, tickets, _, _ = served
    cfg, kw, direct = cases["draft"]
    frames = direct(pmodel, _gen(kw["seed"])).numpy()
    steps = [s for s, _ in tickets["draft"].previews(timeout=5)]
    assert steps == port_workloads.preview_indices(frames.shape[0] - 1, 1) == [1, 2]
    for step, got in tickets["draft"].previews(timeout=5):
        np.testing.assert_array_equal(got, frames[step])
    np.testing.assert_array_equal(tickets["draft"].result(), frames[-1])
    assert eng.stats["preview_frames"] == 2
    assert list(tickets["cold"].previews(timeout=5)) == []


def test_padded_inpaint_rows_equal_the_direct_call_at_the_bucket(models, served, images):
    """A 3-row inpaint request pads to bucket 4 (zero start, known and mask
    rows): its rows equal the direct inpaint loop run on that padded batch."""
    pmodel = models[2]
    eng, cases, _, _, _ = served
    imgs, mask = images
    cfg = cases["inpaint"][0]
    ticket = eng.submit(seed=31, x_init=imgs[:3], mask=mask, config=cfg)
    report = eng.run()
    assert (report["padded_rows"], report["programs"]) == (1, 0)
    pad = lambda a: np.concatenate([a, np.zeros((1,) + a.shape[1:], np.float32)])  # noqa: E731
    start = port_sampling.fresh_start(pmodel, _gen(31), 3, "cpu").numpy()
    m = port_workloads.normalize_mask(mask, 3, (16, 16))
    want = port_sampling.ddim_inpaint(pmodel, pad(start), pad(imgs[:3]), pad(m), k=K,
                                      device="cpu").numpy()[:3]
    np.testing.assert_array_equal(ticket.result(timeout=5), want)


def test_student_configs_run_the_student_weights(models, served, student_state):
    pmodel = models[2]
    eng, cases, tickets, _, _ = served
    cfg = cases["student"][0]
    student = eng._model_for(cfg)
    assert student is not pmodel and student is eng._model_for(cfg)
    for name, value in student.state_dict().items():
        assert torch.equal(value, student_state[name]), name
    teacher = cases["fewstep"][2](pmodel, _gen(27)).numpy()
    assert not np.array_equal(tickets["student"].result(), teacher)


# -------------------------------------------------------------- validation


@pytest.fixture(scope="module")
def jax_engine(models):
    jmodel, params, _ = models
    return serve.Engine(jmodel, params, buckets=(4, 8))


@pytest.mark.parametrize("case", ["mask on draft", "draft without x_init",
                                  "inpaint without mask", "inpaint without seed",
                                  "interp not a pair", "guided cold"])
def test_submit_validation_matches_jax(served, jax_engine, images, case):
    eng = served[0]
    imgs, mask = images
    cfg = dict(draft=dict(task="draft", k=K, t_start=T_START),
               inpaint=dict(task="inpaint", k=K),
               interp=dict(task="interp", k=K, t_start=T_START),
               cold=dict(sampler="cold", levels=3))
    kw = {"mask on draft": dict(seed=0, x_init=imgs[:2], mask=mask, **cfg["draft"]),
          "draft without x_init": dict(seed=0, **cfg["draft"]),
          "inpaint without mask": dict(seed=0, x_init=imgs[:2], **cfg["inpaint"]),
          "inpaint without seed": dict(x_init=imgs[:2], mask=mask, **cfg["inpaint"]),
          "interp not a pair": dict(seed=0, n=4, x_init=imgs[:3], **cfg["interp"]),
          "guided cold": dict(x_init=imgs[:2], **cfg["cold"])}[case]
    with pytest.raises(ValueError) as want:
        jax_engine.submit(**kw)
    with pytest.raises(ValueError) as got:
        eng.submit(**kw)
    # the JAX engine also takes a jax key where the port takes only a seed
    assert str(got.value) == str(want.value).replace(" or rng=", "")
    assert eng.queue_depth() == 0


def test_student_without_a_student_tree_raises_like_jax(models, jax_engine):
    cfg = dict(steps=2, student=True)
    with pytest.raises(ValueError) as want:
        jax_engine._params_for(serve.SamplerConfig(**cfg))
    eng = port_serve.Engine(models[2], buckets=(4,), device="cpu")
    with pytest.raises(ValueError) as got:
        eng.submit(seed=0, n=1, **cfg)
    head = "config.student=True but this engine holds no student tree"
    assert str(want.value).startswith(head) and str(got.value).startswith(head)
    with pytest.raises(ValueError, match="no student tree"):
        port_serve.warmup(eng, [port_serve.SamplerConfig(**cfg)])
    assert eng.queue_depth() == 0 and eng.stats["programs"] == 0


@pytest.mark.parametrize("label", ["inpaint", "cold", "fewstep"])
def test_previews_of_every_sampler_family(models, images, label):
    """``preview_every`` on the inpaint, cold and few-step loops streams the
    direct call's trajectory frames at ``preview_indices``, bit for bit, and
    the result is its last frame."""
    pmodel = models[2]
    imgs, mask = images
    C = port_serve.SamplerConfig
    cfg, kw, direct = {
        "inpaint": (C(task="inpaint", k=K, preview_every=2),
                    dict(seed=51, x_init=imgs[:4], mask=mask),
                    lambda: port_workloads.inpaint(pmodel, _gen(51), imgs[:4], mask, k=K,
                                                   return_sequence=True, device="cpu")),
        "cold": (C(sampler="cold", levels=3, preview_every=1), dict(seed=52, n=4),
                 lambda: port_sampling.cold_sample(pmodel, _gen(52), n=4, levels=3,
                                                   return_sequence=True, device="cpu")),
        "fewstep": (C(steps=4, preview_every=1), dict(seed=53, n=4),
                    lambda: port_sampling.ddim_sample_fewstep(
                        pmodel, _gen(53), steps=4, n=4, return_sequence=True,
                        device="cpu")),
    }[label]
    eng = port_serve.Engine(pmodel, buckets=(4,), device="cpu")
    port_serve.warmup(eng, [cfg])
    ticket = eng.submit(config=cfg, **kw)
    assert eng.run()["programs"] == 0
    frames = direct().numpy()
    want = port_workloads.preview_indices(frames.shape[0] - 1, cfg.preview_every)
    got = list(ticket.previews(timeout=5))
    assert [s for s, _ in got] == want and want
    for step, f in got:
        np.testing.assert_array_equal(f, frames[step])
    np.testing.assert_array_equal(ticket.result(timeout=5), frames[-1])


def test_quant_student_variant_loads_the_students_int8_state(models, served, student_state):
    """One int8 state per weight set: a quantized student config runs the
    student's codes, the teacher's quant configs the teacher's."""
    pmodel = models[2]
    eng = served[0]
    student = eng._model_for(port_serve.SamplerConfig(steps=2, student=True, quant="pallas"))
    teacher = eng._model_for(port_serve.SamplerConfig(k=K, quant="pallas"))
    for model, state in ((student, student_state), (teacher, pmodel.state_dict())):
        for name, value in port_quant.quantize_state_dict(state).items():
            assert torch.equal(model.state_dict()[name], value), name
    assert len(eng._qstates) == 2
