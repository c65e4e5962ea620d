"""The port's step cache against the JAX package's and against itself.

One JAX model at the TINY4 geometry of tests/test_step_cache.py (16px,
patch 8, C=32, depth 4, 4 heads: N+1 = 5 tokens, distinct front and rear
trunk halves) is initialised and carried into the port by
``state_dict_from_flax``; both packages see the same numpy inputs, the
samplers' starts passed from the JAX side (the samplers' comparisons at
depth 2, on the dense route). JAX runs on the CPU at float32 matmul
precision (tests/conftest.py), its Pallas kernels in interpret mode.

Tolerances: branch tables and the adaptive gate's branch sequence equal;
every hook's output and cache deltas rtol 2e-4 / atol 2e-5 (the float32
forward's, tests/test_torch_port_model.py), on every route of the port's
model (flash, dense, ``quant="pallas"``, fused w8a16 and w8a8, float
fused); the cached samplers atol 1e-4 over their 5 steps (the uncached
samplers', tests/test_torch_port_samplers.py). Port against port, bit for
bit: ``cache_interval=1``, ``cache_tokens = N+1`` and τ = 0 are the
uncached sampler, τ = ∞ is the delta schedule, telemetry off is telemetry
on, and served rows are their direct calls at the same dispatch shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve as port_serve
from ddim_cold_torch import workloads as port_workloads
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.models import vit as port_vit
from ddim_cold_torch.obs import device as port_obs
from ddim_cold_torch.ops import quant as pq
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.ops import schedule as port_schedule
from ddim_cold_torch.ops import step_cache as port_cache
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import workloads
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.obs import device as obs
from ddim_cold_tpu.ops import quant as jq
from ddim_cold_tpu.ops import sampling, schedule, step_cache
from ddim_cold_tpu.utils.checkpoint import flax_from_torch_state_dict

TINY4 = dict(img_size=(16, 16), patch_size=8, embed_dim=32, depth=4,
             num_heads=4, total_steps=2000)
TINY2 = dict(TINY4, depth=2)
N_TOK = 5  # N+1
K = 400    # 5 reverse steps
FWD = dict(rtol=2e-4, atol=2e-5)
ATOL = 1e-4


def _params(geometry):
    """A JAX parameter tree from the port's seeded init (bridged, which is
    cheaper than a JAX init), with small random biases so that every bias
    of the hooks' paths is exercised."""
    rs = np.random.RandomState(0)
    state = {k: (v + torch.from_numpy(rs.randn(*v.shape).astype(np.float32)) * 0.02
                 if k.endswith("bias") else v)
             for k, v in PortViT(**geometry, device="cpu").state_dict().items()}
    return flax_from_torch_state_dict(state, geometry["patch_size"])


@pytest.fixture(scope="module")
def params():
    return _params(TINY4)


def _port(params, geometry=TINY4, **kw) -> PortViT:
    model = PortViT(**geometry, device="cpu", **kw)
    state = state_dict_from_flax(params, geometry["patch_size"])
    if kw.get("quant"):
        state = pq.quantize_state_dict(state)
    model.load_state_dict(state, strict=True)
    return model


def _jax(params, geometry=TINY4, **kw):
    model = DiffusionViT(**geometry, **kw)
    return model, (jq.quantize_params(params) if kw.get("quant") else params)


@pytest.fixture(scope="module")
def flash(params):
    """The flash models of both packages."""
    return _jax(params, use_flash=True) + (_port(params, use_flash=True),)


@pytest.fixture(scope="module")
def dense():
    """The samplers' comparisons run on the dense route at depth 2 (front
    and rear halves of one block each): the JAX cached scans compile
    several times faster there than through the interpret-mode Pallas
    kernel and four blocks, and the hooks are held on every route above."""
    p = _params(TINY2)
    return _jax(p, TINY2) + (_port(p, TINY2),)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _x(seed, n=2):
    return np.random.RandomState(seed).randn(n, 16, 16, 3).astype(np.float32)


# ------------------------------------------------------------- the tables


@pytest.mark.parametrize("n_steps,interval,mode", [
    (10, 2, "delta"), (100, 2, "delta"), (7, 3, "full"), (100, 4, "adaptive"),
    (100, 2, "token"), (5, 1, "delta"), (4, 0, "full"), (1, 2, "delta"), (0, 2, "token")])
def test_branch_tables_match_jax(n_steps, interval, mode):
    got = port_schedule.cache_branch_sequence(n_steps, interval, mode)
    want = schedule.cache_branch_sequence(n_steps, interval, mode)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for name in ("CACHE_REFRESH", "CACHE_REUSE_REAR", "CACHE_REUSE_FRONT",
                 "CACHE_REUSE_ALL", "CACHE_REUSE_TOKEN"):
        assert getattr(port_schedule, name) == getattr(schedule, name)
    assert port_obs.static_schedule(n_steps, interval, mode).tobytes() == \
        obs.static_schedule(n_steps, interval, mode).tobytes()


@pytest.mark.parametrize("args,kw", [
    ((6, 100, 2), {}), ((6, 100, 4, "full"), {}), ((6, 7, 2), dict(split=2)),
    ((6, 100, 4, "adaptive"), dict(threshold=0.05)),
    ((6, 100, 2, "token"), dict(token_k=626, n_tokens=2501)),
    ((1, 10, 2), {}), ((6, 10, 2), dict(split=6)), ((6, 10, 2, "adaptive"), {}),
    ((6, 10, 2, "adaptive"), dict(threshold=-1.0)), ((6, 10, 2), dict(threshold=0.1)),
    ((6, 10, 2, "token"), dict(token_k=3)), ((6, 10, 2, "token"), dict(token_k=0, n_tokens=5)),
    ((6, 10, 2), dict(token_k=3)), ((6, 10, 2, "bogus"), {})])
def test_cache_spec_and_flops_saved_match_jax(args, kw):
    try:
        want = step_cache.cache_spec(*args, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_cache.cache_spec(*args, **kw)
        assert str(got.value) == str(exc)
        return
    got = port_cache.cache_spec(*args, **kw)
    assert tuple(got) == tuple(want)
    assert port_cache.flops_saved_fraction(got) == step_cache.flops_saved_fraction(want)


def test_summarize_matches_jax():
    rs = np.random.RandomState(3)
    tel = (np.array([0, 1, 0, 0, 2, 0, 2], np.int32), rs.rand(7).astype(np.float32))
    kw = dict(cache_interval=2, cache_mode="adaptive", cache_threshold=0.05)
    assert port_obs.summarize(port_obs.StepTelemetry(*tel), **kw) == \
        obs.summarize(obs.StepTelemetry(*tel), **kw)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_live_set_ties_match_jax_top_k(k):
    """Rows with many exactly equal scores (unchanged tokens score 0, as
    padding rows and known inpaint pixels do): the port's stable selection
    takes the lower index first, as ``jax.lax.top_k`` does."""
    rs = np.random.RandomState(k)
    tokens = rs.randn(3, 17, 8).astype(np.float32)
    ref = tokens.copy()
    ref[0, 2:6] += 1.0           # four changed tokens, the rest tie at 0
    ref[1, ::3] += 0.5           # equal changes: ties among non-zeros too
    got = port_vit._live_tokens(_t(tokens), _t(ref), k).numpy()
    scores = jnp.sum(jnp.square(jnp.asarray(tokens) - jnp.asarray(ref)), axis=-1)
    scores = scores.at[:, 0].set(jnp.finfo(jnp.float32).max)
    want = np.sort(np.asarray(jax.lax.top_k(scores, k)[1]), axis=-1)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- the hooks

ROUTES = {"flash": dict(use_flash=True), "dense": dict(use_flash=False),
          "pallas": dict(use_flash=True, quant="pallas"),
          "fused_w8a16": dict(use_flash=True, quant="pallas", fused=True),
          "fused_w8a8": dict(use_flash=True, quant="w8a8", fused=True),
          "fused_float": dict(use_flash=True, fused=True)}
#: hook → (JAX/port keyword arguments of the forward); "prev" marks a cache
#: input made by a refresh at another (x, t)
HOOKS = {"capture_split": dict(capture_split=2),
         "skip_rear": dict(skip_blocks=(2, 4), block_delta="prev_rear"),
         "skip_front": dict(skip_blocks=(0, 2), block_delta="prev_front"),
         "skip_all": dict(skip_blocks=(0, 4), block_delta="prev_sum"),
         "capture_tokens": dict(capture_tokens=True),
         "token_k3": dict(token_cache="prev_tokens", token_k=3),
         "token_all": dict(token_cache="prev_tokens", token_k=N_TOK)}
CASES = ([(r, h) for r in ("flash", "dense") for h in HOOKS]
         + [("pallas", "skip_rear")]
         + [(r, "token_k3") for r in ROUTES if r not in ("flash", "dense")])


@pytest.fixture(scope="module")
def cache_inputs(params):
    """Cache inputs for the reuse hooks: a JAX refresh (dense route) at
    another (x, t) than the hooks run at."""
    x, t = jnp.asarray(_x(2)), jnp.asarray([900, 1700], jnp.int32)
    model = DiffusionViT(**TINY4)
    split = model.apply({"params": params}, x, t, capture_split=2)[1]
    tokens = model.apply({"params": params}, x, t, capture_tokens=True)[1]
    return [np.asarray(a) for a in split], [np.asarray(a) for a in tokens]


def _hook_kw(hook, cache_inputs, to):
    prev_split, prev_tokens = cache_inputs
    kw = {}
    for name, val in HOOKS[hook].items():
        if val == "prev_rear":
            val = to(prev_split[1])
        elif val == "prev_front":
            val = to(prev_split[0])
        elif val == "prev_sum":
            val = to(prev_split[0]) + to(prev_split[1])
        elif val == "prev_tokens":
            val = tuple(to(a) for a in prev_tokens)
        kw[name] = val
    return kw


@pytest.mark.parametrize("route,hook", CASES)
def test_hooks_match_jax(params, cache_inputs, route, hook):
    """Each hook's x̂0 and cache tensors, JAX against the port, on the same
    weights, inputs and cache inputs. The token hooks' new caches also pin
    the live set: a row off it keeps its cache input. Every route: flash
    and dense take every hook; the quantized and fused routes a token reuse
    (their kernels at the gathered length; the block loop a skip walks is
    route-independent Python), ``quant="pallas"`` a block skip too."""
    jmodel, jparams = _jax(params, **ROUTES[route])
    x, t = _x(1), np.array([700, 1500], np.int32)
    kw = _hook_kw(hook, cache_inputs, jnp.asarray)
    arrays = {k: v for k, v in kw.items() if k in ("block_delta", "token_cache")}
    static = {k: v for k, v in kw.items() if k not in arrays}
    want = jax.jit(lambda p, x, t, a: jmodel.apply({"params": p}, x, t, **a, **static))(
        jparams, jnp.asarray(x), jnp.asarray(t), arrays)
    with torch.no_grad():
        got = _port(params, **ROUTES[route])(_t(x), _t(t), **_hook_kw(hook, cache_inputs, _t))
    if isinstance(want, tuple):
        (want, want_cache), (got, got_cache) = want, got
        assert len(got_cache) == len(want_cache) == 2
        for g, w in zip(got_cache, want_cache):
            assert g.shape == w.shape == (2, N_TOK, 32)
            np.testing.assert_allclose(_np(g), np.asarray(w), **FWD)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


def test_skipped_blocks_are_never_run(flash):
    """A reuse forward's output does not depend on the skipped blocks'
    weights, and a refresh forward's image is the plain forward's, bit for
    bit."""
    _, _, pmodel = flash
    x, t = _t(_x(4)), torch.tensor([300, 1200])
    with torch.no_grad():
        plain = pmodel(x, t)
        img, (front, rear) = pmodel(x, t, capture_split=2)
        reuse = pmodel(x, t, skip_blocks=(2, 4), block_delta=rear)
        for blk in pmodel.blocks[2:]:
            for p in blk.parameters():
                p.add_(1.0)
        again = pmodel(x, t, skip_blocks=(2, 4), block_delta=rear)
        for blk in pmodel.blocks[2:]:
            for p in blk.parameters():
                p.sub_(1.0)
    torch.testing.assert_close(img, plain, rtol=0, atol=0)
    torch.testing.assert_close(again, reuse, rtol=0, atol=0)
    torch.testing.assert_close(reuse, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(skip_blocks=(0, 2), capture_split=1), "distinct cache branches"),
    (dict(skip_blocks=(2, 5), block_delta=0), "outside"),
    (dict(skip_blocks=(0, 2)), "requires the cached block_delta"),
    (dict(capture_split=4), "two non-empty halves"),
    (dict(capture_tokens=True, capture_split=2), "distinct cache families"),
    (dict(capture_tokens=True, token_cache=(0, 0), token_k=2), "distinct cache branches"),
    (dict(token_cache=(0, 0), token_k=6), "token_k in"),
    (dict(token_k=2), "only applies with token_cache")])
def test_hook_refusals_match_jax(params, kw, match):
    x, t = np.zeros((1, 16, 16, 3), np.float32), np.zeros((1,), np.int32)
    with pytest.raises(ValueError, match=match):
        DiffusionViT(**TINY4).apply({"params": params}, jnp.asarray(x), jnp.asarray(t), **kw)
    with pytest.raises(ValueError, match=match):
        _port(params)(_t(x), _t(t), **kw)


# ------------------------------------------------------------ the samplers

MODES = {"delta": dict(cache_interval=2),
         "full": dict(cache_interval=2, cache_mode="full"),
         "adaptive": dict(cache_interval=2, cache_mode="adaptive", cache_threshold=0.05),
         "token": dict(cache_interval=2, cache_mode="token", cache_tokens=3)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampler", ["ddim", "ddim_sequence", "inpaint", "cold", "fewstep"])
def test_cached_samplers_match_jax(dense, sampler, mode):
    """Every cached sampler and mode, JAX against the port from JAX's start."""
    jmodel, jparams, pmodel = dense
    kw = MODES[mode]
    x = _x(5)
    if sampler in ("ddim", "ddim_sequence"):
        seq = sampler == "ddim_sequence"
        want = sampling.ddim_sample(jmodel, jparams, x_init=jnp.asarray(x), k=K,
                                    return_sequence=seq, **kw)
        got = port_sampling.ddim_sample(pmodel, x_init=x, k=K, return_sequence=seq,
                                        device="cpu", **kw)
    elif sampler == "inpaint":
        known = np.random.RandomState(6).uniform(-1, 1, x.shape).astype(np.float32)
        mask = np.zeros((2, 16, 16, 1), np.float32)
        mask[:, :, :8] = 1.0
        key = jax.random.PRNGKey(3)
        want = workloads.inpaint(jmodel, jparams, key, known, mask, k=K, **kw)
        start = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        got = port_sampling.ddim_inpaint(pmodel, start, known, mask, k=K,
                                         device="cpu", **kw)
    elif sampler == "cold":
        want = sampling.cold_sample(jmodel, jparams, x_init=jnp.asarray(x), levels=5, **kw)
        got = port_sampling.cold_sample(pmodel, x_init=x, levels=5, device="cpu", **kw)
    else:
        want = sampling.ddim_sample_fewstep(jmodel, jparams, x_init=jnp.asarray(x),
                                            steps=4, **kw)
        got = port_sampling.ddim_sample_fewstep(pmodel, x_init=x, steps=4,
                                                device="cpu", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tau", [0.0, 0.02, 0.05, 0.3, float("inf")])
def test_adaptive_gate_takes_jax_branches(dense, tau):
    """The gate's branch sequence equals JAX's telemetry, step for step; the
    drifts agree (step 0's, against the zero cache, is ~1e9); the images
    within the samplers' tolerance. The message gives the run's smallest
    |drift − τ|, the margin the comparison had."""
    jmodel, jparams, pmodel = dense
    x = _x(7)
    kw = dict(cache_interval=4, cache_mode="adaptive", cache_threshold=tau, telemetry=True)
    want, want_tel = sampling.ddim_sample(jmodel, jparams, x_init=jnp.asarray(x), k=250, **kw)
    got, got_tel = port_sampling.ddim_sample(pmodel, x_init=x, k=250, device="cpu", **kw)
    drift = np.asarray(want_tel.drift)
    margin = float(np.abs(drift[1:] - tau).min())
    assert list(got_tel.branch) == list(np.asarray(want_tel.branch)), (
        f"branches differ; smallest |drift - tau| = {margin}")
    np.testing.assert_allclose(got_tel.drift.numpy(), drift, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    static = port_obs.static_schedule(8, 4, "adaptive")
    if tau == 0.0:
        assert not got_tel.branch.any()
    elif tau == float("inf"):
        assert list(got_tel.branch) == list(static)


def test_gate_reads_the_device_once_per_reuse_step(flash):
    _, _, pmodel = flash
    port_cache.GATE_SYNCS.clear()
    port_sampling.ddim_sample(pmodel, x_init=_x(8), k=250, device="cpu", cache_interval=4,
                              cache_mode="adaptive", cache_threshold=0.05)
    assert port_cache.GATE_SYNCS["adaptive_gate"] == 6  # 8 steps, 2 static refreshes
    port_cache.GATE_SYNCS.clear()
    port_sampling.ddim_sample(pmodel, x_init=_x(8), k=250, device="cpu", cache_interval=4)
    assert not port_cache.GATE_SYNCS


# ----------------------------------------------------- bitwise collapses

@pytest.fixture(scope="module")
def bf16(params):
    return _port(params, use_flash=True, dtype=torch.bfloat16)


COLLAPSES = {
    "interval_1": (dict(cache_interval=1, cache_mode="full"), {}),
    "token_all": (dict(cache_interval=2, cache_mode="token", cache_tokens=N_TOK), {}),
    "tau_0": (dict(cache_interval=2, cache_mode="adaptive", cache_threshold=0.0), {}),
    "tau_inf": (dict(cache_interval=2, cache_mode="adaptive", cache_threshold=float("inf")),
                dict(cache_interval=2)),
    "telemetry": (dict(cache_interval=4, cache_mode="adaptive", cache_threshold=0.05,
                       telemetry=True),
                  dict(cache_interval=4, cache_mode="adaptive", cache_threshold=0.05)),
}


@pytest.mark.parametrize("case,sampler", [
    (c, s) for c in COLLAPSES for s in ("ddim", "cold", "fewstep")
    if c != "telemetry" or s == "ddim"])  # telemetry: the cached DDIM loop's (JAX)
def test_collapses_are_bitwise(bf16, case, sampler):
    """Port against port in bfloat16 on the flash route, bit for bit."""
    kw, base = COLLAPSES[case]
    run = dict(
        ddim=lambda **k: port_sampling.ddim_sample(bf16, x_init=_x(9), k=K,
                                                   device="cpu", **k),
        cold=lambda **k: port_sampling.cold_sample(bf16, x_init=_x(9), levels=5,
                                                   device="cpu", **k),
        fewstep=lambda **k: port_sampling.ddim_sample_fewstep(bf16, x_init=_x(9), steps=4,
                                                              device="cpu", **k))[sampler]
    got = run(**kw)
    if case == "telemetry":
        got = got[0]
    torch.testing.assert_close(got, run(**base), rtol=0, atol=0)


def test_inpaint_known_pixels_exact_when_cached(bf16):
    known = np.random.RandomState(10).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((16, 16), np.float32)
    mask[:, :8] = 1.0
    for kw in MODES.values():
        out = port_workloads.inpaint(bf16, torch.Generator().manual_seed(1), known, mask,
                                     k=K, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(out[:, :, :8], (known[:, :, :8] + 1.0) / 2.0)


# --------------------------------------------------------------- the engine

C = port_serve.SamplerConfig
SERVED = {
    "delta": C(k=K, cache_interval=2),
    "full": C(k=K, cache_interval=2, cache_mode="full"),
    "adaptive": C(k=K, cache_interval=2, cache_mode="adaptive", cache_threshold=0.05,
                  telemetry=True),
    "token": C(k=K, cache_interval=2, cache_mode="token", cache_tokens=3),
    "fused_w8a16": C(k=K, cache_interval=2, quant="pallas", fused=True),
    "pallas": C(k=K, cache_interval=2, quant="pallas"),
    "inpaint": C(task="inpaint", k=K, cache_interval=2, cache_mode="token", cache_tokens=2),
    "cold": C(sampler="cold", levels=5, cache_interval=2, cache_mode="full"),
    "fewstep": C(steps=4, cache_interval=2),
    "draft_previews": C(task="draft", t_start=1500, k=K, cache_interval=2, preview_every=2),
}


@pytest.fixture(scope="module")
def warmed(params):
    model = _port(params, use_flash=True, seed=2)
    eng = port_serve.Engine(model, buckets=(4, 8), device="cpu")
    report = port_serve.warmup(eng, list(SERVED.values()))
    assert report["new_programs"] == 2 * len(SERVED)
    pool = {key: [t.data_ptr() for t in cache] for key, cache in eng._spare_caches.items()}
    assert sorted(pool) == [(4, "adaptive"), (4, "pair"), (8, "adaptive"), (8, "pair")]
    return eng, pool


def _direct(eng, config, x, known, mask):
    """The sampler call of ``config`` on the batch start ``x`` (and the
    inpaint known image and mask batch), as a caller would make it."""
    model = eng._model_for(config)
    kw = dict(cache_interval=config.cache_interval, cache_mode=config.cache_mode,
              cache_threshold=config.cache_threshold, cache_tokens=config.cache_tokens or None,
              device="cpu")
    seq = config.preview_every > 0
    if config.task == "inpaint":
        return port_sampling.ddim_inpaint(model, x, known, mask, k=config.k, **kw)
    if config.sampler == "cold":
        return port_sampling.cold_sample(model, x_init=x, levels=config.levels, **kw)
    if config.steps:
        return port_sampling.ddim_sample_fewstep(model, x_init=x, steps=config.steps, **kw)
    if config.task == "draft":
        return port_sampling.sample_from(model, x, config.t_start, k=config.k,
                                         return_sequence=seq, **kw)
    return port_sampling.ddim_sample(model, x_init=x, k=config.k, telemetry=config.telemetry,
                                     **kw)


def _start(eng, config, seed, n, imgs):
    """A request's start, drawn as the engine draws it."""
    gen = torch.Generator().manual_seed(seed)
    if config.task == "draft":
        return port_workloads.draft_init(gen, imgs[:n], config.t_start)
    if config.sampler == "cold":
        return port_sampling.cold_init(eng.model, gen, n, "cpu")
    return port_sampling.fresh_start(eng.model, gen, n, "cpu")


@pytest.mark.parametrize("label", list(SERVED))
def test_engine_serves_cached_configs_bitwise(warmed, label):
    """Two 4-row requests of one config share a bucket-8 batch (one alone
    for adaptive, which is coupled); each row equals the direct call at
    the same 8-row shape, the pool hands back the warmed caches, and no
    program is built."""
    eng, pool = warmed
    config = SERVED[label]
    programs = eng.stats["programs"]
    imgs = np.random.RandomState(11).uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((16, 16), np.float32)
    mask[:8] = 1.0
    n = 8 if config.batch_coupled else 4
    kw = dict(x_init=imgs[:n]) if config.task in ("inpaint", "draft") else dict(n=n)
    if config.task == "inpaint":
        kw["mask"] = mask
    reps = 1 if config.batch_coupled else 2
    tickets = [eng.submit(seed=12, config=config, **kw) for _ in range(reps)]
    report = eng.run()
    assert report["programs"] == 0 and eng.stats["programs"] == programs
    assert report["batches"] == 1 and report["failed_tickets"] == 0
    x = torch.cat([_start(eng, config, 12, n, imgs)] * reps)
    known = np.concatenate([imgs[:n]] * reps)
    want = _direct(eng, config, x, known,
                   np.ascontiguousarray(np.broadcast_to(mask[None, :, :, None], (8, 16, 16, 1))))
    if config.telemetry:
        want, tel = want
        for ticket in tickets:
            assert ticket.telemetry["branch"] == list(tel.branch)
            assert ticket.telemetry["steps"] == 5
    want = want.numpy()
    if config.preview_every:
        frames = list(tickets[0].previews(timeout=5))
        assert [s for s, _ in frames] == port_workloads.preview_indices(want.shape[0] - 1, 2)
        for step, frame in frames:
            np.testing.assert_array_equal(frame, want[step, :n])
        want = want[-1]
    for ticket in tickets:
        got = ticket.result(timeout=5)
        assert got.shape == (n, 16, 16, 3) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want[:n])
    assert {key: [t.data_ptr() for t in cache]
            for key, cache in eng._spare_caches.items()} == pool


def test_engine_pads_adaptive_batches_with_row_0(warmed):
    """A 3-row adaptive request in bucket 4: its pad row replicates row 0,
    so its rows are the direct call's on that padded batch and its gate
    takes the branches of the direct unpadded 3-row call."""
    eng, _ = warmed
    config = SERVED["adaptive"]
    ticket = eng.submit(seed=13, n=3, config=config)
    report = eng.run()
    assert (report["batches"], report["padded_rows"]) == (1, 1)
    x3 = port_sampling.fresh_start(eng.model, torch.Generator().manual_seed(13), 3, "cpu")
    kw = dict(k=K, cache_interval=2, cache_mode="adaptive", cache_threshold=0.05,
              telemetry=True, device="cpu")
    padded, padded_tel = port_sampling.ddim_sample(eng.model, x_init=torch.cat([x3, x3[:1]]),
                                                   **kw)
    np.testing.assert_array_equal(ticket.result(timeout=5), padded[:3].numpy())
    _, tel = port_sampling.ddim_sample(eng.model, x_init=x3, **kw)
    assert ticket.telemetry["branch"] == list(tel.branch) == list(padded_tel.branch)
    # zero padding would have moved the gate's batch max
    _, zero_tel = port_sampling.ddim_sample(
        eng.model, x_init=torch.cat([x3, torch.zeros_like(x3[:1])]), **kw)
    assert not np.array_equal(zero_tel.drift.numpy(), padded_tel.drift.numpy())


def test_engine_served_rows_match_jax(params, warmed):
    """A served delta batch against the JAX sampler on the same start."""
    eng, _ = warmed
    jmodel, jparams = _jax(params, use_flash=True)
    x = _x(14, 4)
    ticket = eng.submit(x_init=x, config=SERVED["delta"])
    eng.run()
    want = sampling.ddim_sample(jmodel, jparams, x_init=jnp.asarray(x), k=K, cache_interval=2)
    np.testing.assert_allclose(ticket.result(timeout=5), np.asarray(want), rtol=0, atol=ATOL)
