"""Data and sequence parallelism of the port against the JAX package's, on
the CPU.

One module-scoped fixture spawns ONE gloo world of four CPU ranks (one
intra-op thread each, a free local port, a deadline well under two minutes
so a hung rank fails the fixture instead of hanging the suite, the process
group destroyed at the end) that runs every rank case of
``ddim_cold_torch/tools/dist_cases.py``. A two-rank mesh runs on both halves
of the world at once. The JAX references run in this process on the suite's
virtual CPU devices, at float32 matmul precision (tests/conftest.py), on the
same numpy inputs; JAX's parameters reach the port through
``utils.weights.state_dict_from_flax``.

* ring and Ulysses forward and gradients (of Σ out·w, summed over the
  ranks) against JAX's ``ring_self_attention`` / ``ulysses_self_attention``
  on ``{seq: 2}``, ``{seq: 4}`` and ``{data: 2, seq: 2}``, at a padded
  N = 17 and an even N = 16; Ulysses through the flash kernels' plain
  versions and the blockwise route, JAX's through its dense local
  attention. float32: rtol 2e-4, atol 2e-5 (JAX's own ring and Ulysses
  tests' tolerances; the two frameworks sum in another order). bfloat16
  forwards: the ring within one bf16 ulp of JAX's (2⁻⁷·|ref| + 2⁻¹²), the
  flash route within ``flash_attention.o_error_limit`` (it rounds P to bf16
  before P·V, as the kernel does, where JAX's dense route does not);
* ``SeqParallelConfigError`` with JAX's message, from the local function
  (rank side) and the front end (a stub mesh, no ranks);
* the TINY model sequence-parallel in both modes against JAX's, and
  ``sp_clone``'s fallback from Ulysses to the ring: atol 1e-4 (as
  tests/test_torch_port_model.py);
* one train step on ``{data: 2}``, ``{seq: 2}`` (Ulysses) and ``{data: 2,
  seq: 2}`` (ring) against JAX's step on the same mesh and batch, every
  drop rate 0, the port through the flash kernels' plain versions and JAX
  through its dense attention (the same function; the Pallas backward's
  interpret-mode compile would cost seconds a mesh): loss rtol 1e-5,
  parameters atol 3e-3·lr + rtol 1e-5 (as tests/test_torch_port_train.py),
  and the global gradient norm the clip saw against JAX's on the whole
  batch, rtol 1e-5 (one Adam step's update is about lr·sign(g) whatever the
  gradient's scale, so only the norm shows a share counted twice);
* ``ddim_sample(mesh=)`` on ``{data: 2}`` and ``{data: 2, seq: 2}`` (a
  Ulysses ``sp_clone``), the adaptive step cache on ``{data: 2}`` (its
  gate's max over the data ranks: JAX's branches and drifts),
  ``ddim_sample_fewstep``, ``cold_sample`` and ``sample_from`` on ``{data:
  2}``, each against JAX's on the same mesh: atol 1e-4 (as
  tests/test_torch_port_samplers.py);
* a w8a8 model's ``ddim_sample`` on ``{data: 2}`` and ``{data: 2, seq: 2}``
  (Ulysses), unfused and fused: its per-tensor activation scale is the
  whole batch's (``quant.act_scale_over``), so the rows are the one-process
  call's within rtol = atol = 2e-5 (the int8 products are exact; the float
  GEMMs run at another row count) and JAX's mesh sampler's within atol
  1e-4. The fused Mlp requantizes its hidden activation per ``block_m``
  tile of the one-process call's rows: on a mesh each rank runs the whole
  tiles its rows touch (``quant.mlp_fused`` over the gathered activation),
  so the fused cases take the same limits. The one-process twin of a
  sequence-parallel model is its ``sp_clone`` over a mesh of one rank
  (the fused attention is gated off under sequence parallelism, as in
  JAX);
* the ``sample`` command's samples on ``{data: 2}``: every rank's whole
  batch bit for bit the one-process command's in that rank;
* the loader's shards against JAX's ``ShardedLoader`` (index for index).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ddim_cold_torch.data import ShardedLoader as PortLoader
from ddim_cold_torch.parallel.ulysses import SeqParallelConfigError as PortSPError
from ddim_cold_torch.parallel.ulysses import ulysses_self_attention as port_ulysses
from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.data import ShardedLoader
from ddim_cold_tpu.models import DiffusionViT, sp_clone
from ddim_cold_tpu.ops import quant as jax_quant
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.ops.losses import smooth_l1
from ddim_cold_tpu.parallel import make_mesh, shard_batch, shard_train_state
from ddim_cold_tpu.parallel.ring_attention import ring_self_attention
from ddim_cold_tpu.parallel.ulysses import SeqParallelConfigError, ulysses_self_attention
from ddim_cold_tpu.train.step import EmaTrainState, make_optimizer, make_train_step

WORLD = 4
DEADLINE_S = 90.0
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=1, num_heads=4,
            total_steps=8)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
LR, TOTAL = 1e-2, 10

SEQ2, SEQ4, DP2SP2, DP2 = {"seq": 2}, {"seq": 4}, {"data": 2, "seq": 2}, {"data": 2}

#: rank cases of ring and Ulysses attention: id → dist_cases.attention kwargs
ATTN = {
    "ring-seq2-17": dict(spec=SEQ2, fn="ring", N=17),
    "ring-seq4-16": dict(spec=SEQ4, fn="ring", N=16),
    "ring-dp2sp2-17": dict(spec=DP2SP2, fn="ring", N=17, batch_axis="data"),
    "ulysses-seq2-17": dict(spec=SEQ2, fn="ulysses", N=17),
    "ulysses-seq4-16-flash": dict(spec=SEQ4, fn="ulysses", N=16, use_flash=True),
    "ulysses-dp2sp2-17-xla": dict(spec=DP2SP2, fn="ulysses", N=17, use_flash="xla",
                                  batch_axis="data"),
    "ring-seq2-17-bf16": dict(spec=SEQ2, fn="ring", N=17, dtype="bfloat16", grad=False),
    "ulysses-dp2sp2-16-flash-bf16": dict(spec=DP2SP2, fn="ulysses", N=16,
                                         dtype="bfloat16", use_flash=True, grad=False,
                                         batch_axis="data"),
}

#: the model cases: id → (mesh, sp_mode asked, num_heads)
MODEL = {"ring-seq2": (SEQ2, "ring", 4), "ulysses-dp2sp2": (DP2SP2, "ulysses", 4),
         "fallback-seq4": (SEQ4, "ulysses", 2)}

#: the train-step cases: id → (mesh, sp_mode or None)
TRAIN = {"dp2": (DP2, None), "seq2-ulysses": (SEQ2, "ulysses"),
         "dp2sp2-ring": (DP2SP2, "ring")}

#: the adaptive gate's threshold in the cached case: between the two data
#: ranks' own step-1 drifts, so only the max over the whole batch (JAX's
#: global array) takes JAX's branches (the test checks that it lies between)
ADAPTIVE_TAU = 1.95e-3

#: the sampler cases: id → (mesh, sp_mode or None, sampler, its options,
#: model depth); the step cache needs two blocks
SAMPLE = {
    "dp2": (DP2, None, "ddim_sample", dict(k=2), 1),
    "dp2sp2-ulysses": (DP2SP2, "ulysses", "ddim_sample", dict(k=2), 1),
    "dp2-adaptive": (DP2, None, "ddim_sample",
                     dict(k=1, cache_interval=4, cache_mode="adaptive",
                          cache_threshold=ADAPTIVE_TAU, telemetry=True), 2),
    "dp2-fewstep": (DP2, None, "ddim_sample_fewstep", dict(steps=2), 1),
    "dp2-cold": (DP2, None, "cold_sample", dict(levels=3), 1),
    "dp2-from": (DP2, None, "sample_from", dict(t_start=6, k=2), 1),
}


#: the w8a8 cases: id → (mesh, sp_mode or None, fused); the tolerances
#: against the one-process call and against JAX (module docstring)
QUANT = {"dp2-w8a8": (DP2, None, False), "dp2sp2-w8a8": (DP2SP2, "ulysses", False),
         "dp2-w8a8-fused": (DP2, None, True),
         "dp2sp2-w8a8-fused": (DP2SP2, "ulysses", True)}
QUANT_TOL = {fused: dict(one=dict(rtol=2e-5, atol=2e-5), jax=dict(rtol=0, atol=1e-4))
             for fused in (False, True)}


def _jax_mesh(spec):
    n = int(np.prod(list(spec.values())))
    return make_mesh(dict(spec), devices=jax.devices()[:n])


def _inputs():
    rs = np.random.RandomState(3)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    t = np.array([0, 3, 5, 7], np.int32)
    batch = (rs.randn(8, 16, 16, 3).astype(np.float32),
             rs.randn(8, 16, 16, 3).astype(np.float32),
             rs.randint(1, 7, size=(8,)).astype(np.int32))
    return x, t, batch


def _second_batch():
    rs = np.random.RandomState(4)
    return (rs.randn(8, 16, 16, 3).astype(np.float32),
            rs.randn(8, 16, 16, 3).astype(np.float32),
            rs.randint(1, 7, size=(8,)).astype(np.int32))


def _params(cfg):
    model = DiffusionViT(**cfg)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32))["params"])


def _sd(params):
    return {k: v.numpy() for k, v in state_dict_from_flax(params, 4).items()}


@pytest.fixture(scope="module")
def world():
    """Every rank case, run once in one world of four gloo ranks: id → rank
    0's result (and, for the model cases, the JAX parameters used)."""
    x, t, batch = _inputs()
    params = {h: _params(dict(TINY, num_heads=h)) for h in (2, 4)}
    params["depth2"] = _params(dict(TINY, depth=2))
    cases, ids = [], []
    for key, kw in ATTN.items():
        ids.append(("attn", key))
        cases.append(("attention", kw))
    ids.append(("error", "local"))
    cases.append(("ulysses_heads_error", {"spec": SEQ2}))
    for key, (spec, mode, heads) in MODEL.items():
        ids.append(("model", key))
        cases.append(("model_forward", dict(
            spec=spec, cfg=dict(TINY, num_heads=heads, use_flash=True),
            state_dict=_sd(params[heads]), x=x, t=t, sp_mode=mode)))
    for key, (spec, mode) in TRAIN.items():
        ids.append(("train", key))
        cases.append(("train_steps", dict(
            spec=spec, cfg=dict(TINY, **NO_DROP, use_flash=True),
            state_dict=_sd(params[4]), batches=[batch], lr=LR, total_steps=TOTAL,
            sp_mode=mode)))
    # two steps in one dispatch on a data mesh: each rank's grouped batch is
    # its rows of both steps (shard_batch(grouped=True))
    ids.append(("train", "dp2-dispatch2"))
    cases.append(("train_steps", dict(
        spec=DP2, cfg=dict(TINY, **NO_DROP, use_flash=True), state_dict=_sd(params[4]),
        batches=[batch, _second_batch()], lr=LR, total_steps=TOTAL, steps_per_dispatch=2)))
    for key, (spec, mode, fn, kw, depth) in SAMPLE.items():
        ids.append(("sample", key))
        cases.append(("sample", dict(
            spec=spec, cfg=dict(TINY, depth=depth, use_flash=True),
            state_dict=_sd(params[4 if depth == 1 else "depth2"]), x_init=x, fn=fn,
            sp_mode=mode, **kw)))
    for key, (spec, mode, fused) in QUANT.items():
        ids.append(("quant", key))
        cases.append(("quant_sample", dict(
            spec=spec, cfg=dict(TINY, use_flash=True), state_dict=_sd(params[4]),
            x_init=x, quant="w8a8", fused=fused, sp_mode=mode, k=2)))
    ids.append(("cli", "sample"))
    cases.append(("cli_sample", dict(spec=DP2, cfg=dict(TINY, use_flash=True),
                                     state_dict=_sd(params[4]), x_init=x, acc_k=2)))
    results = dist_cases.run_world(cases, WORLD, device="cpu", timeout_s=DEADLINE_S)
    return {"by_id": {i: r[0] for i, r in zip(ids, results)}, "all": dict(zip(ids, results)),
            "params": params, "inputs": (x, t, batch),
            "jax_grad_norm": _jax_grad_norm(params[4], batch)}


def _jax_grad_norm(params, batch):
    """‖∇ smooth-L1‖ of the whole batch through JAX's one-device model: the
    norm JAX's ``clip_by_global_norm`` sees after its psum."""
    noisy, target, t = (jnp.asarray(a) for a in batch)
    model = DiffusionViT(**TINY, **NO_DROP)

    def loss(p):
        return smooth_l1(model.apply({"params": p}, noisy, t, deterministic=True), target)

    return float(optax.global_norm(jax.jit(jax.grad(loss))(params)))


# ------------------------------------------------------------ attention


def _jax_attention(kw):
    N, dtype = kw["N"], getattr(jnp, kw.get("dtype", "float32"))
    q, k, v, w = (jnp.asarray(a) for a in dist_cases.qkv_inputs(0, 4, N, 4, 8))
    mesh = _jax_mesh(kw["spec"])
    fn = ring_self_attention if kw["fn"] == "ring" else ulysses_self_attention
    opts = dict(axis="seq", batch_axis=kw.get("batch_axis"), scale=8**-0.5)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh, **opts).astype(jnp.float32) * w)

    q, k, v = (a.astype(dtype) for a in (q, k, v))
    out = jax.jit(lambda q, k, v: fn(q, k, v, mesh, **opts))(q, k, v)
    grads = (jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
             if kw.get("grad", True) else None)
    return np.asarray(out.astype(jnp.float32)), grads


@pytest.mark.parametrize("case", list(ATTN))
def test_attention_matches_jax(world, case):
    kw = ATTN[case]
    got = world["by_id"][("attn", case)]
    want, grads = _jax_attention(kw)
    if kw.get("dtype") == "bfloat16":
        ref = np.abs(want)
        limit = (2.0**-7 * ref + 2.0**-5 * ref.mean() if kw.get("use_flash")
                 else 2.0**-7 * ref + 2.0**-12)
        assert (np.abs(got["out"] - want) <= limit).all()
        return
    np.testing.assert_allclose(got["out"], want, rtol=2e-4, atol=2e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(g), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_every_rank_returns_the_whole_result(world):
    """The front ends gather: every rank of a mesh holds the same output and
    the same summed gradients, the two halves of the world alike."""
    for case in ATTN:
        ranks = world["all"][("attn", case)]
        for r in ranks[1:]:
            for key, val in r.items():
                np.testing.assert_array_equal(val, ranks[0][key], err_msg=f"{case} {key}")


class _StubMesh:
    mesh_dim_names = ("seq",)

    def size(self, dim):
        return 2


def test_seq_parallel_config_error_is_jaxs():
    q = np.zeros((1, 4, 3, 8), np.float32)
    with pytest.raises(SeqParallelConfigError) as want:
        ulysses_self_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                               _jax_mesh(SEQ2))
    import torch

    tq = torch.from_numpy(q)
    with pytest.raises(PortSPError) as got:
        port_ulysses(tq, tq, tq, _StubMesh())
    assert str(got.value) == str(want.value)
    assert issubclass(PortSPError, ValueError)


def test_local_ulysses_error_is_jaxs(world):
    """The local function's message, JAX's ``ulysses_attention`` words with
    its local head count and axis."""
    got = world["by_id"][("error", "local")]
    assert got == ("ulysses needs local heads (3) divisible by the 'seq' axis (2); "
                   "use sp_mode='ring' otherwise (serving: SamplerConfig("
                   "sp_mode='ring', sp_degree=...), or pick an sp_degree that "
                   "divides the local head count)")


# --------------------------------------------------------------- model


@pytest.mark.parametrize("case", list(MODEL))
def test_sequence_parallel_model_matches_jax(world, case):
    spec, mode, heads = MODEL[case]
    x, t, _ = world["inputs"]
    mesh = _jax_mesh(spec)
    cfg = dict(TINY, num_heads=heads, use_flash=True)
    base = DiffusionViT(**cfg)
    batch_axis = "data" if "data" in spec else None
    jmodel = sp_clone(base, mesh, sp_mode=mode, batch_axis=batch_axis)
    want = jax.jit(jmodel.apply)({"params": world["params"][heads]}, jnp.asarray(x),
                                 jnp.asarray(t))
    got = world["by_id"][("model", case)]
    assert got["sp_mode"] == jmodel.sp_mode == ("ring" if case.startswith("fallback")
                                                 else mode)
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------- train step


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_step_on_a_mesh_matches_jax(world, case):
    spec, mode = TRAIN[case]
    _, _, batch = world["inputs"]
    mesh = _jax_mesh(spec)
    kw = dict(TINY, **NO_DROP)  # JAX's dense route: the same step, no Pallas compile
    if mode is not None:
        kw.update(seq_mesh=mesh, seq_axis="seq", sp_mode=mode,
                  batch_axis="data" if "data" in spec else None)
    model = DiffusionViT(**kw)
    jb = tuple(map(jnp.asarray, batch))
    state = EmaTrainState.create(apply_fn=model.apply,
                                 params=jax.tree.map(jnp.asarray, world["params"][4]),
                                 tx=make_optimizer(LR, TOTAL), ema_params=None)
    state = shard_train_state(state.replace(step=jnp.asarray(0, jnp.int32)), mesh)
    step = make_train_step(model)
    state, loss, _ = step(state, shard_batch(jb, mesh), jax.random.PRNGKey(1),
                          jnp.float32(5.0))
    got = world["by_id"][("train", case)]
    assert got["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    assert got["grad_norms"][0] == pytest.approx(world["jax_grad_norm"], rel=1e-5)
    want = state_dict_from_flax(jax.device_get(state.params), 4)
    for name, val in got["params"].items():
        np.testing.assert_allclose(val, want[name].numpy(), rtol=1e-5, atol=3e-3 * LR,
                                   err_msg=name)


def test_grouped_dispatch_on_a_data_mesh_matches_jax(world):
    """``steps_per_dispatch=2`` on ``{data: 2}``: JAX's scan over a grouped
    batch whose dim 1 is sharded on ``data`` (``shard_batch(grouped=True)``),
    against the port's ranks each holding their rows of both steps; the
    mean loss and the parameters within the step tolerances above."""
    _, _, batch = world["inputs"]
    mesh = _jax_mesh(DP2)
    model = DiffusionViT(**TINY, **NO_DROP)
    stacked = tuple(jnp.stack(leaves) for leaves in zip(batch, _second_batch()))
    state = EmaTrainState.create(apply_fn=model.apply,
                                 params=jax.tree.map(jnp.asarray, world["params"][4]),
                                 tx=make_optimizer(LR, TOTAL), ema_params=None)
    state = shard_train_state(state.replace(step=jnp.asarray(0, jnp.int32)), mesh)
    step = make_train_step(model, steps_per_dispatch=2)
    state, loss, _ = step(state, shard_batch(stacked, mesh, grouped=True),
                          jax.random.PRNGKey(1), jnp.float32(5.0))
    got = world["by_id"][("train", "dp2-dispatch2")]
    assert len(got["losses"]) == 1
    assert got["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    want = state_dict_from_flax(jax.device_get(state.params), 4)
    for name, val in got["params"].items():
        np.testing.assert_allclose(val, want[name].numpy(), rtol=1e-5, atol=3e-3 * LR * 2,
                                   err_msg=name)


def test_train_step_ranks_agree(world):
    """Every rank applies the same update: parameters bit for bit equal."""
    for case in list(TRAIN) + ["dp2-dispatch2"]:
        ranks = world["all"][("train", case)]
        for r in ranks[1:]:
            assert r["losses"] == ranks[0]["losses"]
            for name, val in r["params"].items():
                np.testing.assert_array_equal(val, ranks[0]["params"][name])


# ------------------------------------------------------------- sampler


@pytest.mark.parametrize("case", list(SAMPLE))
def test_mesh_sampling_matches_jax(world, case):
    """Each sampler on the mesh against JAX's on the same mesh; the cached
    case also takes JAX's branches step for step, its drifts within rtol
    1e-4 (as tests/test_torch_port_cache.py)."""
    spec, mode, fn, kw, depth = SAMPLE[case]
    x, _, _ = world["inputs"]
    mesh = _jax_mesh(spec)
    jmodel = DiffusionViT(**dict(TINY, depth=depth), use_flash=True)
    if mode is not None:
        jmodel = sp_clone(jmodel, mesh, sp_mode=mode)
    params = world["params"][4 if depth == 1 else "depth2"]
    want = getattr(sampling, fn)(jmodel, params, x_init=jnp.asarray(x), mesh=mesh, **kw)
    got = world["by_id"][("sample", case)]
    if kw.get("telemetry"):
        want, tel = want
        assert got["branch"] == np.asarray(tel.branch).tolist()
        np.testing.assert_allclose(got["drift"], np.asarray(tel.drift), rtol=1e-4,
                                   atol=1e-6)
        # each data rank's rows alone would gate on either side of tau
        halves = [np.asarray(sampling.ddim_sample(
            jmodel, params, x_init=jnp.asarray(x[i:i + 2]), **kw)[1].drift)[1]
            for i in (0, 2)]
        assert min(halves) < ADAPTIVE_TAU <= max(halves), halves
    assert got["images"].shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got["images"], np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", list(QUANT))
def test_w8a8_scale_on_a_mesh_is_the_whole_batchs(world, case):
    """A w8a8 model sampled on a mesh: every rank's whole batch against the
    one-process call in that rank and against JAX's mesh sampler (which
    quantizes the global array); the tolerances are the module
    docstring's."""
    spec, mode, fused = QUANT[case]
    x, _, _ = world["inputs"]
    mesh = _jax_mesh(spec)
    jmodel = DiffusionViT(**TINY, use_flash=True).clone(quant="w8a8", fused=fused)
    if mode is not None:
        jmodel = sp_clone(jmodel, mesh, sp_mode=mode)
    want = np.asarray(sampling.ddim_sample(
        jmodel, jax_quant.quantize_params(world["params"][4]), x_init=jnp.asarray(x),
        mesh=mesh, k=2))
    tol = QUANT_TOL[fused]
    for rank, got in enumerate(world["all"][("quant", case)]):
        assert got["mesh"].shape == (4, 16, 16, 3)
        np.testing.assert_allclose(got["mesh"], got["one"], **tol["one"],
                                   err_msg=f"rank {rank} against one process")
        np.testing.assert_allclose(got["mesh"], want, **tol["jax"],
                                   err_msg=f"rank {rank} against JAX")


def test_sample_command_over_a_data_mesh(world):
    """The ``sample`` command's samples over ``{data: 2}`` (what it runs with
    one process per card): on every rank the whole batch, bit for bit the
    one-process command's."""
    ranks = world["all"][("cli", "sample")]
    assert len(ranks) == WORLD
    for r in ranks:
        assert r["mesh"].shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(r["mesh"], r["one"])
        np.testing.assert_array_equal(r["mesh"], ranks[0]["mesh"])


# -------------------------------------------------------------- loader


class _Ids:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,world_size,shuffle,drop_last", [
    (10, 2, True, True), (10, 4, False, False), (11, 3, True, False), (7, 4, False, True)])
def test_loader_shards_match_jax(n, world_size, shuffle, drop_last):
    """Each shard's batches hold JAX's indices (``indices[shard::world]``
    after the cut or the wrap-around pad), epoch by epoch."""
    for shard in range(world_size):
        kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, shard_index=shard,
                  shard_count=world_size, pad_final_batch=not drop_last)
        port, jax_loader = PortLoader(_Ids(n), 2, **kw), ShardedLoader(_Ids(n), 2, **kw)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            assert len(port) == len(jax_loader)
            got, want = port._batches(), jax_loader._batches()
            assert [b.tolist() for b in got] == [b.tolist() for b in want]
