"""The port's Switch-MoE model family against the JAX package's, on the CPU.

JAX runs on the CPU at float32 matmul precision (tests/conftest.py); its
parameters come from its own init on numpy inputs made from a seed and reach
the port through ``utils.weights.state_dict_from_flax``. The port runs the
flash kernels' plain versions, JAX its dense attention.

* ``SwitchMlp`` (B=2, N=17, D=16, E=4, H=24), both dispatches, at capacity
  factors 1.25 and 0.5 (tokens overflow): each token's expert and the kept
  set exactly JAX's (a kept token's output is non-zero, a dropped one's
  exactly 0), y and the load-balance aux within 1e-5, the gradients of
  ``Σ y·w + aux`` for x and every parameter within 1e-4; the index dispatch
  the einsum one within 1e-6.
* ``DiffusionViT(num_experts=2 and 4)`` forwards and their aux (the mean
  over layers) in the unrolled and ``scan_blocks`` layouts, with ``remat``
  under autograd: within 1e-5 of JAX's; a token-cache and a delta-cache
  ``ddim_sample`` and a delta-cache ``cold_sample`` from JAX's start within
  1e-4 (the cached samplers' tolerance, tests/test_torch_port_cache.py); an
  ``Engine``'s rows bit for bit the direct call at the bucket shape, no
  program after warmup.
* One ``moe_aux_weight=0.01`` train step against JAX's: the loss rtol 1e-5,
  the parameters within JAX's own ``test_moe`` tolerance (rtol 5e-4, atol
  1e-5).
* One spawned gloo world of four CPU ranks (``tools/dist_cases.run_world``)
  runs ``{data: 2, expert: 2}``, ``{expert: 2}``, ``{seq: 2, expert: 2}`` in
  ring and Ulysses and ``{pipe: 2, expert: 2}``: one step each against the
  one-process port step at rtol 5e-4 / atol 1e-5, loss and ‖g‖ included.
  The pipelined aux is a mean of per-microbatch terms (JAX
  pipeline.py:80-95), so the pipe case steps at ``moe_aux_weight=0`` and
  its aux is held at 1e-6 against the mean of the one-process model's aux
  over the same microbatches. JAX's errors: pipe×seq×MoE and an ``expert``
  axis that does not divide ``num_experts``. The same world serves the
  model through ``Engine(mesh={data: 2, seq: 2})``, data mesh and Ulysses
  ``sp_degree=2``: the one-process engine's rows within 2e-5.
* The trainer at TINY with ``num_experts: 2``: JAX's run-dir surface (no
  ``.pkl``), the warm-start fallback (JAX's log line; the next run reads the
  file back), and an ``{expert: 2}`` run's gathered checkpoint loaded
  strict in one process.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.config import ExperimentConfig
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.models import moe as port_moe
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.train import step as port_step
from ddim_cold_torch.train import trainer as port_trainer
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.models.moe import SwitchMlp
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.parallel import make_mesh, make_pipelined_apply
from ddim_cold_tpu.train.step import create_train_state, make_train_step
from ddim_cold_tpu.utils.checkpoint import stack_block_params

B, N, D, E, H = 2, 17, 16, 4, 24
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=16, depth=2, num_heads=2,
            total_steps=2000)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
LR = 1e-2
JAX_TOL = dict(rtol=5e-4, atol=1e-5)  # tests/test_moe.py's step tolerance
APPROX = dict(rel=5e-4, abs=1e-5)
WORLD = 4
#: the mesh cases: id → (mesh, sp_mode, dispatch, moe_aux_weight)
MESHES = {
    "dp2ep2": ({"data": 2, "expert": 2}, None, "einsum", 0.01),
    "ep2": ({"expert": 2}, None, "index", 0.01),
    "sp2ep2-ring": ({"seq": 2, "expert": 2}, "ring", "einsum", 0.01),
    "sp2ep2-ulysses": ({"seq": 2, "expert": 2}, "ulysses", "index", 0.01),
    "pp2ep2": ({"pipe": 2, "expert": 2}, None, "einsum", 0.0),
}
MESH_CFG = dict(TINY, **NO_DROP, use_flash=True, num_experts=4, moe_capacity_factor=1.0)
#: the engine across ranks: the data mesh and Ulysses at sp_degree 2, k=400
SERVE_CONFIGS = [dict(k=400), dict(k=400, sp_mode="ulysses", sp_degree=2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """TINY forwards at one intra-op thread beside JAX (the suite runs six
    workers on the box's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().float().cpu().numpy()


def _batch(b=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, 16, 16, 3).astype(np.float32),
            rs.randn(b, 16, 16, 3).astype(np.float32),
            rs.randint(1, 7, size=(b,)).astype(np.int32))


# ------------------------------------------------------------ SwitchMlp


@pytest.fixture(scope="module")
def mlp_inputs():
    rs = np.random.RandomState(0)
    x = rs.randn(B, N, D).astype(np.float32)
    w = rs.randn(B, N, D).astype(np.float32)
    m = SwitchMlp(num_experts=E, hidden_features=H, out_features=D, drop=0.0)
    params = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    return x, w, params


def _jax_mlp(mlp_inputs, dispatch, cf):
    """JAX's y, aux and the gradients of Σ y·w + aux (params, x)."""
    x, w, params = mlp_inputs
    m = SwitchMlp(num_experts=E, hidden_features=H, out_features=D, capacity_factor=cf,
                  drop=0.0, dispatch=dispatch)

    def f(p, xs):
        y, sown = m.apply({"params": p}, xs, mutable=["losses"])
        aux = jax.tree.leaves(sown["losses"])[0]
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(y), float(aux), jax.device_get(grads)


def _port_mlp(mlp_inputs, dispatch, cf):
    x, w, params = mlp_inputs
    m = port_moe.SwitchMlp(D, E, H, D, capacity_factor=cf, dispatch=dispatch)
    m.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()},
                      strict=True)
    xs = torch.from_numpy(x).requires_grad_(True)
    records = []
    y = m(xs, losses=records)
    aux = port_moe.mean_load_balance(records)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    return m, xs, y, aux, records


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", ["einsum", "index"])
def test_switch_mlp_matches_jax(mlp_inputs, dispatch, cf):
    x, _, params = mlp_inputs
    want_y, want_aux, (g_params, g_x) = _jax_mlp(mlp_inputs, dispatch, cf)
    m, xs, y, aux, records = _port_mlp(mlp_inputs, dispatch, cf)
    # routing: the expert of every token, then the kept set
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(params["router"]), -1))
    want_e = probs.argmax(-1)
    got_e = m.route(torch.from_numpy(x))[1].numpy()
    top2 = np.sort(probs, -1)[..., -2:]
    assert np.array_equal(got_e, want_e), (
        f"routing differs; top-2 probability gap at the differing tokens "
        f"{(top2[..., 1] - top2[..., 0])[got_e != want_e]}")
    kept = (_np(y) != 0).any(-1)
    assert np.array_equal(kept, (want_y != 0).any(-1))
    dropped = 1.0 - float(records[0].kept.sum() / records[0].count)
    assert dropped == pytest.approx(1.0 - kept.mean(), abs=1e-7)
    if cf < 1:
        assert not kept.all()  # tokens overflowed
    np.testing.assert_allclose(_np(y), want_y, rtol=1e-5, atol=1e-5)
    assert aux.item() == pytest.approx(want_aux, rel=1e-5, abs=1e-5)
    np.testing.assert_allclose(_np(xs.grad), np.asarray(g_x), rtol=1e-4, atol=1e-4)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(g_params[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_index_dispatch_is_the_einsum_one(mlp_inputs, cf):
    a = _port_mlp(mlp_inputs, "einsum", cf)
    b = _port_mlp(mlp_inputs, "index", cf)
    np.testing.assert_allclose(_np(b[2]), _np(a[2]), rtol=0, atol=1e-6)
    assert b[3].item() == pytest.approx(a[3].item(), abs=1e-6)
    np.testing.assert_allclose(_np(b[1].grad), _np(a[1].grad), rtol=0, atol=1e-6)
    for (name, p), q in zip(a[0].named_parameters(), b[0].parameters()):
        np.testing.assert_allclose(_np(q.grad), _np(p.grad), rtol=0, atol=1e-6, err_msg=name)
    torch.testing.assert_close(b[4][0].kept, a[4][0].kept, rtol=0, atol=0)


# --------------------------------------------------------- the model


@pytest.fixture(scope="module")
def jax_params():
    """JAX's unrolled init of the E = 2 and E = 4 models (the dispatch adds
    no parameter)."""
    x, _, t = _batch()
    out = {}
    for e in (2, 4):
        model = DiffusionViT(**TINY, **NO_DROP, num_experts=e)
        out[e] = jax.device_get(jax.jit(model.init)(
            jax.random.PRNGKey(e), jnp.asarray(x), jnp.asarray(t))["params"])
    return out


def _port(params, **kw):
    m = PortViT(**TINY, **NO_DROP, device="cpu", **kw)
    m.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]), strict=True)
    return m


@pytest.mark.parametrize("e,dispatch,scan", [(2, "einsum", False), (2, "index", True),
                                             (4, "index", False), (4, "einsum", True)])
def test_model_forward_and_aux_match_jax(jax_params, e, dispatch, scan):
    """Unrolled, and stacked with remat (run under autograd, so the port's
    blocks rematerialise): the forward and the mean aux over layers."""
    x, _, t = _batch()
    params = jax_params[e]
    jm = DiffusionViT(**TINY, **NO_DROP, num_experts=e, moe_dispatch=dispatch,
                      scan_blocks=scan, remat=scan)
    out, sown = jm.apply({"params": stack_block_params(params) if scan else params},
                         jnp.asarray(x), jnp.asarray(t), mutable=["losses"])
    leaves = jax.tree.leaves(sown["losses"])
    want_aux = float(sum(jnp.sum(s) for s in leaves) / sum(s.size for s in leaves))
    pm = _port(params, num_experts=e, moe_dispatch=dispatch, scan_blocks=scan, remat=scan)
    assert {k for k in pm.state_dict() if ".moe." in k} == {
        f"blocks.{i}.moe.{leaf}" for i in range(2) for leaf in ("router", "w1", "b1", "w2",
                                                              "b2")}
    records = []
    with torch.enable_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t), losses=records)
    assert len(records) == TINY["depth"]
    np.testing.assert_allclose(_np(got), np.asarray(out), rtol=1e-5, atol=1e-5)
    assert port_moe.mean_load_balance(records).item() == pytest.approx(want_aux, rel=1e-5,
                                                                       abs=1e-5)


@pytest.mark.parametrize("sampler,mode", [
    ("ddim", dict(cache_interval=2)),
    ("ddim", dict(cache_interval=2, cache_mode="token", cache_tokens=9)),
    ("cold", dict(cache_interval=2))], ids=["ddim-delta", "ddim-token", "cold-delta"])
def test_cached_sampling_matches_jax(jax_params, sampler, mode):
    """The step cache over expert banks (the token cache routes its 9 live
    tokens, capacity from 9), from JAX's start: DDIM 5 steps, cold 5
    levels."""
    x = np.random.RandomState(5).randn(2, 16, 16, 3).astype(np.float32)
    params = jax_params[4]
    jm = DiffusionViT(**TINY, **NO_DROP, num_experts=4, moe_capacity_factor=0.5)
    pm = _port(params, num_experts=4, moe_capacity_factor=0.5)
    if sampler == "ddim":
        want = sampling.ddim_sample(jm, params, x_init=jnp.asarray(x), k=400, **mode)
        got = port_sampling.ddim_sample(pm, x_init=x, k=400, device="cpu", **mode)
    else:
        want = sampling.cold_sample(jm, params, x_init=jnp.asarray(x), levels=5, **mode)
        got = port_sampling.cold_sample(pm, x_init=x, levels=5, device="cpu", **mode)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)


def test_engine_rows_are_the_direct_call(jax_params):
    """``Engine`` over the expert-bank model: three requests in one bucket-4
    batch, each row bit for bit the direct ``ddim_sample`` on that batch (its
    start at its offset, zero padding), no program after warmup."""
    from ddim_cold_torch import serve

    model = _port(jax_params[2], num_experts=2, moe_capacity_factor=0.5)
    eng = serve.Engine(model, buckets=(4,), device="cpu")
    config = serve.SamplerConfig(k=400)
    serve.warmup(eng, [config])
    programs = eng.stats["programs"]
    starts = np.random.RandomState(6).randn(3, 16, 16, 3).astype(np.float32)
    tickets = [eng.submit(x_init=starts[i:i + 1], config=config) for i in range(3)]
    assert eng.run()["batches"] == 1
    x = np.concatenate([starts, np.zeros_like(starts[:1])])
    want = _np(port_sampling.ddim_sample(model, x_init=x, k=400, device="cpu"))
    for i, ticket in enumerate(tickets):
        np.testing.assert_array_equal(ticket.result(timeout=60), want[i:i + 1])
    assert eng.stats["programs"] == programs


def test_aux_weighted_train_step_matches_jax():
    batch = _batch()
    jm = DiffusionViT(**TINY, **NO_DROP, num_experts=4)
    st = create_train_state(jm, jax.random.PRNGKey(0), LR, 10, tuple(map(jnp.asarray, batch)))
    pm = _port(jax.device_get(st.params), num_experts=4)
    pst = port_step.create_train_state(pm, LR, 10)
    st, jl, _ = make_train_step(jm, moe_aux_weight=0.01)(
        st, tuple(map(jnp.asarray, batch)), jax.random.PRNGKey(1), jnp.float32(5.0))
    pst, pl, _ = port_step.make_train_step(pm, moe_aux_weight=0.01)(
        pst, tuple(map(torch.from_numpy, batch)), torch.Generator(), torch.tensor(5.0))
    assert float(pl) == pytest.approx(float(jl), rel=1e-5)
    want = state_dict_from_flax(jax.device_get(st.params), TINY["patch_size"])
    for name, p in zip(pst.names, pst.params):
        np.testing.assert_allclose(_np(p), want[name].numpy(), err_msg=name, **JAX_TOL)


# ------------------------------------------------------- across ranks


@pytest.fixture(scope="module")
def world(jax_params):
    """Every mesh case in one world of four gloo ranks: id → every rank's
    result."""
    sd = {k: v.numpy() for k, v in state_dict_from_flax(jax_params[4], 4).items()}
    batch = _batch()
    cases = []
    for key, (spec, mode, dispatch, weight) in MESHES.items():
        cases.append(("tp_pp_train", dict(
            spec=spec, cfg=dict(MESH_CFG, moe_dispatch=dispatch), state_dict=sd,
            batches=[batch], lr=LR, total_steps=10, sp_mode=mode, moe_aux_weight=weight,
            aux_inputs=(batch[0], batch[2]) if "pipe" in spec else None)))
    cases.append(("moe_errors", dict(cfg=MESH_CFG)))
    cases.append(("serve_engine", dict(
        spec={"data": 2, "seq": 2}, cfg=dict(MESH_CFG, moe_capacity_factor=0.5),
        state_dict=sd, buckets=(2, 4), configs=SERVE_CONFIGS,
        requests=[(0, _batch(3, seed=7)[0]), (1, _batch(4, seed=8)[0])])))
    results = dist_cases.run_world(cases, WORLD, device="cpu", timeout_s=100.0)
    return dict(zip(list(MESHES) + ["errors", "serve"], results)), sd


def _one_process(sd, dispatch, weight):
    model = PortViT(**MESH_CFG, moe_dispatch=dispatch, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    state = port_step.create_train_state(model, LR, 10)
    state, loss, _ = port_step.make_train_step(model, moe_aux_weight=weight)(
        state, tuple(map(torch.from_numpy, _batch())), torch.Generator(), torch.tensor(5.0))
    return model, float(loss), float(state.grad_norm), dict(zip(state.names, state.params))


@pytest.mark.parametrize("key", list(MESHES))
def test_mesh_step_matches_one_process(world, key):
    results, sd = world
    spec, _, dispatch, weight = MESHES[key]
    model, loss, norm, params = _one_process(sd, dispatch, weight)
    for rank, got in enumerate(results[key]):
        assert got["losses"][0] == pytest.approx(loss, **APPROX), rank
        assert got["grad_norms"][0] == pytest.approx(norm, **APPROX), rank
        assert got["params"].keys() == params.keys()
        for name, p in params.items():
            np.testing.assert_allclose(got["params"][name], _np(p), err_msg=f"{rank} {name}",
                                       **JAX_TOL)
    if "pipe" not in spec:  # each rank held half the experts of every bank
        whole = sum(p.numel() for p in model.parameters())
        banks = sum(p.numel() for n, p in model.named_parameters()
                    if ".moe.w" in n or ".moe.b" in n)
        assert {got["local_numel"] for got in results[key]} == {whole - banks // 2}
    else:
        x, _, t = _batch()
        model = PortViT(**MESH_CFG, moe_dispatch=dispatch, device="cpu")  # before the step
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        micro = []
        with torch.no_grad():
            for j in range(2):
                records = []
                model(torch.from_numpy(x[2 * j:2 * j + 2]), torch.from_numpy(t[2 * j:2 * j + 2]),
                      losses=records)
                micro.append(float(port_moe.mean_load_balance(records)))
        for got in results[key]:
            assert got["aux"] == pytest.approx(np.mean(micro), rel=1e-6, abs=1e-6)


def test_engine_across_ranks_serves_moe(world):
    """``Engine(mesh=)`` over the four ranks with the Switch-MoE model
    (capacity 0.5: tokens drop): the data-mesh and the Ulysses ``sp_degree=2``
    rows are the one-process engine's within 2e-5 (the engine's own
    tolerance, tests/test_torch_port_serve_mesh.py), no program after
    warmup on any rank."""
    ranks = world[0]["serve"]
    lead = ranks[0]
    assert lead["report"]["failed_tickets"] == 0
    assert lead["sp_modes"] == [None, "ulysses"]
    for got, one in zip(lead["rows"], lead["one_process"]):
        np.testing.assert_allclose(got, one, rtol=2e-5, atol=2e-5)
    assert all(r["programs_after_warmup"] == 0 for r in ranks)


def test_jax_moe_errors_across_ranks(world, jax_params):
    errors = world[0]["errors"][0]
    assert "expert' axis of 2 needs num_experts (got 3)" in errors["expert"]
    jm = DiffusionViT(**TINY, **NO_DROP, num_experts=4, scan_blocks=True)
    x, _, t = _batch()
    apply_fn = make_pipelined_apply(jm, make_mesh({"pipe": 2, "seq": 2},
                                                  devices=jax.devices()[:4]))
    with pytest.raises(ValueError) as jax_err:
        apply_fn({"params": stack_block_params(jax_params[4])}, jnp.asarray(x),
                 jnp.asarray(t))
    assert errors["pipe_seq"] == str(jax_err.value)


# ------------------------------------------------------------- trainer


def _config(data_dir, **kw):
    kw = dict(dict(framework="port"), **kw)
    return ExperimentConfig(
        exp_name="moe", batch_size=2, epoch=(0, 1), base_lr=0.005,
        data_storage=(data_dir, data_dir), image_size=(16, 16), patch_size=8,
        embed_dim=32, depth=2, head=2, use_flash=True, num_experts=2, **kw)


def test_trainer_run_dir_and_warm_start_fallback(tmp_path, synthetic_image_dir,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~6 s of TF
    base = str(tmp_path)
    cfg = _config(synthetic_image_dir, initializing="moe_init.pkl")
    result = port_trainer.run(cfg, base, log_every=2, device="cpu")
    assert result.steps == 5 and math.isfinite(result.last_val_loss)
    files = set(os.listdir(result.run_dir))
    assert {"train.log", "bestloss.ckpt", "lastepoch.ckpt"} <= files
    assert not any(f.endswith(".pkl") for f in files)  # no reference layout
    log = open(os.path.join(result.run_dir, "train.log")).read()
    assert "init pkl export unavailable" in log
    init = os.path.join(base, "Saved_Models", "moe_init.pkl")
    assert os.path.isfile(init)
    saved = port_ckpt.load_torch_pkl(init)
    assert any(".moe." in k for k in saved)
    # the next run reads the persisted init back
    again = port_trainer.run(_config(synthetic_image_dir, initializing="moe_init.pkl",
                                     framework="again"), base, log_every=2, device="cpu")
    assert "init pkl export unavailable" not in open(
        os.path.join(again.run_dir, "train.log")).read()
    model = port_trainer.build_model(cfg, device="cpu")
    model.load_state_dict(port_ckpt.load_checkpoint(
        os.path.join(result.run_dir, "bestloss.ckpt")), strict=True)


def test_expert_run_checkpoint_loads_in_one_process(tmp_path, synthetic_image_dir,
                                                    monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # TensorBoard off in the ranks (its TensorFlow import costs each ~17 s):
    # spawned ranks take this process's sys.path, a refusing stub first
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("TensorBoard is off here")\n')
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    cfg = _config(synthetic_image_dir, mesh={"expert": 2})
    result = port_trainer.run(cfg, str(tmp_path), log_every=2, device="cpu")
    assert result.steps == 5 and math.isfinite(result.last_val_loss)
    log = open(os.path.join(result.run_dir, "train.log")).read()
    assert "mesh {'expert': 2}" in log
    one = port_trainer.build_model(cfg, device="cpu")
    for name in ("bestloss.ckpt", "lastepoch.ckpt"):
        got = port_ckpt.load_checkpoint(os.path.join(result.run_dir, name))
        one.load_state_dict(got if name == "bestloss.ckpt" else got["params"], strict=True)
    assert one.blocks[0].moe.w1.shape[0] == 2  # both experts, gathered
