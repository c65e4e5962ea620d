"""Tensor and pipeline parallelism of the port against the JAX package's, on
the CPU.

One module-scoped fixture spawns ONE gloo world of four CPU ranks
(``ddim_cold_torch/tools/dist_cases.run_world``: one intra-op thread each,
a free local port, a deadline well under two minutes) that runs every rank
case; the JAX references run in this process on the suite's virtual CPU
devices at float32 matmul precision (tests/conftest.py), as
``tests/test_sharding.py`` and ``tests/test_pipeline.py`` run them, on the
same numpy inputs. JAX's parameters (a ``scan_blocks`` tree) reach the port
through ``utils.weights.state_dict_from_flax``. The port runs the flash
kernels' plain versions, JAX its dense attention (the same function; no
Pallas compile).

* the shard plan (``parallel.sharding``) against JAX's
  ``param_partition_specs`` (unrolled tree) and ``pipeline_param_specs``
  (stacked tree, with and without the tensor axis), leaf by leaf through
  the bridge's names: a flax kernel's spec, transposed, is the torch
  weight's; float and w8a16 trees;
* ``shard_state_dict`` then ``gather_state_dict`` on ``{pipe: 2, model:
  2}``, ``{data: 2, model: 2}`` and ``{pipe: 4}``: the whole state_dict
  back bit for bit, in its key order, and each rank's part the plan's;
* the model's forward and the gradient of ``mean(x̂0²)`` over the whole
  batch, reduced as the train step reduces them (``train.step._Reducer``),
  on ``{data: 2, model: 2}`` (tp; JAX's forward with the params sharded by
  its specs, ``test_tp_forward_matches_replicated``), ``{data: 2, pipe:
  2}`` and ``{pipe: 4}`` at M = 2 and 4, ``{pipe: 2, model: 2}``, ``{pipe:
  2, seq: 2}`` in ring and Ulysses and with remat (JAX's
  ``make_pipelined_apply`` on the same mesh; M changes no value, remat
  none), and ``{seq: 2, model: 2}`` in ring and Ulysses (JAX's ``sp_clone(
  head_axis="model")``): forward and gradients atol 1e-5 (JAX's own
  pipeline tests' tolerance), ‖g‖ rtol 1e-5;
* two train steps on ``{data: 2, model: 2}`` with the EMA shadow
  (``test_tp_dp_train_step_matches``, ``test_ema_shadow_cosharded_under_tp_
  mesh``): losses rtol 1e-5, the first step's ‖g‖ against JAX's over the
  whole batch rtol 1e-5, parameters and EMA atol 3e-3·lr + rtol 1e-5 (as
  tests/test_torch_port_parallel.py); each rank holds its shard of the
  parameters and as many moment and EMA elements;
* ``ddim_sample`` of ``sp_clone(head_axis="model")`` on ``{seq: 2, model:
  2}`` (Ulysses) against JAX's: atol 1e-4 (as
  tests/test_torch_port_samplers.py); its attention probe at layers 0 and
  −1, every head's whole weights on every rank, against JAX's probe
  (tests/test_torch_port_sp_token.py holds the probe on ``{seq: 2}``);
* JAX's errors: depth % stages, batch % microbatches, a non-sp model under
  ``seq_axis``, Ulysses' local heads, grad_accum × pipe, the microbatch
  split over ``data``, quant/step cache/token cache/probe under
  ``scan_blocks``; the Switch-MoE plan against JAX's specs and JAX's
  expert-axis error (tests/test_torch_port_moe.py holds the rest of MoE);
* ``python -m ddim_cold_torch train`` on ``{data: 2, pipe: 2}``
  (microbatches 2) and ``{model: 2, pipe: 2}`` (batch 4; JAX's
  ``test_pipeline_training_end_to_end``,
  ``test_pipeline_trainer_composes_with_tp``): every checkpoint holds the
  one-process state_dict, loads strict into a one-process model and, through
  JAX's bridge, gives JAX's model the port's forward (atol 1e-5); a
  ``{data: 2, pipe: 2}`` run stopped after its first epoch and resumed on
  its own layout is bit for bit the uninterrupted one, and resumed on
  ``{model: 2, pipe: 2}`` within Adam's update bound of it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ddim_cold_torch import __main__ as cli
from ddim_cold_torch.config import ExperimentConfig, load_config
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import quant as port_quant
from ddim_cold_torch.parallel import sharding
from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.train import trainer as port_trainer
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT, sp_clone
from ddim_cold_tpu.ops import quant as jax_quant
from ddim_cold_tpu.ops.losses import smooth_l1
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.parallel import (make_mesh, make_pipelined_apply, param_partition_specs,
                                    pipeline_param_specs, shard_batch, shard_params,
                                    shard_train_state)
from ddim_cold_tpu.train.step import EmaTrainState, make_optimizer, make_train_step
from ddim_cold_tpu.utils.checkpoint import flax_from_torch_state_dict, stack_block_params

WORLD = 4
DEADLINE_S = 100.0
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=4, num_heads=4,
            total_steps=8)
NO_DROP = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
PORT_CFG = dict(TINY, **NO_DROP, use_flash=True)
LR, TOTAL, EMA = 1e-2, 10, 0.9
ATOL = 1e-5

#: the forward-and-gradient cases: id → (mesh, sp_mode or None, M, remat,
#: the JAX reference: "plain", "tp" (params sharded by JAX's specs) or the
#: pipelined apply's (mesh, sp_mode))
GRADS = {
    "dp2tp2": ({"data": 2, "model": 2}, None, 2, False, "tp"),
    "dp2pp2-m2": ({"data": 2, "pipe": 2}, None, 2, False, ("dp2pp2", None)),
    "dp2pp2-m4": ({"data": 2, "pipe": 2}, None, 4, False, ("dp2pp2", None)),
    "pp4-m2": ({"pipe": 4}, None, 2, False, ("pp4", None)),
    "pp4-m4": ({"pipe": 4}, None, 4, False, ("pp4", None)),
    "pp2tp2": ({"pipe": 2, "model": 2}, None, 2, False, ("pp2tp2", None)),
    "pp2sp2-ring": ({"pipe": 2, "seq": 2}, "ring", 2, False, ("pp2sp2", "ring")),
    "pp2sp2-ulysses": ({"pipe": 2, "seq": 2}, "ulysses", 2, False, ("pp2sp2", "ulysses")),
    "pp2sp2-ring-remat": ({"pipe": 2, "seq": 2}, "ring", 2, True, ("pp2sp2", "ring")),
    "sp2tp2-ring": ({"seq": 2, "model": 2}, "ring", 2, False, "plain"),
    "sp2tp2-ulysses": ({"seq": 2, "model": 2}, "ulysses", 2, False, "plain"),
}
#: the JAX pipelined applies those cases are held against: id → (mesh, M)
JAX_PIPES = {"dp2pp2": ({"data": 2, "pipe": 2}, 2), "pp4": ({"pipe": 4}, 4),
             "pp2tp2": ({"pipe": 2, "model": 2}, 2), "pp2sp2": ({"pipe": 2, "seq": 2}, 2)}
#: the sp×tp forwards held against JAX's sp_clone(head_axis="model")
SPTP = ("sp2tp2-ring", "sp2tp2-ulysses")
ROUND_TRIPS = ({"pipe": 2, "model": 2}, {"data": 2, "model": 2}, {"pipe": 4})
#: the layers the probe under ``head_axis`` reads
PROBE_LAYERS = (0, -1)
DROP_SEED = 11


def _jax_mesh(spec):
    n = int(np.prod(list(spec.values())))
    return make_mesh(dict(spec), devices=jax.devices()[:n])


def _inputs():
    rs = np.random.RandomState(5)
    x = rs.randn(8, 16, 16, 3).astype(np.float32)
    t = rs.randint(0, 8, size=(8,)).astype(np.int32)
    batch = (rs.randn(8, 16, 16, 3).astype(np.float32),
             rs.randn(8, 16, 16, 3).astype(np.float32),
             rs.randint(1, 7, size=(8,)).astype(np.int32))
    return x, t, batch


@pytest.fixture(scope="module")
def params():
    """JAX's stacked (scan_blocks) init and the same tree unrolled."""
    x, t, _ = _inputs()
    model = DiffusionViT(scan_blocks=True, **TINY, **NO_DROP)
    stacked = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 jnp.asarray(t))["params"])
    unrolled = DiffusionViT(**TINY, **NO_DROP)
    flat = jax.device_get(jax.jit(unrolled.init)(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                                                 jnp.asarray(t[:2]))["params"])
    return {"stacked": stacked, "unrolled": flat}


def _sd(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(tree, 4).items()}


@pytest.fixture(scope="module")
def world(params):
    """Every rank case, run once in one world of four gloo ranks: id → every
    rank's result."""
    x, t, batch = _inputs()
    sd = _sd(params["stacked"])
    cases, ids = [], []
    for spec in ROUND_TRIPS:
        ids.append(("round", tuple(spec)))
        cases.append(("shard_round_trip", dict(spec=spec, state_dict=sd)))
    for key, (spec, mode, micro, remat, _) in GRADS.items():
        ids.append(("grads", key))
        cases.append(("tp_pp_grads", dict(spec=spec, cfg=dict(PORT_CFG, remat=remat),
                                          state_dict=sd, x=x, t=t, sp_mode=mode,
                                          n_microbatch=micro)))
    ids.append(("grads", "tp2-dropout"))
    cases.append(("tp_pp_grads", dict(spec={"model": 2}, cfg=dict(TINY, use_flash=True),
                                      state_dict=sd, x=x, t=t, seed=DROP_SEED)))
    ids.append(("train", "dp2tp2"))
    cases.append(("tp_pp_train", dict(spec={"data": 2, "model": 2}, cfg=PORT_CFG,
                                      state_dict=sd, batches=[batch, batch], lr=LR,
                                      total_steps=TOTAL, ema_decay=EMA)))
    # two steps in one dispatch through the pipelined apply, EMA on
    ids.append(("train", "dp2pp2-dispatch2"))
    cases.append(("tp_pp_train", dict(spec={"data": 2, "pipe": 2}, cfg=PORT_CFG,
                                      state_dict=sd, batches=[batch, batch], lr=LR,
                                      total_steps=TOTAL, ema_decay=EMA,
                                      steps_per_dispatch=2)))
    ids.append(("sample", "sp2tp2-ulysses"))
    cases.append(("sample", dict(spec={"seq": 2, "model": 2}, cfg=dict(TINY, use_flash=True),
                                 state_dict=sd, x_init=x[:4], sp_mode="ulysses",
                                 head_axis="model", k=2)))
    ids.append(("probe", "sp2tp2-ulysses"))
    cases.append(("sp_probe", dict(spec={"seq": 2, "model": 2}, cfg=dict(TINY, use_flash=True),
                                   state_dict=_sd(params["unrolled"]), x=x[:4], t=t[:4],
                                   sp_mode="ulysses", layers=PROBE_LAYERS,
                                   head_axis="model")))
    ids.append(("errors", "all"))
    cases.append(("tp_pp_errors", dict(cfg=PORT_CFG)))
    results = dist_cases.run_world(cases, WORLD, device="cpu", timeout_s=DEADLINE_S)
    return dict(zip(ids, results))


# ------------------------------------------------------------ the plan


def _torch_side(path, spec, ndim):
    """A flax leaf's (torch key, dims per torch dim, stage axis) of a spec
    of the unrolled tree (stacked: ``path[0] == 'blocks'``, one key per
    layer)."""
    names = [getattr(k, "key", str(k)) for k in path]
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    stage = None
    if names[0] == "blocks":
        stage, spec, ndim = spec[0], spec[1:], ndim - 1
    leaf = names[-1]
    dims = spec[::-1] if leaf in ("kernel", "w_int8") and ndim == 2 else spec
    return names, tuple(dims), stage


def _key(names, i=None):
    """The bridge's torch key of a flax leaf path (block i of a stacked one)."""
    rename = {"scale": "weight", "embedding": "weight", "kernel": "weight"}
    head = names[0] if i is None else f"blocks_{i}"
    parts = [head.replace("blocks_", "blocks.")] + names[1:]
    leaf = parts[-1]
    norm = len(parts) >= 2 and parts[-2].startswith("norm")
    if leaf in rename and not (leaf == "scale" and not norm):
        parts[-1] = rename[leaf]
    return ".".join(parts)


def _plan_matches(jax_specs, tree, port_plan, depth=None):
    flat = jax.tree_util.tree_flatten_with_path(jax_specs,
                                                is_leaf=lambda s: isinstance(
                                                    s, jax.sharding.PartitionSpec))[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    seen = 0
    for path, spec in flat:
        names, dims, stage = _torch_side(path, spec, np.ndim(leaves[path]))
        keys = ([_key(names)] if names[0] != "blocks" else
                [_key(names, i) for i in range(depth)])
        for key in keys:
            if key == "patch_embed.proj.weight":  # 4-D in torch: replicated either way
                assert not port_plan[key].sharded and dims == (None, None)
                continue
            got = port_plan[key]
            assert (got.dims, got.stage) == (dims, stage), (key, got, dims, stage)
            seen += 1
    assert seen == len(port_plan) - 1


@pytest.mark.parametrize("tree", ["float", "w8a16"])
def test_shard_plan_is_jaxs_specs(params, tree):
    """Leaf by leaf through the bridge's names: ``param_partition_specs``
    on the unrolled tree and ``pipeline_param_specs`` on the stacked one,
    each against the port's plan of the same state_dict."""
    flat = params["unrolled"]
    sd = _sd(flat)
    if tree == "w8a16":
        flat = jax_quant.quantize_params(flat)
        sd = port_quant.quantize_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    _plan_matches(param_partition_specs(flat, axes=("model",)), flat,
                  sharding.param_partition_specs(sd, axes=("model",)))
    _plan_matches(param_partition_specs(flat, axes=("expert",)), flat,
                  sharding.param_partition_specs(sd, axes=("expert",)))
    if tree == "float":
        stacked = params["stacked"]
        for axes in ((), ("model",)):
            _plan_matches(pipeline_param_specs(stacked, tensor_axes=axes), stacked,
                          sharding.pipeline_param_specs(sd, tensor_axes=axes),
                          depth=TINY["depth"])


@pytest.mark.parametrize("spec", ROUND_TRIPS, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                                     s.items()))
def test_shard_then_gather_is_the_identity(world, params, spec):
    sd = _sd(params["stacked"])
    for rank, got in enumerate(world[("round", tuple(spec))]):
        assert got["keys"] == list(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got["back"][k], v, err_msg=k)
    pipe, tp = spec.get("pipe", 1), spec.get("model", 1)
    part = world[("round", tuple(spec))][0]["part"]
    assert len([k for k in part if k.startswith("blocks.")]) == (
        len([k for k in sd if k.startswith("blocks.")]) // pipe)
    assert part["blocks.0.attn.qkv.weight"] == (3 * 32 // tp, 32)
    assert part["blocks.0.attn.proj.weight"] == (32, 32 // tp)
    assert part["blocks.0.mlp.fc1.bias"] == (32 // tp,)
    assert part["head.weight"] == sd["head.weight"].shape


def test_moe_and_expert_name_item_18(tmp_path, synthetic_image_dir):
    """The Switch-MoE plan is JAX's specs (``param_partition_specs`` over
    ``expert`` and ``model`` on the unrolled tree, ``pipeline_param_specs``
    with ``expert`` inside the stage on the stacked one: the banks' expert
    dim split, the router whole); JAX's expert-axis ValueError."""
    x, t, _ = _inputs()
    moe = DiffusionViT(**TINY, **NO_DROP, num_experts=2)
    flat = jax.device_get(jax.jit(moe.init)(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                                            jnp.asarray(t[:2]))["params"])
    sd = _sd(flat)
    for axes in (("expert",), ("model", "expert")):
        _plan_matches(param_partition_specs(flat, axes=axes), flat,
                      sharding.param_partition_specs(sd, axes=axes))
    stacked = stack_block_params(flat)
    _plan_matches(pipeline_param_specs(stacked, tensor_axes=("expert",)), stacked,
                  sharding.pipeline_param_specs(sd, tensor_axes=("expert",)),
                  depth=TINY["depth"])
    plan = sharding.param_partition_specs(sd, axes=("expert",))
    assert plan["blocks.0.moe.w1"].dims == ("expert", None, None)
    assert not plan["blocks.0.moe.router"].sharded
    PortViT(**TINY, num_experts=2, device="cpu").load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    cfg = ExperimentConfig(
        exp_name="ep", framework="x", batch_size=2, epoch=(0, 1), data_storage=(
            synthetic_image_dir, synthetic_image_dir), image_size=(16, 16),
        patch_size=8, embed_dim=32, depth=2, head=2, mesh={"data": 2, "expert": 2})
    with pytest.raises(ValueError, match=r"'expert' axis of 2 needs num_experts \(got 1\)"):
        port_trainer.run(cfg, str(tmp_path), device="cpu")


# ------------------------------------------------ forwards and gradients


@pytest.fixture(scope="module")
def jax_refs(params):
    """JAX's forward and gradient of mean(x̂0²) on the whole batch: the
    plain scanned model, its forward with the params sharded by its tp
    specs on {data: 2, model: 2}, its sp_clone(head_axis="model") forwards,
    and each pipelined apply of ``JAX_PIPES``."""
    x, t, _ = _inputs()
    x, t = jnp.asarray(x), jnp.asarray(t)
    stacked = params["stacked"]
    out = {}

    def vg(apply):
        def loss(p):
            y = apply(p)
            return jnp.mean(y**2), y
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
        return np.asarray(y), state_dict_from_flax(jax.device_get(g), 4)

    model = DiffusionViT(scan_blocks=True, **TINY, **NO_DROP)
    out["plain"] = vg(lambda p: model.apply({"params": p}, x, t))
    mesh = _jax_mesh({"data": 2, "model": 2})
    sharded = shard_params(stacked, mesh, param_partition_specs(stacked, axes=("model",)))
    out["tp"] = (np.asarray(jax.jit(model.apply)({"params": sharded}, shard_batch(x, mesh),
                                                  t)), out["plain"][1])
    for key in SPTP:
        mode = GRADS[key][1]
        mesh = _jax_mesh({"seq": 2, "model": 2})
        sp = sp_clone(DiffusionViT(scan_blocks=True, **TINY, **NO_DROP), mesh,
                      sp_mode=mode, batch_axis=None, head_axis="model")
        assert sp.sp_mode == mode
        out[key] = np.asarray(jax.jit(sp.apply)({"params": stacked}, x, t))
    for key, (spec, micro) in JAX_PIPES.items():
        for mode in ((None,) if "seq" not in spec else ("ring", "ulysses")):
            m = DiffusionViT(scan_blocks=True, sp_mode=mode or "ring", **TINY, **NO_DROP)
            pf = make_pipelined_apply(m, _jax_mesh(spec), n_microbatch=micro)
            out[(key, mode)] = vg(lambda p, pf=pf: pf({"params": p}, x, t))
    return out


def _params_close(got: dict, want: dict, atol: float, rtol: float = 0.0):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(GRADS))
def test_sharded_forward_and_grads_match_jax(world, jax_refs, case):
    """Every rank returns the whole batch's output and, gathered, the whole
    model's gradient (each shard reduced by its class); ‖g‖ as the clip
    sees it."""
    ref = GRADS[case][4]
    want_out, want_g = jax_refs[ref] if not isinstance(ref, str) or ref != "plain" else (
        jax_refs[case], jax_refs["plain"][1])
    if ref == "tp":
        want_out, want_g = jax_refs["tp"]
    norm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in want_g.values())))
    for rank, got in enumerate(world[("grads", case)]):
        np.testing.assert_allclose(got["out"], want_out, rtol=0, atol=ATOL,
                                   err_msg=f"rank {rank} out")
        _params_close(got["grads"], want_g, ATOL)
        assert got["norm"] == pytest.approx(norm, rel=1e-5)


def test_tp_training_forward_draws_one_process_masks(world, params):
    """The training forward at the model's default drop rates (0.1 each:
    attention dropout on the dense path, the Mlp's hidden and output
    dropout, stochastic depth) on ``{model: 2}``: each rank draws the whole
    tensors' masks from the shared generator and keeps its heads' and
    hidden units' part, so output and gradients are the one-process
    model's from the same generator (atol 1e-6; the sums run in another
    order)."""
    x, t, _ = _inputs()
    one = PortViT(**TINY, use_flash=True, device="cpu")
    one.load_state_dict(state_dict_from_flax(params["stacked"], 4), strict=True)
    out = one(torch.from_numpy(x), torch.from_numpy(t).long(), deterministic=False,
              generator=torch.Generator().manual_seed(DROP_SEED))
    names = [n for n, _ in one.named_parameters()]
    grads = torch.autograd.grad(out.square().mean(), list(one.parameters()))
    for rank, got in enumerate(world[("grads", "tp2-dropout")]):
        np.testing.assert_allclose(got["out"], out.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"rank {rank}")
        _params_close(got["grads"], dict(zip(names, grads)), 1e-6)


def test_block_template_is_a_block_of_the_model():
    """``block_template(model)`` is one block of the model's configuration
    at drop path 0: loaded with block 0's weights it computes block 0
    (whose drop path is 0 too)."""
    from ddim_cold_torch.models.vit import block_template

    model = PortViT(**TINY, device="cpu")
    blk = block_template(model)
    blk.load_state_dict(model.blocks[0].state_dict(), strict=True)
    tok = torch.randn(2, 17, 32, generator=torch.Generator().manual_seed(0))
    assert blk.drop_path == 0.0
    torch.testing.assert_close(blk(tok), model.blocks[0](tok), rtol=0, atol=0)


# ----------------------------------------------------------- train step


def test_pipelined_dispatch_matches_jax(world, params):
    """``steps_per_dispatch=2`` through the pipelined apply on ``{data: 2,
    pipe: 2}`` (M = 2), EMA on (JAX's ``test_pipelined_steps_per_dispatch_step``,
    held here to JAX's scan on the same mesh): the mean loss, the whole
    parameters and the shadow within the train step's tolerances over two
    steps."""
    _, _, batch = _inputs()
    model = DiffusionViT(scan_blocks=True, **TINY, **NO_DROP)
    mesh = _jax_mesh({"data": 2, "pipe": 2})
    stacked = jax.tree.map(jnp.asarray, params["stacked"])
    state = EmaTrainState.create(apply_fn=model.apply, params=stacked,
                                 tx=make_optimizer(LR, TOTAL),
                                 ema_params=jax.tree.map(jnp.copy, stacked))
    state = shard_train_state(state.replace(step=jnp.asarray(0, jnp.int32)), mesh,
                              pipeline_param_specs(stacked))
    step = make_train_step(model, make_pipelined_apply(model, mesh, n_microbatch=2),
                           ema_decay=EMA, steps_per_dispatch=2)
    grouped = tuple(jnp.stack([jnp.asarray(a)] * 2) for a in batch)
    state, loss, _ = step(state, shard_batch(grouped, mesh, grouped=True),
                          jax.random.PRNGKey(1), jnp.float32(5.0))
    assert int(state.step) == 2
    want = state_dict_from_flax(jax.device_get(state.params), 4)
    want_ema = state_dict_from_flax(jax.device_get(state.ema_params), 4)
    for got in world[("train", "dp2pp2-dispatch2")]:
        assert got["losses"] == pytest.approx([float(loss)], rel=1e-5)
        _params_close(got["params"], want, 3e-3 * LR * 2, 1e-5)
        _params_close(got["ema"], want_ema, 3e-3 * LR * 2, 1e-5)


def test_tp_dp_train_step_matches(world, params):
    """Two steps on {data: 2, model: 2} against JAX's step on the same mesh
    with its tp specs, the EMA shadow co-sharded with the params."""
    _, _, batch = _inputs()
    model = DiffusionViT(scan_blocks=True, **TINY, **NO_DROP)
    noisy, target, t = (jnp.asarray(a) for a in batch)
    norm0 = float(optax.global_norm(jax.jit(jax.grad(lambda p: smooth_l1(
        model.apply({"params": p}, noisy, t), target)))(params["stacked"])))
    mesh = _jax_mesh({"data": 2, "model": 2})
    stacked = jax.tree.map(jnp.asarray, params["stacked"])
    state = EmaTrainState.create(apply_fn=model.apply, params=stacked,
                                 tx=make_optimizer(LR, TOTAL),
                                 ema_params=jax.tree.map(jnp.copy, stacked))
    state = shard_train_state(state.replace(step=jnp.asarray(0, jnp.int32)), mesh,
                              param_partition_specs(stacked, axes=("model",)))
    step = make_train_step(model, ema_decay=EMA)
    jb = shard_batch(tuple(map(jnp.asarray, batch)), mesh)
    losses = []
    for _ in range(2):
        state, loss, _ = step(state, jb, jax.random.PRNGKey(1), jnp.float32(5.0))
        losses.append(float(loss))
    want = state_dict_from_flax(jax.device_get(state.params), 4)
    want_ema = state_dict_from_flax(jax.device_get(state.ema_params), 4)
    total = sum(v.numel() for v in want.values())
    for rank, got in enumerate(world[("train", "dp2tp2")]):
        assert got["losses"] == pytest.approx(losses, rel=1e-5)
        assert got["grad_norms"][0] == pytest.approx(norm0, rel=1e-5)
        _params_close(got["params"], want, 3e-3 * LR, 1e-5)
        _params_close(got["ema"], want_ema, 3e-3 * LR, 1e-5)
        # co-sharded: this rank's moments and shadow are its params' size,
        # under the whole model's
        assert got["moments_numel"] == got["ema_numel"] == got["local_numel"] < total


# ------------------------------------------------------------- sampler


def test_sp_clone_head_axis_sampling_matches_jax(world, params):
    x, _, _ = _inputs()
    mesh = _jax_mesh({"seq": 2, "model": 2})
    # JAX's dense local attention: the same function, and no Pallas
    # interpret-mode kernel inside its shard_map
    jmodel = sp_clone(DiffusionViT(scan_blocks=True, **TINY), mesh,
                      sp_mode="ulysses", batch_axis=None, head_axis="model")
    want = np.asarray(sampling.ddim_sample(jmodel, params["stacked"],
                                           x_init=jnp.asarray(x[:4]), mesh=mesh, k=2))
    for rank, got in enumerate(world[("sample", "sp2tp2-ulysses")]):
        assert got["images"].shape == (4, 16, 16, 3)
        np.testing.assert_allclose(got["images"], want, rtol=0, atol=1e-4,
                                   err_msg=f"rank {rank}")


def test_probe_under_head_axis_matches_jax(world, params):
    """The attention probe of ``sp_clone(head_axis="model")`` on ``{seq: 2,
    model: 2}`` (Ulysses): every rank returns every head's whole (B, H,
    N+1, N+1) weights (q and k gathered over ``seq`` and ``model``), JAX's
    within the f32 forward's tolerance (rtol 2e-4, atol 2e-5, as
    tests/test_torch_port_model.py) and the one-process probe's within
    rtol = atol = 2e-5 (a mesh reduces in another order)."""
    x, t, _ = _inputs()
    jmodel = sp_clone(DiffusionViT(**TINY), _jax_mesh({"seq": 2, "model": 2}),
                      sp_mode="ulysses", batch_axis=None, head_axis="model")
    port = PortViT(**TINY, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in _sd(params["unrolled"]).items()})
    for layer in PROBE_LAYERS:
        want = np.asarray(jmodel.apply({"params": params["unrolled"]}, jnp.asarray(x[:4]),
                                       jnp.asarray(t[:4]), return_attention_layer=layer))
        with torch.no_grad():
            one = port(torch.from_numpy(x[:4]), torch.from_numpy(t[:4]),
                       return_attention_layer=layer).numpy()
        for rank, got in enumerate(world[("probe", "sp2tp2-ulysses")]):
            w = got["weights"][layer]
            assert w.shape == (4, 4, 17, 17)
            np.testing.assert_allclose(w, want, rtol=2e-4, atol=2e-5,
                                       err_msg=f"layer {layer} rank {rank}")
            np.testing.assert_allclose(w, one, rtol=2e-5, atol=2e-5,
                                       err_msg=f"layer {layer} rank {rank}")
            assert "cannot apply attention-dropout" in got["dropout_error"]


# -------------------------------------------------------------- errors


def test_layout_errors_are_jaxs(world):
    got = world[("errors", "all")][0]
    assert got["depth"] == "ValueError: depth 2 not divisible by 4 pipeline stages"
    assert got["batch"] == "ValueError: batch 3 not divisible by 2 microbatches"
    assert got["seq_axis"].startswith("ValueError: seq_axis is set but `block` is not "
                                      "the manual-ring template")
    assert got["ulysses"] == (
        "SeqParallelConfigError: ulysses needs local heads (2//2=1) divisible by the "
        "'seq' axis (2); use sp_mode='ring' otherwise (serving: SamplerConfig("
        "sp_mode='ring', sp_degree=...), or pick an sp_degree that divides the local "
        "head count)")


@pytest.mark.parametrize("keys,match", [
    (dict(grad_accum=2, microbatches=2), "grad_accum composes with dp/tp/sp only — the pipe axis has "
                         "its own microbatching"),
    (dict(microbatches=4), "pipeline needs global batch 4 divisible by microbatches 4 "
                           "and each microbatch by data=2"),
])
def test_trainer_batching_errors_are_jaxs(tmp_path, synthetic_image_dir, keys, match):
    cfg = ExperimentConfig(
        exp_name="pp", framework="x", batch_size=2, epoch=(0, 1), data_storage=(
            synthetic_image_dir, synthetic_image_dir), image_size=(16, 16),
        patch_size=8, embed_dim=32, depth=2, head=2, mesh={"data": 2, "pipe": 2}, **keys)
    with pytest.raises(ValueError, match=match):
        port_trainer.run(cfg, str(tmp_path), device="cpu")


@pytest.mark.parametrize("hook,match", [
    (dict(capture_split=1), "step caching .* requires scan_blocks=False"),
    (dict(capture_tokens=True), "token caching .* requires scan_blocks=False"),
    (dict(return_attention_layer=0), "attention probe requires scan_blocks=False"),
])
def test_scan_blocks_refusals_are_jaxs(hook, match):
    model = PortViT(**TINY, scan_blocks=True, device="cpu")
    x, t, _ = _inputs()
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(x[:2]), torch.from_numpy(t[:2]).long(), **hook)


# ------------------------------------------------------- the trainer


def _yaml(tmp_path, images, name, **over):
    """JAX's pipeline trainer tests' config (16 px, patch 8, depth 2, two
    heads) as the launcher's YAML."""
    cfg = dict(initializing="none", resume="none", AMP=False, framework="pp",
               batch_size=2, epoch=[0, 2], base_lr=0.005, dataStorage=[images, images],
               image_size=[16, 16], patch_size=8, embed_dim=32, depth=2, head=2,
               use_flash=True)
    cfg.update(over)
    with open(tmp_path / f"{name}.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return tmp_path / "Saved_Models" / f"{name}pp"


@pytest.fixture(scope="module")
def runs(tmp_path_factory, synthetic_image_dir):
    """``python -m ddim_cold_torch train`` (four gloo ranks each):
    ``{data: 2, pipe: 2}`` two epochs straight; the same run stopped after
    its first epoch's steps, then resumed to the second on its own layout,
    and on ``{model: 2, pipe: 2}`` at JAX's batch 4 for that mesh (the same
    global batch of 4: the same rows a step and the same lr)."""
    tmp = tmp_path_factory.mktemp("tp_pp_runs")
    stub = tmp / "stub" / "tensorboard"  # TensorBoard off in the spawned ranks
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("TensorBoard is off here")\n')
    dp_pp = dict(mesh={"data": 2, "pipe": 2}, microbatches=2)
    tp_pp = dict(mesh={"model": 2, "pipe": 2}, microbatches=2, batch_size=4)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.syspath_prepend(str(tmp / "stub"))
        mp.chdir(tmp)
        run_dir = _yaml(tmp, synthetic_image_dir, "dppp", **dp_pp)
        out["dppp"] = (cli.main(["train", "dppp"], base_dir=str(tmp), device="cpu"), run_dir)
        # the first epoch alone (the cosine keeps its two-epoch length)
        _yaml(tmp, synthetic_image_dir, "half", **dp_pp)
        half = port_trainer.run(load_config(str(tmp / "half.yaml"), "half"), str(tmp),
                                max_steps=2, device="cpu")
        last = os.path.join(half.run_dir, "lastepoch.ckpt")
        for name, keys in (("resumed", dp_pp), ("tppp", tp_pp)):
            run_dir = _yaml(tmp, synthetic_image_dir, name, resume=last, **keys)
            out[name] = (cli.main(["train", name], base_dir=str(tmp), device="cpu"), run_dir)
    return out


@pytest.mark.parametrize("name", ["dppp", "tppp"])
def test_pipeline_training_end_to_end(runs, params, name):
    """Each run exits 0 with its epochs logged (the {model: 2, pipe: 2} run
    resumed at epoch 1); every checkpoint is the one-process state_dict: it
    loads strict into a one-process model, and JAX's model through its
    bridge gives the port's forward."""
    rc, run_dir = runs[name]
    assert rc == 0
    log = (run_dir / "train.log").read_text()
    assert log.count("epoch:    1") == 1
    assert log.count("epoch:    0") == (1 if name == "dppp" else 0)
    assert (name == "tppp") == ("resuming from epoch        1 of" in log)
    files = set(os.listdir(run_dir))
    # a resumed run writes bestloss only when it beats the restored best
    best = {"bestloss.ckpt", "bestloss.pkl"} & files
    assert "lastepoch.ckpt" in files and (name == "tppp" or len(best) == 2)
    geometry = dict(img_size=(16, 16), patch_size=8, embed_dim=32, depth=2, num_heads=2)
    last = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    # 10 images, a global batch of 4: 2 steps an epoch
    assert (last["epoch"], last["steps"], last["opt_state"]["count"]) == (1, 4, 4)
    x, t, _ = _inputs()
    bests = [port_ckpt.load_checkpoint(str(run_dir / "bestloss.ckpt"))
             if f.endswith(".ckpt") else port_ckpt.load_torch_pkl(str(run_dir / f))
             for f in sorted(best)]
    for sd in [last["params"], last["opt_state"]["mu"], *bests]:
        one = PortViT(**geometry, device="cpu")
        one.load_state_dict(sd, strict=True)
    one.load_state_dict(last["params"], strict=True)
    with torch.no_grad():
        got = one(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    jmodel = DiffusionViT(**geometry)
    want = np.asarray(jmodel.apply({"params": flax_from_torch_state_dict(last["params"], 8)},
                                   jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resumed_pipeline_run_is_bitwise_the_uninterrupted_one(runs):
    """Stopped after its first epoch and resumed on its own layout, the
    {data: 2, pipe: 2} run ends bit for bit where the straight one does;
    resumed on {model: 2, pipe: 2} from the same checkpoint (the same rows
    a step, other dropout streams: one data rank) it ends within Adam's
    update bound of it."""
    (rc_a, a_dir), (rc_b, b_dir), (rc_c, c_dir) = (runs[n] for n in ("dppp", "resumed",
                                                                    "tppp"))
    assert rc_a == rc_b == rc_c == 0
    a, b, c = (port_ckpt.load_checkpoint(str(d / "lastepoch.ckpt"))
               for d in (a_dir, b_dir, c_dir))
    assert (b["epoch"], b["steps"]) == (c["epoch"], c["steps"]) == (1, 4)
    assert a["loss_rec"] == b["loss_rec"] and a["metric"] == b["metric"]
    # Adam's update is about lr·sign(g), so two runs' updates differ by at
    # most about 2·lr a step (chip_smoke's MAX_UPDATE_GAP_LR), over the two
    # resumed steps (lr = 0.005 · 4 / 512)
    gap = 2 * 2.1 * 0.005 * 4 / 512
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
        torch.testing.assert_close(c["params"][name], a["params"][name], rtol=0,
                                   atol=gap)
    for which in ("mu", "nu"):
        for name in a["opt_state"][which]:
            assert torch.equal(a["opt_state"][which][name], b["opt_state"][which][name])
