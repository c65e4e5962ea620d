"""The port's DiffusionViT and DDIM sampler against the JAX package's.

One JAX model at the TINY geometry (16px, patch 4, C=32, depth 2, 4 heads)
is initialised, its parameter tree carried into the port by
``state_dict_from_flax`` and loaded with ``strict=True``; both packages then
see the same numpy inputs. JAX runs on the CPU at float32 matmul precision
(tests/conftest.py), its flash path through the Pallas kernel in interpret
mode. Tolerances: float32 forward rtol 2e-4 / atol 2e-5 (the bridge's
reference tolerance, tests/test_torch_bridge.py); bfloat16 forward atol
1e-2 (about five bf16 ulps at the output's scale of ~0.5: the two
frameworks round at different points); samplers atol 1e-4 over their 2-4
steps. The attention probe (``return_attention_layer``) and the blockwise
``use_flash="xla"`` route are held at the float32 forward's tolerance; the
xla route's gradients within 1e-5 (relative to the largest) of the dense
route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import MODEL_CONFIGS as PORT_CONFIGS
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.models.init import trunc_normal_
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import MODEL_CONFIGS, DiffusionViT
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.utils.checkpoint import stack_block_params

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K = 500  # 4 reverse steps


@pytest.fixture(scope="module")
def jax_params():
    model = DiffusionViT(**TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                        jnp.zeros((2,), jnp.int32))["params"]
    return jax.device_get(params)


def _port(jax_params, **kw) -> PortViT:
    model = PortViT(**TINY, device="cpu", **kw)
    model.load_state_dict(state_dict_from_flax(jax_params, TINY["patch_size"]),
                          strict=True)
    return model


def _inputs(seed=0, n=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 16, 16, 3).astype(np.float32)
    t = rs.randint(0, TINY["total_steps"], size=(n,)).astype(np.int32)
    return x, t


def _jax_forward(params, x, t, **kw):
    return np.asarray(DiffusionViT(**TINY, **kw).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_jax_f32(jax_params, use_flash):
    x, t = _inputs()
    with torch.no_grad():
        got = _port(jax_params, use_flash=use_flash)(torch.from_numpy(x),
                                                     torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(),
                               _jax_forward(jax_params, x, t, use_flash=use_flash),
                               rtol=2e-4, atol=2e-5)


def test_forward_matches_jax_bf16(jax_params):
    x, t = _inputs(1)
    with torch.no_grad():
        got = _port(jax_params, use_flash=True, dtype=torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(t))
    want = _jax_forward(jax_params, x, t, use_flash=True, dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


def test_scan_blocks_tree_bridges(jax_params):
    """A scan_blocks (stacked) tree converts to the same state_dict."""
    flat = state_dict_from_flax(jax_params, TINY["patch_size"])
    stacked = state_dict_from_flax(stack_block_params(jax_params),
                                   TINY["patch_size"])
    assert flat.keys() == stacked.keys()
    for key in flat:
        torch.testing.assert_close(flat[key], stacked[key], rtol=0, atol=0)


def test_moe_tree_refused(jax_params, tmp_path):
    """A Switch-MoE tree carries across into the port (both layouts); only
    the reference-layout ``.pkl`` refuses it, as JAX's bridge does."""
    from ddim_cold_tpu.utils.checkpoint import torch_state_dict_from_flax

    from ddim_cold_torch.utils.checkpoint import save_torch_pkl

    rs = np.random.RandomState(0)
    e, c = 2, TINY["embed_dim"]  # JAX's SwitchMlp leaves, in place of each mlp
    bank = {"router": (c, e), "w1": (e, c, c), "b1": (e, c), "w2": (e, c, c), "b2": (e, c)}
    tree = {k: ({n: m for n, m in v.items() if n != "mlp"}
                | {"moe": {leaf: rs.randn(*shape).astype(np.float32)
                           for leaf, shape in bank.items()}}
                if k.startswith("blocks_") else v) for k, v in jax_params.items()}
    sd = state_dict_from_flax(tree, TINY["patch_size"])
    torch.testing.assert_close(sd["blocks.1.moe.w1"], torch.from_numpy(
        tree["blocks_1"]["moe"]["w1"]), rtol=0, atol=0)
    assert sd.keys() == state_dict_from_flax(stack_block_params(tree),
                                             TINY["patch_size"]).keys()
    assert tuple(sd["blocks.1.moe.w1"].shape) == (2, 32, 32)
    PortViT(**TINY, num_experts=2, device="cpu").load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="no reference torch layout"):
        torch_state_dict_from_flax(tree, patch_size=TINY["patch_size"])
    with pytest.raises(ValueError, match="no reference torch layout"):
        save_torch_pkl(sd, str(tmp_path / "moe.pkl"))


def test_configs_and_defaults_match_jax():
    assert PORT_CONFIGS == MODEL_CONFIGS
    m = PortViT(**MODEL_CONFIGS["oxford_flower_64"], device="cpu")
    ref = DiffusionViT(**MODEL_CONFIGS["oxford_flower_64"])
    params = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1,), jnp.int32)))["params"]
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in m.parameters()) == n_ref


def test_init_is_seeded_reference_init():
    a = PortViT(**TINY, device="cpu", seed=3).state_dict()
    b = PortViT(**TINY, device="cpu", seed=3).state_dict()
    c = PortViT(**TINY, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos_embed"], c["pos_embed"])
    w = a["blocks.0.attn.qkv.weight"]
    assert abs(w.std().item() - 0.02) < 2e-3 and w.abs().max().item() < 0.2
    assert torch.all(a["blocks.0.attn.qkv.bias"] == 0)
    bound = 1.0 / np.sqrt(3 * 4 * 4)
    assert a["patch_embed.proj.weight"].abs().max().item() <= bound
    g = torch.Generator().manual_seed(0)
    wide = trunc_normal_(torch.empty(10000), g, std=1.0, a=-0.5, b=0.5)
    assert wide.min().item() >= -0.5 and wide.max().item() <= 0.5


class _OneRankMesh:
    """A ``DeviceMesh`` stand-in with one ``seq`` rank (no process group)."""

    mesh_dim_names = ("seq",)

    def size(self, dim):
        return 1

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


class _OneTpMesh(_OneRankMesh):
    """The stand-in with one ``model`` rank."""

    mesh_dim_names = ("model",)


# sequence parallelism landed (seq_mesh, seq_axis, batch_axis, sp_mode),
# with quant and fused under it; tensor parallelism's head_axis and the
# stacked layout landed, and what stays refused under them raises: quant
# under tensor parallelism (ROADMAP.md), quant under scan_blocks (JAX's
# ValueError); MoE landed, with JAX's refusals of an unknown dispatch and
# of an expert axis that does not divide num_experts
@pytest.mark.parametrize("hook,exc,match", [
    (dict(num_experts=2, moe_dispatch="gather"), ValueError,
     "dispatch must be 'einsum' or 'index'"),
    (dict(head_axis="model", quant="pallas"), NotImplementedError,
     "ROADMAP.md Queue 1 item 14"),
    (dict(expert_axis="model"), ValueError, r"needs num_experts \(got 1\) set"),
    (dict(scan_blocks=True, quant="pallas"), ValueError, "quant requires scan_blocks=False"),
])
def test_later_slice_ctor_hooks_raise(hook, exc, match):
    mesh = dict(seq_mesh=_OneTpMesh()) if {"head_axis", "expert_axis"} & set(hook) else {}
    with pytest.raises(exc, match=match):
        PortViT(**TINY, device="cpu", **mesh, **hook)


# the stage hooks landed, and a head stage without its tokens is JAX's
# error; the token cache landed under sequence parallelism, with JAX's
# exclusion of the probe
@pytest.mark.parametrize("hook", [dict(stage="head"),
                                  dict(capture_tokens=True, return_attention_layer=0)])
def test_later_slice_forward_hooks_raise(hook):
    sp = (dict(seq_mesh=_OneRankMesh(), seq_axis="seq") if "capture_tokens" in hook
          else {})
    model = PortViT(**TINY, device="cpu", **sp)
    x, t = _inputs()
    match = ('stage="head" requires tokens' if "stage" in hook
             else "token caching excludes the attention probe")
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(x), torch.from_numpy(t), **hook)


@pytest.mark.parametrize("quant,fused", [("pallas", False), ("w8a8", True)])
def test_quant_and_fused_build_under_sequence_parallelism(quant, fused):
    """quant and fused under sequence parallelism build: the fused
    attention is gated off (its kernel is not among the model's libraries),
    the qkv and proj stay int8 linears and the fused Mlp stays one kernel."""
    model = PortViT(**TINY, device="cpu", seq_mesh=_OneRankMesh(), seq_axis="seq",
                    quant=quant, fused=fused)
    libs = model.kernel_libraries()
    assert "fused_trunk" not in libs
    assert ("mlp_fused" in libs) == fused
    assert ("dequant_mm" in libs) == (quant == "pallas")


@pytest.mark.parametrize("hook", [dict(capture_split=1), dict(token_k=3),
                                  dict(skip_blocks=(0, 1))])
def test_cache_forward_hooks_match_jax(jax_params, hook):
    """The step-cache hooks this slice refused before: each one's x̂0 and
    cache against JAX's (the reuse hooks fed a JAX refresh at another
    level), at the float32 forward's tolerance
    (tests/test_torch_port_cache.py holds every hook on every route)."""
    x, t = _inputs()
    xp, tp = _inputs(3)
    model = DiffusionViT(**TINY)
    apply = lambda xx, tt, **kw: model.apply({"params": jax_params}, jnp.asarray(xx),  # noqa: E731
                                             jnp.asarray(tt), **kw)
    if "token_k" in hook:
        cache = [np.asarray(a) for a in apply(xp, tp, capture_tokens=True)[1]]
        jkw = dict(hook, token_cache=tuple(jnp.asarray(a) for a in cache))
        pkw = dict(hook, token_cache=tuple(torch.from_numpy(a.copy()) for a in cache))
    elif "skip_blocks" in hook:
        delta = np.asarray(apply(xp, tp, capture_split=1)[1][0])
        jkw, pkw = (dict(hook, block_delta=jnp.asarray(delta)),
                    dict(hook, block_delta=torch.from_numpy(delta.copy())))
    else:
        jkw = pkw = hook
    want = apply(x, t, **jkw)
    with torch.no_grad():
        got = _port(jax_params)(torch.from_numpy(x), torch.from_numpy(t), **pkw)
    if isinstance(want, tuple):
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_unknown_and_dropped_options_are_type_errors():
    with pytest.raises(TypeError):
        PortViT(**TINY, device="cpu", flash_block=(256, 512))
    PortViT(**TINY, device="cpu", flash_blocks=(256, 512))  # a ported option


# ------------------------------------------------------------------ samplers


@pytest.mark.parametrize("return_sequence", [False, True])
def test_ddim_sample_matches_jax(jax_params, return_sequence):
    x = np.random.RandomState(5).randn(3, 16, 16, 3).astype(np.float32)
    x_copy = x.copy()
    want = np.asarray(sampling.ddim_sample(
        DiffusionViT(**TINY), jax_params, x_init=jnp.asarray(x), k=K,
        return_sequence=return_sequence))
    got = port_sampling.ddim_sample(_port(jax_params), x_init=x, k=K,
                                    return_sequence=return_sequence,
                                    device="cpu")
    np.testing.assert_array_equal(x, x_copy)  # the caller's start survives
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_sample_from_matches_jax_with_flash(jax_params):
    x = np.random.RandomState(6).randn(2, 16, 16, 3).astype(np.float32)
    want = np.asarray(sampling.sample_from(
        DiffusionViT(**TINY, use_flash=True), jax_params, jnp.asarray(x),
        t_start=1000, k=K))
    xt = torch.from_numpy(x)
    got = port_sampling.sample_from(_port(jax_params, use_flash=True), xt,
                                    t_start=1000, k=K, device="cpu")
    assert torch.equal(xt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_fresh_start_and_eta_draw_from_the_generator(jax_params):
    model = _port(jax_params)
    run = lambda seed, **kw: port_sampling.ddim_sample(
        model, torch.Generator().manual_seed(seed), n=2, k=K, device="cpu", **kw)
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    torch.testing.assert_close(run(0, eta=0.5), run(0, eta=0.5), rtol=0, atol=0)
    assert not torch.equal(run(0, eta=0.5), run(0))
    assert not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="generator"):
        port_sampling.ddim_sample(model, x_init=np.zeros((1, 16, 16, 3)), k=K,
                                  eta=0.5, device="cpu")


def test_forward_noise_formula():
    img = torch.from_numpy(np.random.RandomState(7).rand(2, 16, 16, 3)
                           .astype(np.float32)) * 2 - 1
    got = port_sampling.forward_noise(torch.Generator().manual_seed(9), img, 500)
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(9))
    a = 1.0 - np.sqrt(500 / 2000)
    torch.testing.assert_close(got, np.sqrt(a) * img + np.sqrt(1 - a) * eps)


@pytest.mark.parametrize("options", [
    dict(cache_interval=2), dict(cache_interval=2, telemetry=True),
    dict(cache_interval=2, cache_mode="token", cache_tokens=5)])
def test_cache_sampler_options_match_jax(jax_params, options):
    """The step-cache options this slice refused before, run: the cached
    DDIM sampler against JAX's from JAX's start (atol 1e-4), its telemetry
    the same branch sequence."""
    x = np.random.RandomState(8).randn(2, 16, 16, 3).astype(np.float32)
    want = sampling.ddim_sample(DiffusionViT(**TINY), jax_params, x_init=jnp.asarray(x),
                                k=K, **options)
    got = port_sampling.ddim_sample(_port(jax_params), x_init=x, k=K, device="cpu",
                                    **options)
    if options.get("telemetry"):
        (got, got_tel), (want, want_tel) = got, want
        assert list(got_tel.branch) == list(np.asarray(want_tel.branch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ------------------------------------------ the attention probe and "xla"


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("layer", [0, -1])
def test_attention_probe_matches_jax(jax_params, layer, use_flash):
    """``return_attention_layer``: layer ``i % depth``'s (B, H, N, N)
    weights from the dense path whatever the route (the blocks before it
    run their own route: flash, JAX's in interpret mode), within the f32
    forward's tolerance; rows sum to 1."""
    x, t = _inputs(4)
    with torch.no_grad():
        got = _port(jax_params, use_flash=use_flash)(
            torch.from_numpy(x), torch.from_numpy(t), return_attention_layer=layer)
    want = np.asarray(DiffusionViT(**TINY, use_flash=use_flash).apply(
        {"params": jax_params}, jnp.asarray(x), jnp.asarray(t),
        return_attention_layer=layer))
    assert got.shape == want.shape == (2, 4, 17, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 4, 17), rtol=0, atol=1e-5)


def _probe_combos():
    d = np.zeros((2, 17, 32), np.float32)
    return {"capture_split": dict(capture_split=1),
            "skip_blocks": dict(skip_blocks=(0, 1), block_delta=d),
            "capture_tokens": dict(capture_tokens=True),
            "token_cache": dict(token_cache=(d, d), token_k=3)}


@pytest.mark.parametrize("hook", sorted(_probe_combos()))
def test_probe_with_a_cache_hook_raises_jaxs_error(jax_params, hook):
    x, t = _inputs()
    kw = _probe_combos()[hook]
    with pytest.raises(ValueError) as jax_err:
        DiffusionViT(**TINY).apply(
            {"params": jax_params}, jnp.asarray(x), jnp.asarray(t),
            return_attention_layer=0,
            **{k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) and k == "token_cache"
                   else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
    pkw = {k: (tuple(map(torch.from_numpy, v)) if k == "token_cache"
               else torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError) as port_err:
        _port(jax_params)(torch.from_numpy(x), torch.from_numpy(t),
                          return_attention_layer=0, **pkw)
    assert str(port_err.value) == str(jax_err.value)
    assert "excludes the attention probe" in str(port_err.value)


def test_blockwise_route_matches_jax_and_its_gradient_the_dense(jax_params):
    """``use_flash="xla"`` with ``flash_blocks=(4, 8)`` (three key blocks of
    17 tokens): the forward within the f32 forward's tolerance of JAX's xla
    model; its input and parameter gradients within 1e-5 (relative to the
    largest) of the dense route's, since autograd differentiates the same
    softmax in another order. It launches no kernel."""
    from ddim_cold_torch.ops import flash_attention as fa

    x, t = _inputs(5)
    before = dict(fa.LAUNCHES)
    xla = _port(jax_params, use_flash="xla", flash_blocks=(4, 8))
    dense = _port(jax_params, use_flash=False)
    assert xla.kernel_libraries() == ()
    want = _jax_forward(jax_params, x, t, use_flash="xla", flash_blocks=(4, 8))
    grads = []
    for model in (xla, dense):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = model(xt, torch.from_numpy(t))
        if model is xla:
            np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4, atol=2e-5)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append([xt.grad] + [p.grad for p in model.parameters()])
    for g, d in zip(*grads):
        scale = d.abs().max().item() or 1.0
        assert (g - d).abs().max().item() <= 1e-5 * scale
    assert dict(fa.LAUNCHES) == before
