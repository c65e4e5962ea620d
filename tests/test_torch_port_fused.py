"""The port's fused trunk attention, quantized model and quantized serving
against the JAX package's and against themselves.

Inputs come from numpy seeds. JAX runs on the CPU at float32 matmul
precision (tests/conftest.py), its Pallas kernels (``_fused_trunk_kernel``,
``_mlp_kernel``, ``_mm_kernel``, ``_fwd_kernel``) in interpret mode, through
its public functions; its engine is not used as an oracle.

Tolerances and why:
* fused trunk attention, f32: 1e-5 (projections, softmax and proj in f32,
  summed in another order); bf16: ``2⁻⁶·|y| + 2⁻⁴·mean|y|``, a few bf16
  ulps (q, k, v, p and the context are rounded to bf16 from f32 values that
  differ in their last bits);
* the port's fused vs unfused w8a16 composition, f32: 1e-5 (the same
  operations; online vs one-pass softmax);
* whole-model forward at TINY, f32: rtol 2e-4, atol 2e-5, the float
  forward's bridge tolerance (tests/test_torch_port_model.py), for every
  allowed (quant, fused);
* engine: bitwise against a direct ``ddim_sample`` on the same variant at
  the same dispatch shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch import serve as port_serve
from ddim_cold_torch.models import MODEL_CONFIGS
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import flash_attention as pfa
from ddim_cold_torch.ops import quant as pq
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import flash_attention as jfa
from ddim_cold_tpu.ops import quant as jq
from ddim_cold_tpu.ops import tiling as jtiling
from ddim_cold_tpu.utils.checkpoint import flax_from_torch_state_dict

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)
K = 500  # 4 reverse steps


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------- fused attention

@pytest.fixture(scope="module")
def trunk_case():
    """B=2, N=65, C=64, 4 heads: with block_q = 32 three q-blocks, the last
    ragged (65 = 2·32 + 1)."""
    rs = np.random.RandomState(7)
    B, N, C = 2, 65, 64
    x = rs.randn(B, N, C).astype(np.float32)
    c_qkv, s_qkv = jq.quantize_weight(jnp.asarray((rs.randn(C, 3 * C) * 0.15)
                                                  .astype(np.float32)))
    c_p, s_p = jq.quantize_weight(jnp.asarray((rs.randn(C, C) * 0.15).astype(np.float32)))
    b_qkv = (rs.randn(3 * C) * 0.1).astype(np.float32)
    b_p = (rs.randn(C) * 0.1).astype(np.float32)
    jax_args = (c_qkv, s_qkv, jnp.asarray(b_qkv), c_p, s_p, jnp.asarray(b_p))
    port_args = (_t(c_qkv).T.contiguous(), _t(s_qkv), _t(b_qkv),
                 _t(c_p).T.contiguous(), _t(s_p), _t(b_p))
    return x, jax_args, port_args, 16**-0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pallas", "w8a8"])
def test_fused_trunk_attention_matches_jax(trunk_case, mode, dtype):
    x, jax_args, port_args, scale = trunk_case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfa.fused_trunk_attention(
        jnp.asarray(x, jdt), *jax_args, num_heads=4, scale=scale, block_q=32,
        block_kv=32, mode=mode), np.float32)
    got = pfa.fused_trunk_attention(_t(x).to(tdt), *port_args, num_heads=4,
                                    scale=scale, block_q=32, mode=mode)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        limit = 2.0**-6 * np.abs(want) + 2.0**-4 * np.abs(want).mean()
        assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


def test_plain_exp_is_accurate_on_the_cpu():
    """The plain versions' softmax exp (``flash_attention.exp_f32``) is
    float64's exp rounded to float32 on the CPU: within one float32 ulp
    whatever accuracy mode MKL's vector math gives the thread that runs it
    (a process's first torch.exp has returned ~1.5e-4 relative error on some
    worker threads' chunks, which moved the pallas-float32 case above by
    5.5e-5 in one full run)."""
    x = torch.linspace(-80.0, 10.0, 100_003)
    got = pfa.exp_f32(x)
    assert got.dtype == torch.float32
    want = torch.exp(x.double())
    assert ((got.double() - want).abs() / want).max() <= 2.0**-23


def test_fused_trunk_w8a8_block_q_sets_the_requant_rows(trunk_case):
    """Only block_q, and only in w8a8, changes the value: the context is
    requantized per block_q rows of the padded sequence."""
    x, _, port_args, scale = trunk_case
    run = lambda mode, bq: pfa.fused_trunk_attention(
        _t(x), *port_args, num_heads=4, scale=scale, block_q=bq, mode=mode)
    assert not torch.equal(run("w8a8", 32), run("w8a8", 512))
    torch.testing.assert_close(run("pallas", 32), run("pallas", 512), rtol=0, atol=0)


def test_fused_trunk_equals_the_unfused_port_composition(trunk_case):
    """w8a16 at f32: QuantLinear → flash → QuantLinear, the unfused path of
    the port's model, gives the fused result within 1e-5."""
    x, _, (c_qkv, s_qkv, b_qkv, c_p, s_p, b_p), scale = trunk_case
    xt = _t(x)
    B, N, C = xt.shape
    qkv = pq.dequant_matmul(xt, c_qkv, s_qkv, bias=b_qkv, mode="pallas")
    q, k, v = qkv.reshape(B, N, 3, 4, 16).unbind(2)
    ctx = pfa.flash_forward(q, k, v, scale)[0].reshape(B, N, C)
    unfused = pq.dequant_matmul(ctx, c_p, s_p, bias=b_p, mode="pallas")
    fused = pfa.fused_trunk_attention(xt, c_qkv, s_qkv, b_qkv, c_p, s_p, b_p,
                                      num_heads=4, scale=scale, mode="pallas")
    torch.testing.assert_close(fused, unfused, rtol=1e-5, atol=1e-5)


def test_fused_trunk_refuses_bad_input(trunk_case):
    x, _, port_args, scale = trunk_case
    with pytest.raises(ValueError, match="mode"):
        pfa.fused_trunk_attention(_t(x), *port_args, num_heads=4, scale=scale,
                                  mode="xla")
    with pytest.raises(ValueError, match="int8"):
        pfa.fused_trunk_attention(_t(x), port_args[0].float(), *port_args[1:],
                                  num_heads=4, scale=scale)
    xg = _t(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        pfa.fused_trunk_attention(xg, *port_args, num_heads=4, scale=scale)


# ------------------------------------------------- the kernel's geometry

#: block_q values a caller may pass: JAX's fused_trunk_attention takes any
#: positive one and legalizes it (``ddim_cold_tpu/ops/tiling.legal_block``)
BLOCK_QS = (1, 16, 32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768,
            1024, 2048, 4096)


@pytest.mark.parametrize("block_q", BLOCK_QS)
@pytest.mark.parametrize("config", sorted(MODEL_CONFIGS))
def test_fused_geometry_covers_every_config_and_block_q(config, block_q):
    """At every model's N and C, for every block_q: the rows cover N with
    whole clusters and no cluster to spare; in w8a8 the requant block is the
    one JAX cuts (``legal_block`` at int8), a whole number of CTAs inside a
    cluster, or the call is refused with the kernel's message."""
    cfg = MODEL_CONFIGS[config]
    (h, w), p = cfg["img_size"], cfg["patch_size"]
    N, C, H, B = (h // p) * (w // p) + 1, cfg["embed_dim"], cfg["num_heads"], 3
    cluster = pfa.FUSED_ROWS * pfa.FUSED_CLUSTER
    for mode in pfa.FUSED_MODES:
        bq = jtiling.legal_block(block_q, N, jnp.int8)
        if mode == "w8a8" and bq not in (64, 128, 256, 512):
            with pytest.raises(ValueError, match=f"takes block_q of 64, 128, 256 "
                                                 f"or 512 rows, got {bq}$"):
                pfa.fused_geometry(B, N, C, H, block_q, mode)
            continue
        g = pfa.fused_geometry(B, N, C, H, block_q, mode)
        assert g.rows >= N and g.rows % cluster == 0 and g.rows - N < cluster
        assert pfa.FUSED_CLUSTER % g.group == 0
        if mode == "w8a8":
            assert g.group * pfa.FUSED_ROWS == bq and g.rows % bq == 0
        else:
            assert g.group == 1


@pytest.mark.parametrize("C,H,mode", [(48, 3, "pallas"), (96, 3, "pallas"),
                                      (256, 2, "w8a8"), (2048, 32, "w8a8")])
def test_fused_geometry_refuses_what_the_kernel_cannot_take(C, H, mode):
    """Head dim 16 or 128, C not a multiple of 64, and w8a8 past the exact
    f32 sums."""
    match = "exact|sums" if C > pq.EXACT_F32_K else "head dim"
    with pytest.raises(ValueError, match=match):
        pfa.fused_geometry(2, 257, C, H, 512, mode)


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def jax_params():
    """A JAX parameter tree from the port's seeded init (bridged, which is
    cheaper than a JAX init), with small random biases so that every bias
    epilogue is exercised."""
    rs = np.random.RandomState(0)
    state = {k: (v + torch.from_numpy(rs.randn(*v.shape).astype(np.float32)) * 0.02
                 if k.endswith("bias") else v)
             for k, v in PortViT(**TINY, device="cpu").state_dict().items()}
    return flax_from_torch_state_dict(state, TINY["patch_size"])


def _port(jax_params, **kw) -> PortViT:
    model = PortViT(**TINY, use_flash=True, device="cpu", **kw)
    state = state_dict_from_flax(jax_params, 4)
    if kw.get("quant"):
        state = pq.quantize_state_dict(state)
    model.load_state_dict(state, strict=True)
    return model


ALLOWED = [("xla", False), ("pallas", False), ("w8a8", False),
           ("pallas", True), ("w8a8", True), (None, True)]


@pytest.mark.parametrize("quant,fused", ALLOWED)
def test_forward_matches_jax_for_every_quant_and_fused(jax_params, quant, fused):
    rs = np.random.RandomState(9)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = rs.randint(0, 2000, size=(2,)).astype(np.int32)
    jmodel = DiffusionViT(**TINY, use_flash=True).clone(quant=quant, fused=fused)
    params = jq.quantize_params(jax_params) if quant else jax_params
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = _port(jax_params, quant=quant, fused=fused)(_t(x), _t(t))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_quant_model_from_seed_is_the_quantized_float_model():
    """A quant model's seeded init is the float model's, quantized; a float
    state_dict loads into it after quantize_state_dict, strict."""
    float_model = PortViT(**TINY, device="cpu", seed=3)
    q = PortViT(**TINY, device="cpu", seed=3, quant="w8a8", fused=True)
    want = pq.quantize_state_dict(float_model.state_dict())
    got = q.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    q.load_state_dict(want, strict=True)
    assert q.kernel_libraries() == ("fused_trunk", "mlp_fused")
    assert float_model.clone(quant="pallas").kernel_libraries() == ("dequant_mm",)
    with pytest.raises(RuntimeError, match="forward-only"):
        float_model.clone(fused=True)(torch.zeros(1, 16, 16, 3), torch.zeros(1))


@pytest.mark.parametrize("kw,match", [
    (dict(quant="xla", fused=True), "opts out of Pallas"),
    (dict(quant="pallas", num_experts=2), "dense trunk only"),
    (dict(quant="int4"), "quant must be"),
    (dict(flash_blocks=(32,)), "flash_blocks"),
])
def test_refusals_match_jax(jax_params, kw, match):
    with pytest.raises(ValueError, match=match):
        PortViT(**TINY, device="cpu", **kw)
    if "flash_blocks" in kw or kw.get("quant") == "int4":
        return
    with pytest.raises(ValueError, match=match):
        DiffusionViT(**TINY, **kw).apply({"params": jax_params},
                                         jnp.zeros((1, 16, 16, 3)),
                                         jnp.zeros((1,), jnp.int32))


# ------------------------------------------------------------- the engine

CONFIGS = [port_serve.SamplerConfig(k=K, quant=q, fused=f) for q, f in
           [(None, False), ("pallas", False), ("pallas", True), ("w8a8", True),
            (None, True), ("xla", False), ("w8a8", False)]]


@pytest.fixture(scope="module")
def warmed():
    model = PortViT(**TINY, use_flash=True, device="cpu", seed=5)
    eng = port_serve.Engine(model, buckets=(2, 4), device="cpu")
    report = port_serve.warmup(eng, CONFIGS)
    assert report["new_programs"] == 2 * len(CONFIGS)
    return eng


def test_engine_quant_configs_bitwise_at_dispatch_shape(warmed):
    """Each config's rows equal a direct ddim_sample on the same variant at
    the same dispatch shape; a mixed float/quant stream adds no program."""
    eng = warmed
    programs = eng.stats["programs"]
    tickets = [(c, eng.submit(seed=11, n=4, config=c)) for c in CONFIGS]
    report = eng.run()
    assert report["programs"] == 0 and eng.stats["programs"] == programs
    assert report["batches"] == len(CONFIGS) and report["failed_tickets"] == 0
    outs = {}
    for config, ticket in tickets:
        got = ticket.result(timeout=5)
        want = port_sampling.ddim_sample(
            eng._model_for(config), torch.Generator().manual_seed(11), n=4, k=K,
            device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        outs[(config.quant, config.fused)] = got
    # the quantized trunk moves the images a little, never a lot
    for key, got in outs.items():
        assert np.abs(got - outs[(None, False)]).max() < 0.05, key
    np.testing.assert_array_equal(outs[(None, True)], outs[(None, False)])


def test_engine_quant_and_float_never_coalesce(warmed):
    eng = warmed
    float_cfg, quant_cfg = CONFIGS[0], CONFIGS[2]
    t_f = eng.submit(seed=1, n=1, config=float_cfg)
    t_q = eng.submit(seed=1, n=1, config=quant_cfg)
    report = eng.run()
    assert (report["batches"], report["rows"], report["padded_rows"]) == (2, 2, 2)
    assert not np.array_equal(t_f.result(timeout=5), t_q.result(timeout=5))


def test_engine_shares_one_int8_state_and_reports_bytes(warmed):
    eng = warmed
    stats = eng.stats
    assert stats["param_bytes"] == pq.param_bytes(eng.model.state_dict())
    assert 0 < stats["param_bytes_quant"] < stats["param_bytes"]
    a = eng._model_for(CONFIGS[1]).blocks[0].attn.qkv.w_int8
    b = eng._model_for(CONFIGS[3]).blocks[0].attn.qkv.w_int8
    assert a.data_ptr() == b.data_ptr()                       # one int8 state
    assert (eng._model_for(CONFIGS[1]).pos_embed.data_ptr()
            == eng.model.pos_embed.data_ptr())                # float tensors shared
    with pytest.raises(ValueError, match="float, unfused"):
        port_serve.Engine(eng._model_for(CONFIGS[2]), buckets=(2,), device="cpu")
