"""The port's int8 codec, dequant matmul and fused Mlp against the JAX package's.

Inputs come from numpy seeds and go to both packages; JAX runs on the CPU at
float32 matmul precision (tests/conftest.py) and its Pallas kernels
(``_mm_kernel``, ``_mlp_kernel``) in interpret mode, through its public
functions. Weights are in JAX's ``(in, out)`` layout on the JAX side and
transposed to the port's ``(out, in)``.

Tolerances and why:
* codec: bit for bit (the same f32 divisions, round half to even, clip);
* dequant matmul, f32: rtol 1e-6, atol 1e-6 (the same products summed in
  another order; the int8×int8 sum is exact on both sides);
* fused Mlp, f32: 1e-5 (two GEMMs and an erf through f32 round-off);
  bf16: ``2⁻⁶·|y| + 2⁻⁴·mean|y|``, a few bf16 ulps: the port computes the
  GELU in f32 and rounds once, JAX rounds in bf16 at its own points, so a
  hidden value may land one bf16 ulp apart (and, in w8a8, one int8 code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import quant as pq
from ddim_cold_torch.ops import tiling as ptiling
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import quant as jq
from ddim_cold_tpu.utils.checkpoint import flax_from_torch_state_dict
from ddim_cold_tpu.ops import tiling as jtiling

TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2,
            num_heads=4, total_steps=2000)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _weights_with_edges(rs, k, n):
    """Random (in, out) weights plus an all-zero column and a column whose
    values sit exactly on .5 code boundaries (scale 2⁻⁷: 127·2⁻⁷ is its
    max, and (j + ½)·2⁻⁷ is a tie that rounds to even)."""
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    ties = (np.arange(k) % 20 - 10 + 0.5).astype(np.float32)
    ties[0] = 127.0
    w[:, 1] = ties * 2.0**-7
    return w


# ----------------------------------------------------------------- codec

def test_quantize_weight_bit_exact_with_jax():
    w = _weights_with_edges(np.random.RandomState(0), 50, 33)
    j_codes, j_scale = jq.quantize_weight(jnp.asarray(w))
    codes, scale = pq.quantize_weight(_t(w.T))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    assert scale[0] == 1.0 and not codes[0].any()          # the zero column
    assert codes[1, 1] == -8 and codes[1, 2] == -8         # -8.5, -7.5: to even
    back = pq.dequantize_weight(codes, scale)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.dequantize_weight(j_codes, j_scale)).T)


def test_quantize_act_bit_exact_with_jax():
    x = np.random.RandomState(1).randn(3, 7, 16).astype(np.float32)
    x[0, 0, 0] = 127 * 2.0**-5
    x[1, :, 3] = (np.arange(7) - 3 + 0.5) * 2.0**-5       # ties
    j_codes, j_scale = jq.quantize_act(jnp.asarray(x))
    codes, scale = pq.quantize_act(_t(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    assert scale.item() == float(j_scale)
    zero_codes, zero_scale = pq.quantize_act(torch.zeros(4))
    assert zero_scale.item() == 1.0 and not zero_codes.any()


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


def test_quantize_state_dict_equals_bridge_of_quantize_params(jax_params):
    mine = pq.quantize_state_dict(state_dict_from_flax(jax_params, 4))
    bridged = state_dict_from_flax(jax.device_get(jq.quantize_params(jax_params)), 4)
    assert mine.keys() == bridged.keys()
    for key in mine:
        assert mine[key].dtype == bridged[key].dtype, key
        torch.testing.assert_close(mine[key], bridged[key], rtol=0, atol=0)
    assert {k for k in mine if k.endswith("w_int8")} == {
        f"blocks.{i}.{m}.w_int8" for i in range(2)
        for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")}
    assert "patch_embed.proj.weight" in mine          # the parent-name rule
    assert pq.is_quantized(mine) and not pq.is_quantized(state_dict_from_flax(jax_params, 4))


def test_calibrate_and_param_bytes_agree_with_jax(jax_params):
    sd = state_dict_from_flax(jax_params, 4)
    want = jq.calibrate(jax_params)
    got = pq.calibrate(sd)
    assert {k.replace(".", "/").replace("blocks/", "blocks_") for k in got} == set(want)
    for key, stats in got.items():
        ref = want[key.replace(".", "/").replace("blocks/", "blocks_")]
        assert stats["shape"] == ref["shape"][::-1]
        for name in ("max_abs_err", "max_err_over_scale", "scale_min", "scale_max"):
            assert stats[name] == ref[name], (key, name)
    assert pq.param_bytes(sd) == jq.param_bytes(jax_params)
    assert (pq.param_bytes(pq.quantize_state_dict(sd))
            == jq.param_bytes(jq.quantize_params(jax_params)))


def test_legal_block_matches_jax():
    for req, dim, dtype in ((512, 2501, torch.int8), (256, 300, torch.int8),
                            (32, 65, torch.int8), (256, 20008, torch.bfloat16),
                            (100, 7, torch.float32)):
        jdt = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16,
               torch.float32: jnp.float32}[dtype]
        assert ptiling.legal_block(req, dim, dtype) == jtiling.legal_block(req, dim, jdt)


# ------------------------------------------------------- dequant matmul

@pytest.mark.parametrize("mode", ["xla", "pallas", "w8a8"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", [(7, 33, 50), (16, 128, 256)])
def test_dequant_matmul_matches_jax(mode, with_bias, shape):
    M, K, N = shape
    rs = np.random.RandomState(M)
    x = rs.randn(M, K).astype(np.float32)
    j_codes, j_scale = jq.quantize_weight(jnp.asarray(rs.randn(K, N).astype(np.float32)))
    bias = rs.randn(N).astype(np.float32) if with_bias else None
    want = np.asarray(jq.dequant_matmul(
        jnp.asarray(x), j_codes, j_scale,
        bias=None if bias is None else jnp.asarray(bias), mode=mode))
    got = pq.dequant_matmul(_t(x), _t(j_codes).T.contiguous(), _t(j_scale),
                            bias=None if bias is None else _t(bias), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dequant_matmul_validation_and_int_exactness():
    codes, scale = pq.quantize_weight(torch.ones(3, 4))
    with pytest.raises(ValueError, match="mode"):
        pq.dequant_matmul(torch.zeros(2, 4), codes, scale, mode="int4")
    with pytest.raises(ValueError, match="int8"):
        pq.dequant_matmul(torch.zeros(2, 4), torch.ones(3, 4), scale)
    # past K = 1040 the f32 sum of int8 products would round: float64 keeps it
    a = torch.full((1, 2048), 127, dtype=torch.int8)
    assert pq.int8_matmul(a, a).item() == 2048 * 127 * 127


@pytest.mark.parametrize("K,stride,ptr,want", [
    (256, 256, 0, (256, False)), (256, 768, 512, (256, False)),  # rows in place
    (33, 33, 0, (48, True)), (40, 40, 0, (48, True)),            # ragged K
    (250, 256, 0, (256, True)),
    (256, 260, 0, (256, True)), (256, 256, 2, (256, True))])     # misaligned rows
def test_bf16_row_layout(K, stride, ptr, want):
    """The bfloat16 dequant_mm kernel reads x in place only when K is a
    multiple of 16 and its rows start on 16-byte boundaries; otherwise the
    wrapper copies x into a zero-padded K."""
    assert pq.bf16_row_layout(K, stride, ptr) == want


def test_zero_padded_k_leaves_the_dequant_matmul():
    """The padding route: x and the codes with zero columns appended give
    the same product (zeros change no sum), within the kernel limit."""
    rs = np.random.RandomState(11)
    x = _t(rs.randn(7, 33).astype(np.float32)).to(torch.bfloat16)
    w, s = pq.quantize_weight(_t(rs.randn(50, 33).astype(np.float32)))
    ref = pq.dequant_mm_reference(x, w, s)
    padded = pq.dequant_mm_reference(pq._zero_pad_cols(x, 48), pq._zero_pad_cols(w, 48), s)
    assert bool(((padded - ref).abs() <= pq.mm_error_limit(x, w, s, ref)).all())


def test_quant_linear_grad_rule():
    lin = torch.nn.Linear(8, 4)
    q = pq.QuantLinear.from_linear(lin, "pallas")
    x = torch.randn(2, 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        q(x)
    with torch.no_grad():
        assert q(x).shape == (2, 4)
    xla = pq.QuantLinear.from_linear(lin, "xla")
    xla(x).sum().backward()                            # plain PyTorch: differentiable
    assert xla.bias.grad is not None


# -------------------------------------------------------------- fused Mlp

def _mlp_case(seed=3, M=300, K=32, Hf=64, Nout=32):
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    w1 = (rs.randn(K, Hf) * 0.2).astype(np.float32)
    b1 = (rs.randn(Hf) * 0.1).astype(np.float32)
    w2 = (rs.randn(Hf, Nout) * 0.2).astype(np.float32)
    b2 = (rs.randn(Nout) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [None, "pallas", "w8a8"])
def test_mlp_fused_matches_jax(mode, dtype):
    """M = 300 rows: two w8a8 block_m tiles of 256, the second padded with
    212 x = 0 rows whose gelu(b1) counts in its amax."""
    x, w1, b1, w2, b2 = _mlp_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if mode is None:
        want = jq.mlp_pallas(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                             jnp.asarray(w2), jnp.asarray(b2))
        got = pq.mlp_fused(_t(x).to(tdt), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    else:
        c1, s1 = jq.quantize_weight(jnp.asarray(w1))
        c2, s2 = jq.quantize_weight(jnp.asarray(w2))
        want = jq.mlp_pallas(jnp.asarray(x, jdt), c1, jnp.asarray(b1), c2,
                             jnp.asarray(b2), scale1=s1, scale2=s2, mode=mode)
        got = pq.mlp_fused(_t(x).to(tdt), _t(c1).T.contiguous(), _t(b1),
                           _t(c2).T.contiguous(), _t(b2), scale1=_t(s1),
                           scale2=_t(s2), mode=mode)
    assert got.dtype == tdt and got.shape == (300, 32)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        limit = 2.0**-6 * np.abs(want) + 2.0**-4 * np.abs(want).mean()
        assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


def test_mlp_fused_w8a8_pads_and_tiles():
    """The w8a8 hidden requant is per legal_block(block_m, M, int8) rows of
    the zero-padded rows: 300 rows give the same values as the 512 rows
    padded explicitly (zero rows leave the per-tensor x scale alone, and
    their gelu(b1) counts in the last tile's amax either way), while cutting
    the rows into other tiles changes them."""
    x, w1, b1, w2, b2 = _mlp_case()
    c1, s1 = pq.quantize_weight(_t(w1.T))
    c2, s2 = pq.quantize_weight(_t(w2.T))
    run = lambda xs, bm: pq.mlp_fused(xs, c1, _t(b1), c2, _t(b2), scale1=s1,
                                      scale2=s2, mode="w8a8", block_m=bm)
    full = run(_t(x), 256)
    padded = np.concatenate([x, np.zeros((212, x.shape[1]), np.float32)])
    torch.testing.assert_close(run(_t(padded), 256)[:300], full, rtol=0, atol=0)
    assert not torch.equal(full, run(_t(x), 64))
    w8a16 = pq.mlp_fused(_t(x), c1, _t(b1), c2, _t(b2), scale1=s1, scale2=s2,
                         mode="pallas")
    assert (full - w8a16).abs().max() < 0.05 * w8a16.abs().max()


@pytest.mark.parametrize("cta_rows", [32, 128])
@pytest.mark.parametrize("block_m", [32, 64, 96, 128, 160, 192, 224, 256])
def test_mlp_geometry_covers_whole_requant_tiles(cta_rows, block_m):
    """Every legal w8a8 block_m (a multiple of 32 up to 256) against the
    float32 route's 32-row CTAs and the bfloat16 route's 128-row ones: a
    cluster of at most 8 CTAs covers whole tiles and whole CTAs, the grid
    covers M's padded last tile, and the 32-row geometry is block_m / 32
    CTAs over M rounded up to block_m."""
    for M in (1, 20, 90, 300, 2501, 20008):
        rows, cluster = pq.mlp_geometry(M, block_m, cta_rows)
        span = cluster * cta_rows
        assert 1 <= cluster <= 8
        assert span % block_m == 0 and rows % span == 0
        assert ptiling.round_up(M, block_m) <= rows < ptiling.round_up(M, block_m) + span
        if cta_rows == 32:
            assert (rows, cluster) == (ptiling.round_up(M, block_m), block_m // 32)


def test_mlp_fused_w8a8_odd_block_matches_jax():
    """M = 90 legalises block_m 256 to 96 rows, a requant tile that is not a
    multiple of 64 rows: the port's tiles match JAX's."""
    x, w1, b1, w2, b2 = _mlp_case(seed=5, M=90)
    c1, s1 = jq.quantize_weight(jnp.asarray(w1))
    c2, s2 = jq.quantize_weight(jnp.asarray(w2))
    assert ptiling.legal_block(256, 90, torch.int8) == 96
    want = jq.mlp_pallas(jnp.asarray(x), c1, jnp.asarray(b1), c2, jnp.asarray(b2),
                         scale1=s1, scale2=s2, mode="w8a8", block_m=256)
    got = pq.mlp_fused(_t(x), _t(c1).T.contiguous(), _t(b1), _t(c2).T.contiguous(),
                       _t(b2), scale1=_t(s1), scale2=_t(s2), mode="w8a8", block_m=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_fused_validation():
    x, w1, b1, w2, b2 = _mlp_case(M=4)
    with pytest.raises(ValueError, match="mode"):
        pq.mlp_fused(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), mode="xla")
    c1, _ = pq.quantize_weight(_t(w1.T))
    c2, _ = pq.quantize_weight(_t(w2.T))
    with pytest.raises(ValueError, match="scale"):
        pq.mlp_fused(_t(x), c1, _t(b1), c2, _t(b2), mode="pallas")
