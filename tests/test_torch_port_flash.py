"""The port's flash-attention forward against the JAX Pallas kernel.

On the CPU the wrapper computes the plain version; that version is held
against the JAX package's ``_flash_forward`` run in interpret mode (the
Pallas kernel itself, several K/V chunks and the ragged-tail mask). The
hand-written CUDA kernel is held against the plain version in
tests/test_torch_port_kernels.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.ops import flash_attention as port
from ddim_cold_tpu.ops import flash_attention as ref


def _qkv(B, N, H, D, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, N, H, D).astype(np.float32) for _ in range(3)]


def test_plain_matches_jax_pallas_interpret():
    """Ragged N=37 with 16-row blocks on the JAX side: three kv chunks, the
    last one masked. O and lse at rtol=atol=1e-5 (f32 softmax both sides)."""
    B, N, H, D = 2, 37, 4, 8
    q, k, v = _qkv(B, N, H, D)
    scale = D**-0.5
    o_ref, lse_ref = ref._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), scale, 16, 16)
    o, lse = port.flash_forward_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :N],
                               rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_plain_version_and_reads_strided_views():
    """On CPU tensors the wrapper is the plain version; q/k/v may be the
    strided slices of a (B, N, 3, H, D) projection, as the model passes."""
    B, N, H, D = 2, 23, 4, 8
    rs = np.random.RandomState(1)
    qkv = torch.from_numpy(rs.randn(B, N, 3, H, D).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = port.LAUNCHES["flash_fwd"]
    o, lse = port.flash_forward(q, k, v, 0.3)
    o2, lse2 = port.flash_forward_reference(q.contiguous(), k.contiguous(),
                                            v.contiguous(), 0.3)
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)
    assert o.shape == (B, N, H, D) and lse.shape == (B * H, N)
    assert port.LAUNCHES["flash_fwd"] == before  # the plain version never counts
    torch.testing.assert_close(port.flash_attention(q, k, v, 0.3), o)


def test_plain_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: logits and softmax in f32, p rounded to bf16 before P·V,
    O emitted in bf16 — within bf16 resolution of the f32 computation."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 2, 8, seed=2))
    o32, lse32 = port.flash_forward_reference(q, k, v, 0.35)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    o16, lse16 = port.flash_forward_reference(qb, kb, vb, 0.35)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    o_exact, lse_exact = port.flash_forward_reference(qb.float(), kb.float(),
                                                      vb.float(), 0.35)
    torch.testing.assert_close(lse16, lse_exact, rtol=0, atol=1e-6)
    torch.testing.assert_close(o16.float(), o_exact, rtol=0, atol=2e-2)
    torch.testing.assert_close(o16.float(), o32, rtol=0, atol=5e-2)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_wrapper_rejects_mismatched_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 5, 2, 8))
    if bad == "shape":
        k = k[:, :4]
    elif bad == "dtype":
        k = k.double()
    else:
        k = k.to("meta")
    with pytest.raises(ValueError):
        port.flash_forward(q, k, v, 1.0)


def test_wrapper_refuses_devices_it_has_no_route_for():
    q = torch.empty((1, 5, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_forward(q, q, q, 1.0)


@pytest.mark.parametrize("block_kv", [8, 512])
@pytest.mark.parametrize("N", [17, 257])
def test_blockwise_attention_matches_jax(N, block_kv):
    """``blockwise_attention_xla`` (JAX's use_flash="xla" route) against
    JAX's on the same f32 inputs, 1e-5: the same online-softmax steps over
    the same K/V blocks, the ragged last block masked at ``_NEG_INF``
    (N=17, 257 against blocks of 8), one block holding all keys at 512.
    It launches nothing."""
    q, k, v = _qkv(2, N, 2, 16, seed=N)
    scale = 16**-0.5
    before = dict(port.LAUNCHES)
    got = port.blockwise_attention_xla(*map(torch.from_numpy, (q, k, v)), scale, block_kv)
    want = ref.blockwise_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       scale, block_kv)
    assert got.dtype == torch.float32 and got.shape == (2, N, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert dict(port.LAUNCHES) == before
    bf = port.blockwise_attention_xla(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                      scale, block_kv)
    assert bf.dtype == torch.bfloat16  # output in q's dtype, f32 inside
