"""The port's flash-attention backward against the JAX Pallas VJP.

On the CPU the port's ``FlashAttention`` autograd function runs the plain
versions of the kernels (``flash_forward_reference``,
``flash_backward_reference``); it is held against
``jax.vjp(ddim_cold_tpu.ops.flash_attention.flash_attention)``, whose
custom VJP runs the Pallas ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in
interpret mode here, with 16-row blocks so a ragged N=37 spans three q and
three kv chunks, the last ones masked. The CUDA kernels are held against
the plain versions on the card (tests/test_torch_port_kernels.py).

Tolerances: float32 rtol=atol=1e-5 (f32 products both sides, summed in
another order; the JAX side at float32 matmul precision, tests/conftest.py);
bfloat16 element-wise within ``grad_error_limit`` of the JAX gradient, twice
over: one bf16 ulp of each element plus 2⁻⁶·mean|g| for rounding P and dS to
bf16 from f32 values that differ in the last bits, and as much again
because here the two sides' lse also come from two different forwards (JAX's
online softmax over chunks, the port's one-pass softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.ops import flash_attention as port
from ddim_cold_tpu.ops import flash_attention as ref

N_RAGGED = 37


def _inputs(B, N, H, D, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, N, H, D).astype(np.float32) for _ in range(4))
    return q, k, v, do


def _jax_grads(q, k, v, do, scale, dtype):
    f = lambda q, k, v: ref.flash_attention(q, k, v, scale, 16, 16)  # noqa: E731
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(dtype))]


def _port_grads(q, k, v, do, scale, dtype):
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(dtype).requires_grad_(True)
    o = port.flash_attention_qkv(qkv, scale)
    (g,) = torch.autograd.grad(o, qkv, torch.from_numpy(do).to(dtype))
    assert g.shape == qkv.shape and g.dtype == dtype
    return [g[:, :, i] for i in range(3)]


@pytest.mark.parametrize("D", [32, 64])
def test_backward_matches_jax_pallas_vjp_f32(D):
    q, k, v, do = _inputs(2, N_RAGGED, 3, D, seed=D)
    scale = D**-0.5
    want = _jax_grads(q, k, v, do, scale, jnp.float32)
    got = _port_grads(q, k, v, do, scale, torch.float32)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [32, 64])
def test_backward_matches_jax_pallas_vjp_bf16(D):
    q, k, v, do = _inputs(2, N_RAGGED, 3, D, seed=D + 1)
    scale = D**-0.5
    want = _jax_grads(q, k, v, do, scale, jnp.bfloat16)
    got = _port_grads(q, k, v, do, scale, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        w = torch.from_numpy(np.array(w))
        limit = 2 * port.grad_error_limit(w.to(torch.bfloat16))
        err = (g.float() - w).abs()
        assert bool((err <= limit).all()), (name, err.max().item(), (err / limit).max().item())


def test_plain_backward_is_the_float64_gradient():
    """The plain backward in f32 is the exact attention gradient (float64
    autograd through softmax(q·kᵀ·scale)·v) to f32 accuracy."""
    q, k, v, do = _inputs(2, 23, 2, 8, seed=3)
    got = _port_grads(q, k, v, do, 0.4, torch.float32)
    q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q64, k64) * 0.4, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", p, v64)
    want = torch.autograd.grad(o, (q64, k64, v64), torch.from_numpy(do).double())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=1e-5, atol=1e-6)


def test_gradient_is_one_buffer_and_the_plain_version_never_counts():
    """The backward hands autograd one (B, N, 3, H, D) buffer: the qkv
    projection's gradient, no sum of three copies; on the CPU nothing is
    launched."""
    q, k, v, do = _inputs(1, 9, 2, 8, seed=4)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_(True)
    before = dict(port.LAUNCHES)
    o = port.flash_attention_qkv(qkv, 0.3)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FlashAttentionBackward"
    o.backward(torch.from_numpy(do))
    assert qkv.grad.shape == qkv.shape
    assert dict(port.LAUNCHES) == before
    qo, ko, vo = qkv.detach().unbind(2)
    o_ref, lse = port.flash_forward_reference(qo, ko, vo, 0.3)
    torch.testing.assert_close(
        qkv.grad, port.flash_backward_reference(qo, ko, vo, o_ref, lse,
                                                torch.from_numpy(do), 0.3),
        rtol=0, atol=0)


def test_flash_attention_of_separate_views_is_differentiable():
    """``flash_attention(q, k, v)`` stacks its inputs into one projection
    when they need a gradient, and gives each its slice of the buffer."""
    q, k, v, do = _inputs(1, 11, 2, 8, seed=5)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = port.flash_attention(qt, kt, vt, 0.3)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    want = _port_grads(q, k, v, do, 0.3, torch.float32)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with torch.no_grad():  # no gradient wanted: the plain forward only
        assert port.flash_attention(qt, kt, vt, 0.3).grad_fn is None


@pytest.mark.parametrize("bad", ["o_shape", "o_dtype", "lse_shape", "lse_dtype"])
def test_backward_rejects_mismatched_residuals(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 5, 2, 8, seed=6))
    o, lse = port.flash_forward_reference(q, k, v, 0.3)
    if bad == "o_shape":
        o = o[:, :4]
    elif bad == "o_dtype":
        o = o.double()
    elif bad == "lse_shape":
        lse = lse[:, :4]
    else:
        lse = lse.double()
    with pytest.raises(ValueError):
        port.flash_backward(q, k, v, o, lse, do, 0.3)


def test_backward_refuses_devices_it_has_no_route_for():
    x = torch.empty((1, 5, 2, 8), device="meta")
    lse = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_backward(x, x, x, x, lse, x, 1.0)
