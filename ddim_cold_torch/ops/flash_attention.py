"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``ddim_cold_tpu/ops/flash_attention.py`` (the unfused
kernels). ``softmax(q·kᵀ·scale)·v`` over ``(B, N, H, D)`` tensors, forward
and backward, without an N×N matrix ever reaching device memory:

* :func:`flash_forward` launches ``csrc/flash_fwd.cu`` and returns O plus the
  per-row log-sum-exp;
* :func:`flash_backward` launches the two kernels of ``csrc/flash_bwd.cu``
  (dq; dk and dv), which rebuild P from that lse;
* :class:`FlashAttention` (through :func:`flash_attention_qkv` and
  :func:`flash_attention`) is the ``torch.autograd.Function`` joining them:
  residuals (qkv, o, lse), and one ``(B, N, 3, H, D)`` gradient buffer for
  the qkv projection, so autograd never sums three copies;
* :func:`blockwise_attention_xla` is the JAX package's blockwise
  online-softmax route (the model's ``use_flash="xla"``), which JAX computes
  outside any Pallas kernel: plain PyTorch here, differentiable by autograd,
  and it launches no kernel of its own. :func:`online_softmax_update` is its
  step (and the ring-attention step's, in JAX).

Each wrapper takes its kernel on a CUDA tensor and the plain PyTorch version
of the same function (:func:`flash_forward_reference`,
:func:`flash_backward_reference`) on a CPU tensor. There is no other route:
a CUDA call that cannot build or launch a kernel raises. See the ``.cu``
headers for each kernel's design and what bounds it.

The TPU kernel's padding of D to 128 lanes and N to 8 rows, its
lane-replicated (m, l, lse) scratch, the Mosaic tile legalisation and the
dense fallback off-TPU have no counterpart here; the kernel masks the
ragged tail itself and reads q/k/v through their strides.
"""

from __future__ import annotations

import collections
import threading
from typing import NamedTuple

import torch

from ddim_cold_torch.ops import _build, quant, tiling
from ddim_cold_torch.utils import profiling

#: launches per kernel, counted where the kernel is launched and nowhere
#: else (the plain version does not count). Reset by assigning 0.
LAUNCHES: collections.Counter = collections.Counter()  # guarded-by: _LAUNCH_LOCK
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to :data:`LAUNCHES`, under a lock:
    ``Counter[name] += 1`` is a read and a write, and several threads (the
    fleet's in-process replicas) launch at once."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1

KERNEL_HEAD_DIMS = (32, 64)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load_kernel():
    """Build (first time) and load the forward kernel's library; raises
    without CUDA."""
    return _build.load_library("flash_fwd")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: f32 logits and softmax, p rounded to v's dtype
    before P·V exactly where the kernel rounds it. Returns ``(o, lse)``:
    o ``(B, N, H, D)`` in q's dtype, lse ``(B·H, N)`` f32."""
    _check(q, k, v)
    B, N, H, _ = q.shape
    o, m, l = _softmax_pv(q, k, v, scale)
    return o, (m + torch.log(l)).reshape(B * H, N)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor to within about an ulp on every device, for
    the plain versions' softmax. On the CPU torch's f32 ``exp`` runs MKL's
    vector math library, whose accuracy mode is per thread: in a process's
    first call a worker thread has been seen to compute its chunk at ~1.5e-4
    relative error (3 processes in 150 on a restricted CPU set; ROADMAP
    Queue 3 item 2), so there the exp is taken in float64 and rounded back.
    On CUDA it is ``torch.exp``."""
    if x.device.type == "cpu":
        return torch.exp(x.double()).to(x.dtype)
    return torch.exp(x)


def _softmax_pv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """softmax(q·kᵀ·scale)·v with f32 logits and softmax, p rounded to v's
    dtype before P·V; q ``(B, Nq, H, D)``, k/v ``(B, Nk, H, D)``. Returns
    o ``(B, Nq, H, D)`` in q's dtype and the row max and denominator,
    ``(B, H, Nq, 1)`` f32."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = exp_f32(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 2, 1, 3)  # (B, H, N, 1) → (B, N, H, 1)
    return o.to(q.dtype), m, l


def o_error_limit(o_ref: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |O_kernel − O_plain|, from the arithmetic.

    float32: 1e-5 (the same f32 operations summed in another order).
    bfloat16: ``2⁻⁷·|O_ref| + 2⁻⁵·mean|O_ref|``. Each side rounds O to bf16
    once, so they may land one ulp apart, and one bf16 ulp of x is at most
    2⁻⁷·|x|. The kernel rounds p against its running row max, the plain
    version against the final one, so the two P·V sums differ by a few
    2⁻⁸-relative errors of an O-sized sum of random signs: a few 2⁻⁸ of
    mean|O|, whatever the element's own size.
    """
    if o_ref.dtype == torch.float32:
        return torch.full_like(o_ref, 1e-5)
    ref = o_ref.float().abs()
    return 2.0**-7 * ref + 2.0**-5 * ref.mean()


def _check_kernel_inputs(what: str, *ts: torch.Tensor) -> None:
    """What every kernel takes on CUDA: D ∈ {32, 64}, float32 or bfloat16,
    a unit innermost stride."""
    D = ts[0].shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the {what} kernel takes head dim {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if ts[0].dtype not in KERNEL_DTYPES:
        raise ValueError(f"the {what} kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{ts[0].dtype}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("q, k, v need a unit innermost (head-dim) stride")


def _row_strides(t: torch.Tensor) -> list[int]:
    return [st * t.element_size() for st in t.stride()[:-1]]


def _rows_aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and not any(st % 16 for st in _row_strides(t))


def _check_rows_aligned(what: str, **ts: torch.Tensor) -> None:
    """The bfloat16 kernels copy 16-byte pieces of rows (cp.async): every
    base address and every stride but the innermost must be a multiple of
    16 bytes. Refused rather than copied, so a layout the kernel cannot take
    never costs a silent copy."""
    for name, t in ts.items():
        if not _rows_aligned(t):
            raise ValueError(
                f"the bfloat16 {what} kernel copies 16-byte row pieces: {name} "
                f"needs a 16-byte-aligned base and strides that are multiples "
                f"of 16 bytes, got address {t.data_ptr()} and strides "
                f"{_row_strides(t)} bytes")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused non-causal attention forward, returning ``(o, lse)``.

    q/k/v: ``(B, N, H, D)``, any strides with a unit innermost stride (the
    model passes the three slices of its ``(B, N, 3, H, D)`` qkv projection
    without copying them). o: ``(B, N, H, D)`` contiguous in q's dtype, so
    ``o.reshape(B, N, H·D)`` is free; lse: ``(B·H, N)`` f32, the residual a
    backward pass needs. On CUDA the kernel takes D ∈ {32, 64} and float32
    or bfloat16 (bfloat16 on the tensor cores, which also needs 16-byte
    aligned bases and strides, as the qkv projection's slices have), and
    anything else raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        with profiling.scope("flash_attention/fwd"):
            return flash_forward_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA (kernel) or CPU (plain "
                         f"version), got device {q.device}")
    B, N, H, D = q.shape
    _check_kernel_inputs("flash", q, k, v)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned("flash", q=q, k=k, v=v)
    lib = load_kernel()
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with profiling.scope("flash_attention/fwd"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, N, H, D,
                            KERNEL_DTYPES[q.dtype], *strides, float(scale),
                            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err} "
                           f"(B={B}, N={N}, H={H}, D={D}, {q.dtype})")
    count_launch("flash_fwd")
    return o, lse


def grad_error_limit(g_ref: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |g_kernel − g_plain| for dq, dk or dv.

    float32: ``2⁻¹⁶·|g_ref| + 2⁻¹³·mean|g_ref|``. Both sides do the same f32
    operations in another order. Each g is a sum over N terms of
    P·(dP − δ)·k (or P·dO): the per-term errors are a few 2⁻²⁴ of the term,
    and where dP ≈ δ the subtraction turns them into errors relative to |dP|
    rather than to the difference, so their random-sign sum is a small
    multiple of 2⁻²⁴·√N of a term-sized sum — well under 2⁻¹³ of mean|g|.
    bfloat16: ``2⁻⁷·|g_ref| + 2⁻⁶·mean|g_ref|``. Each side rounds g to bf16
    once, so they may land one ulp apart, and one bf16 ulp of x is at most
    2⁻⁷·|x|. Both sides rebuild P from the same lse, so they round P and dS to
    bf16 from f32 values that differ only in f32 ordering: a rounding lands on
    the other side of a bf16 boundary only rarely, and each such flip moves
    one term of a g-sized sum by 2⁻⁸ of itself. Unlike the forward's O limit
    (:func:`o_error_limit`) there is no running row max, so the second term
    is half the forward's.
    """
    ref = g_ref.float().abs()
    if g_ref.dtype == torch.float32:
        return 2.0**-16 * ref + 2.0**-13 * ref.mean()
    return 2.0**-7 * ref + 2.0**-6 * ref.mean()


def ds_flip_bound(q, k, v, do, lse, delta, scale: float):
    """How far bfloat16 rounding flips of dS can move dq and dk: ``(dq_flip,
    dk_flip)``, each ``(B, N, H, D)`` f32, added to :func:`grad_error_limit`
    where softmax rows are nearly one-hot (large logits).

    There dS holds a few large terms that cancel (each row sums to zero),
    and dq and dk are differences of terms far larger than themselves, so
    one dS rounding that lands on the other side of a bf16 boundary moves an
    element by more than the limit allows, whichever side is right. Two f32
    computations of dS_ij = P_ij·(dP_ij − δ_i) differ by at most
    ``e = P·(2⁻²²·D·(scale·A·|dP − δ| + G) + 2⁻²⁰·(1 + |S|·scale + |lse|)·|dP − δ|)``
    with A = |q|·|k|ᵀ and G = |dO|·|v|ᵀ: each side's dot products of D terms
    err by at most D·2⁻²³ of their absolute sums (a rounding or a tensor
    core's truncation per step), and the logit, the exponential and dS's
    own product by a few 2⁻²⁴ of the logit. Where the plain version's dS lies
    within ``e`` of a bf16 rounding boundary, the two sides may round it to
    neighbouring values one bf16 step apart, which moves dq_i by
    scale·step·|k_j| and dk_j by scale·step·|q_i|; the bound sums those
    moves over every such (i, j).
    """
    B, N, H, D = q.shape
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    lse4, delta4 = lse.reshape(B, H, N, 1), delta.reshape(B, H, N, 1)
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
    p = exp_f32(s * scale - lse4)
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    ds = p * (dp - delta4)
    w = (dp - delta4).abs()
    a = torch.einsum("bnhd,bmhd->bhnm", qf.abs(), kf.abs())
    g = torch.einsum("bnhd,bmhd->bhnm", gf.abs(), vf.abs())
    e = p * (2.0**-22 * D * (scale * a * w + g)
             + 2.0**-20 * (1 + s.abs() * scale + lse4.abs()) * w)
    step = quant.bf16_ulp(ds)
    near = step / 2 - (ds - ds.to(torch.bfloat16).float()).abs() <= e
    moved = near * step
    return (scale * torch.einsum("bhnm,bmhd->bnhd", moved, kf.abs()),
            scale * torch.einsum("bhnm,bnhd->bmhd", moved, qf.abs()))


def _check_backward(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    B, N, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and dO must have q's shape {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and dO must have q's dtype {q.dtype}, got "
                         f"{o.dtype}, {do.dtype}")
    if lse.shape != (B * H, N) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B * H}, {N}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (q.device == o.device == lse.device == do.device):
        raise ValueError("q, o, lse, dO devices differ")


def backward_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(O∘dO) in f32, as (B·H, N) (TPU path :344)."""
    B, N, H, _ = o.shape
    return ((o.float() * do.float()).sum(-1)  # (B, N, H)
            .transpose(1, 2).reshape(B * H, N).contiguous())


def _p_ds(q, k, v, do, lse, delta, scale):
    """P rebuilt from the lse and dS = P∘(dP − δ), both (B, H, N, N) f32."""
    B, N, H, _ = q.shape
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = exp_f32(logits - lse.reshape(B, H, N, 1))
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    return p, p * (dp - delta.reshape(B, H, N, 1))


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """The plain version of ``flash_bwd_dq``: dq = scale·dS·K with dS rounded
    to k's dtype, f32 products, ``(B, N, H, D)`` in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale: float):
    """The plain version of ``flash_bwd_dkv``: dk = scale·dSᵀ·Q with dS
    rounded to q's dtype, dv = Pᵀ·dO with P rounded to dO's dtype, f32
    products; ``(dk, dv)``, each ``(B, N, H, D)`` in q's dtype."""
    p, ds = _p_ds(q, k, v, do, lse, delta, scale)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(do.dtype).float(), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_backward_reference(q, k, v, o, lse, do, scale: float) -> torch.Tensor:
    """The plain version of both backward kernels: P rebuilt from ``lse``,
    dS = P∘(dP − δ), dS rounded to k's dtype before dS·K and to q's before
    dSᵀ·Q, P rounded to dO's dtype before Pᵀ·dO, all products in f32.
    Returns the ``(B, N, 3, H, D)`` gradient of the qkv projection in q's
    dtype: ``[:, :, 0]`` is dq, ``1`` dk, ``2`` dv."""
    _check_backward(q, k, v, o, lse, do)
    delta = backward_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    return torch.stack((dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)),
                       dim=2)


def _launch(symbol: str, q, k, v, do, lse, delta, outs: dict, scale: float) -> None:
    """Launch one backward kernel on the current stream; count it. ``outs``
    names the gradient outputs, in the kernel's order."""
    B, N, H, D = q.shape
    _check_kernel_inputs("flash backward", q, k, v, do, *outs.values())
    if q.dtype == torch.bfloat16:
        _check_rows_aligned("flash backward", q=q, k=k, v=v, dO=do, **outs)
    lib = _build.load_library("flash_bwd")
    first = next(iter(outs.values()))
    strides = [s for t in (q, k, v, do, first) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs.values()),
            B, N, H, D, KERNEL_DTYPES[q.dtype], *strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err} "
                           f"(B={B}, N={N}, H={H}, D={D}, {q.dtype})")
    count_launch(symbol)


def flash_bwd_dq(q, k, v, do, lse, delta, dq, scale: float) -> None:
    """Launch the dq kernel, writing ``dq`` (``(B, N, H, D)``, any strides
    with a unit innermost one); lse and δ ``(B·H, N)`` f32 contiguous. In
    bfloat16 (the tensor-core kernel) q, k, v, dO and dq need 16-byte
    aligned bases and row strides, else ValueError before any build or
    launch. CUDA tensors only: the CPU route is :func:`flash_backward`'s."""
    with profiling.scope("flash_attention/dq"):
        _launch("flash_bwd_dq", q, k, v, do, lse, delta, {"dq": dq}, scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale: float) -> None:
    """Launch the dk/dv kernel, writing ``dk`` and ``dv`` (two slices with
    the same strides; in bfloat16 16-byte aligned, as for
    :func:`flash_bwd_dq`). CUDA tensors only."""
    if dk.stride() != dv.stride():
        raise ValueError("dk and dv must share their strides")
    with profiling.scope("flash_attention/dkv"):
        _launch("flash_bwd_dkv", q, k, v, do, lse, delta, {"dk": dk, "dv": dv}, scale)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Gradient of :func:`flash_forward`'s O with respect to q, k and v.

    q/k/v: ``(B, N, H, D)``, any strides with a unit innermost stride (the
    slices of the qkv projection); o and lse: what the forward returned;
    do: dL/dO, ``(B, N, H, D)``. Returns one ``(B, N, 3, H, D)`` buffer in q's
    dtype holding dq, dk, dv as its three slices, the gradient of the qkv
    projection as autograd wants it. On CUDA it launches ``flash_bwd_dq``
    and ``flash_bwd_dkv`` (D ∈ {32, 64}, float32 or bfloat16; anything else
    raises; bfloat16 q/k/v need 16-byte aligned rows, as the projection's
    slices have); on the CPU it is :func:`flash_backward_reference`. A dO
    the kernels cannot read in place (a non-unit innermost stride, or in
    bfloat16 rows that are not 16-byte aligned) costs one ``(B, N, H, D)``
    copy, so a training step is never refused for dO's layout.
    """
    _check_backward(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        # flash_backward_reference, each kernel's plain version in its scope
        delta = backward_delta(o, do)
        with profiling.scope("flash_attention/dq"):
            dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
        with profiling.scope("flash_attention/dkv"):
            dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
        return torch.stack((dq, dk, dv), dim=2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on CUDA (kernels) or CPU (plain "
                         f"version), got device {q.device}")
    B, N, H, D = q.shape
    if do.stride(3) != 1 or (do.dtype == torch.bfloat16 and not _rows_aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    delta = backward_delta(o, do)
    lse = lse.contiguous()
    grad = torch.empty((B, N, 3, H, D), dtype=q.dtype, device=q.device)
    dq, dk, dv = grad.unbind(2)
    flash_bwd_dq(q, k, v, do, lse, delta, dq, scale)
    flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale)
    return grad


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over a ``(B, N, 3, H, D)`` qkv
    projection: forward :func:`flash_forward`, backward
    :func:`flash_backward` (the TPU path's ``jax.custom_vjp``). The residuals
    are the projection itself, O and the ``(B·H, N)`` f32 lse; the backward
    returns the projection's gradient as one buffer."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        o, lse = flash_forward(*qkv.unbind(2), scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, o, lse = ctx.saved_tensors
        return flash_backward(*qkv.unbind(2), o, lse, do, ctx.scale), None


def flash_attention_qkv(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention of the ``(B, N, 3, H, D)`` qkv projection's three slices,
    ``(B, N, H, D)`` in its dtype; differentiable through the kernels."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got {tuple(qkv.shape)}")
    return FlashAttention.apply(qkv, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """:func:`flash_forward` without the lse: ``(B, N, H, D)`` in q's dtype.
    Differentiable: q, k and v are stacked into one projection first (a
    copy the model avoids by calling :func:`flash_attention_qkv`)."""
    if not any(t.requires_grad for t in (q, k, v)) or not torch.is_grad_enabled():
        return flash_forward(q, k, v, scale)[0]
    _check(q, k, v)
    return flash_attention_qkv(torch.stack((q, k, v), dim=2), scale)


# ---------------------------------------------------------------------------
# the blockwise route (JAX's use_flash="xla"): plain PyTorch, no kernel
# ---------------------------------------------------------------------------

#: JAX's mask value for padded keys (ops/flash_attention.py ``_NEG_INF``)
_NEG_INF = -1e30
#: JAX's default K/V block of the blockwise route
DEFAULT_BLOCK_KV = 512


def online_softmax_update(o, l, m, logits, v_blk):
    """One blockwise-softmax step (JAX ``online_softmax_update``): fold a
    logits block into the running (numerator, denominator, max), all f32.
    o ``(..., nq, D)``, l/m ``(..., nq)``, logits ``(..., nq, bkv)``, v_blk
    ``(..., bkv, D)``; leading dims broadcast."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = exp_f32(logits - m_new[..., None])
    corr = exp_f32(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("...qk,...kd->...qd", p, v_blk)
    return o, l, m_new


def blockwise_attention_xla(q, k, v, scale: float,
                            block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """softmax(scale·q·kᵀ)·v over K/V blocks of ``block_kv`` keys with the
    online softmax (JAX ``blockwise_attention_xla``): only one (B, H, N,
    block_kv) logits block exists at a time. f32 softmax; K/V padded to a
    multiple of the block, the padded keys masked at ``_NEG_INF``. q/k/v
    ``(B, N, H, D)`` → ``(B, N, H, D)`` in q's dtype."""
    B, N, H, D = q.shape
    qf = q.float().transpose(1, 2)  # (B, H, N, D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    block_kv = min(int(block_kv), max(1, N))
    pad = (-N) % block_kv
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    valid = torch.arange(N + pad, device=q.device) < N
    o = torch.zeros((B, H, N, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, N), _NEG_INF, dtype=torch.float32, device=q.device)
    for lo in range(0, N + pad, block_kv):
        k_b, v_b = kf[:, :, lo:lo + block_kv], vf[:, :, lo:lo + block_kv]
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, k_b) * scale
        logits = torch.where(valid[lo:lo + block_kv], logits,
                             torch.tensor(_NEG_INF, device=q.device))
        o, l, m = online_softmax_update(o, l, m, logits, v_b)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# fused quantized trunk attention: qkv projection → flash → proj projection
# ---------------------------------------------------------------------------

#: quant modes of the fused trunk attention (w8a16 and w8a8)
FUSED_MODES = ("pallas", "w8a8")
#: JAX's (block_q, block_kv) where no tuned entry exists
#: (``ddim_cold_tpu/ops/flash_attention.py:66``): ``block_q`` is the w8a8
#: requant block here; the kernel's key tile is fixed
NS_FLASH_BLOCKS = (512, 4096)
#: query rows of one unit of ``csrc/fused_trunk.cu`` (a CTA in float32, a
#: warpgroup in bfloat16); 8 units (512 rows) form a thread-block cluster
#: sharing each key slice's projection, and a w8a8 ``block_q`` is
#: ``block_q / FUSED_ROWS`` units of one cluster
FUSED_ROWS = 64
FUSED_CLUSTER = 8


class FusedGeometry(NamedTuple):
    """The launch of ``csrc/fused_trunk.cu`` for one call."""

    rows: int    #: query rows the grid covers: N rounded up to whole clusters
    group: int   #: 64-row units of one w8a8 requant block (1 unless w8a8)


def fused_geometry(B: int, N: int, C: int, num_heads: int, block_q: int,
                   mode: str) -> FusedGeometry:
    """Where the fused kernel's CTAs go, or a ValueError for a shape it
    cannot take: head dim 32 or 64 and C a multiple of 64; in w8a8, C at
    most ``quant.EXACT_F32_K`` and the requant block ``legal_block(block_q,
    N, int8)`` (JAX's) a whole number of 64-row units inside one cluster of
    8, i.e. 64, 128, 256 or 512 rows. The rows cover N rounded up to
    clusters of 512 rows; the padded rows are computed (their x is 0) and
    count in their w8a8 block's amax, but are not written."""
    D = C // num_heads
    if D not in KERNEL_HEAD_DIMS or C % FUSED_ROWS:
        raise ValueError(f"the fused_trunk kernel takes head dim {KERNEL_HEAD_DIMS} "
                         f"and C a multiple of {FUSED_ROWS}, got D={D}, C={C}")
    group = 1
    rows = tiling.round_up(N, FUSED_ROWS * FUSED_CLUSTER)
    if mode == "w8a8":
        if C > quant.EXACT_F32_K:
            raise ValueError(f"the w8a8 kernel sums int8 products in f32: C must "
                             f"be <= {quant.EXACT_F32_K}")
        bq = tiling.legal_block(block_q, N, torch.int8)
        if bq % FUSED_ROWS or FUSED_CLUSTER % (bq // FUSED_ROWS):
            raise ValueError(f"the w8a8 kernel takes block_q of 64, 128, 256 or "
                             f"512 rows, got {bq}")
        group = bq // FUSED_ROWS
    return FusedGeometry(rows, group)


def _check_fused(x, w_qkv, s_qkv, w_proj, s_proj, num_heads, mode):
    if mode not in FUSED_MODES:
        raise ValueError(f"fused attention mode must be 'pallas' or 'w8a8', "
                         f"got {mode!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    if C % num_heads:
        raise ValueError(f"embed dim {C} must divide by heads {num_heads}")
    if w_qkv.dtype != torch.int8 or w_proj.dtype != torch.int8:
        raise ValueError("the fused trunk attention takes int8 weights")
    if w_qkv.shape != (3 * C, C) or w_proj.shape != (C, C):
        raise ValueError(f"w_qkv must be ({3 * C}, {C}) and w_proj ({C}, {C}), "
                         f"got {tuple(w_qkv.shape)}, {tuple(w_proj.shape)}")
    if s_qkv.shape != (3 * C,) or s_proj.shape != (C,):
        raise ValueError("s_qkv must be (3C,) and s_proj (C,)")


def fused_trunk_attention_reference(x, w_qkv, s_qkv, b_qkv, w_proj, s_proj,
                                    b_proj, *, num_heads: int, scale: float,
                                    block_q: int = 512, mode: str = "pallas",
                                    return_row_scale: bool = False):
    """The plain version of ``fused_trunk``: the unfused composition with
    the kernel's epilogues. qkv = (x @ w_qkvᵀ)·s + b in f32, rounded to x's
    dtype; per head softmax(q·kᵀ·scale)·v as :func:`flash_forward_reference`
    rounds it; context rounded to x's dtype; y = (ctx @ w_projᵀ)·s + b;
    returns x's dtype.

    ``w8a8``: x quantized per tensor over the whole ``(B, N, C)`` batch (so a
    row's output depends on its batchmates, as in JAX), int8×int8 qkv with
    the activation scale folded into ``s_qkv``; the context requantized per
    ``legal_block(block_q, N, int8)``-row block of the zero-padded sequence
    (the padded query rows, whose x is 0 and q the bias, count in the
    block's amax); int8×int8 proj scaled by ``block scale · s_proj``. Only
    ``block_q``, and only in w8a8, changes the value.

    ``return_row_scale=True`` returns ``(y, row_scale)``, the context
    requant scale of each row's block (``(B, N, 1)`` f32; None unless
    w8a8), for ``quant.requant_flip_bound``.
    """
    _check_fused(x, w_qkv, s_qkv, w_proj, s_proj, num_heads, mode)
    B, N, C = x.shape
    H, D = num_heads, C // num_heads
    cdt = x.dtype
    w_q, w_kv = w_qkv[:C], w_qkv[C:]
    b_q = b_kv = None
    if b_qkv is not None:
        b_q, b_kv = b_qkv.float()[:C], b_qkv.float()[C:]
    if mode == "w8a8":
        xi, xs = quant.quantize_act(x)
        s_eff = s_qkv.float() * xs
        bq = tiling.legal_block(block_q, N, torch.int8)
        Np = tiling.round_up(N, bq)
        xq = torch.nn.functional.pad(xi, (0, 0, 0, Np - N))
        q = quant._epilogue(quant.int8_matmul(xq, w_q), s_eff[:C], b_q)
        kv = quant._epilogue(quant.int8_matmul(xi, w_kv), s_eff[C:], b_kv)
    else:
        Np = N
        q = quant.dequant_mm_reference(x, w_q, s_qkv[:C], b_q)
        kv = quant.dequant_mm_reference(x, w_kv, s_qkv[C:], b_kv)
    q = q.to(cdt).reshape(B, Np, H, D)
    k, v = kv.to(cdt).reshape(B, N, 2, H, D).unbind(2)
    ctx = _softmax_pv(q, k, v, scale)[0].reshape(B, Np, C)
    if mode == "w8a8":
        blocks = ctx.float().reshape(B, Np // bq, bq, C)
        amax = blocks.abs().amax(dim=(2, 3), keepdim=True)
        cs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        codes = torch.clip(torch.round(blocks / cs), -127.0, 127.0).to(torch.int8)
        y = quant._epilogue(quant.int8_matmul(codes, w_proj), cs * s_proj.float(),
                            b_proj).reshape(B, Np, C)[:, :N]
        row_scale = cs.expand(-1, -1, bq, 1).reshape(B, Np, 1)[:, :N]
    else:
        y = quant.dequant_mm_reference(ctx, w_proj, s_proj, b_proj)
        row_scale = None
    return (y.to(cdt), row_scale) if return_row_scale else y.to(cdt)


def fused_trunk_attention(x, w_qkv, s_qkv, b_qkv, w_proj, s_proj, b_proj, *,
                          num_heads: int, scale: float, block_q: int = 512,
                          mode: str = "pallas") -> torch.Tensor:
    """Quantized trunk attention ``x → qkv → flash attention → proj`` in one
    kernel (JAX ``fused_trunk_attention``; inference only). x ``(B, N, C)``
    in the compute dtype; ``w_qkv`` ``(3C, C)`` and ``w_proj`` ``(C, C)``
    int8 codes in torch's ``(out, in)`` layout with f32 per-output scales;
    biases f32 or None. Returns ``(B, N, C)`` in x's dtype, with the proj
    scale and bias applied; the ``(B, N, 3C)`` projection and the context
    never reach device memory.

    On CUDA one launch of ``csrc/fused_trunk.cu`` (float32 on the CUDA
    cores, bfloat16 on the tensor cores; the shapes :func:`fused_geometry`
    takes, and in bfloat16 C up to 256 at head dim 64 (320 in w8a8) or 384
    at head dim 32, what its shared memory holds; w8a8 first quantizes x
    per tensor with one reduction, as JAX does). On the CPU
    :func:`fused_trunk_attention_reference`. A call that needs a gradient
    raises.
    """
    _check_fused(x, w_qkv, s_qkv, w_proj, s_proj, num_heads, mode)
    quant.refuse_grad("the fused trunk attention kernel", x, b_qkv, b_proj)
    if x.device.type == "cpu":
        with profiling.scope("flash_attention/fused_qkv"):
            return fused_trunk_attention_reference(
                x, w_qkv, s_qkv, b_qkv, w_proj, s_proj, b_proj, num_heads=num_heads,
                scale=scale, block_q=block_q, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk_attention runs on CUDA (kernel) or CPU "
                         f"(plain version), got device {x.device}")
    B, N, C = x.shape
    D = C // num_heads
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the fused_trunk kernel takes {list(KERNEL_DTYPES)}, "
                         f"got {x.dtype}")
    geom = fused_geometry(B, N, C, num_heads, block_q, mode)
    if mode == "w8a8":
        x_in, xs = quant.quantize_act(x)
        s_eff = (s_qkv.float() * xs).contiguous()
    else:
        x_in, s_eff = x, quant._f32_vec(s_qkv)
    # every tensor the kernel reads stays referenced until it is enqueued
    args = (x_in.contiguous(), w_qkv.contiguous(), s_eff, quant._f32_vec(b_qkv),
            w_proj.contiguous(), quant._f32_vec(s_proj), quant._f32_vec(b_proj))
    if x.dtype == torch.bfloat16:
        _check_rows_aligned("fused_trunk", x=args[0], w_qkv=args[1], w_proj=args[4])
    out = torch.empty((B, N, C), dtype=x.dtype, device=x.device)
    lib = _build.load_library("fused_trunk")
    with profiling.scope("flash_attention/fused_qkv"), torch.cuda.device(x.device):
        err = lib.fused_trunk(
            *(quant._ptr(t) for t in args), out.data_ptr(),
            B, N, num_heads, D, geom.rows, geom.group,
            KERNEL_DTYPES[x.dtype], quant.QUANT_MODES.index(mode), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_trunk launch failed: cudaError_t {err} "
                           f"(B={B}, N={N}, C={C}, H={num_heads}, {x.dtype}, {mode})")
    count_launch("fused_trunk")
    return out
