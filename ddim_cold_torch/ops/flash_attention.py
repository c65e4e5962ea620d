"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``ddim_cold_tpu/ops/flash_attention.py`` (forward only).
``softmax(q·kᵀ·scale)·v`` over ``(B, N, H, D)`` tensors without the N×N
logits ever reaching device memory: on a CUDA tensor :func:`flash_forward`
launches ``csrc/flash_fwd.cu`` (see its header for the design and what
bounds it); on a CPU tensor it computes :func:`flash_forward_reference`,
the same function written in plain PyTorch. There is no other route: a
CUDA call that cannot build or launch the kernel raises.

The TPU kernel's padding of D to 128 lanes and N to 8 rows, its
lane-replicated (m, l, lse) scratch, the Mosaic tile legalisation and the
dense fallback off-TPU have no counterpart here; the kernel masks the
ragged tail itself and reads q/k/v through their strides.
"""

from __future__ import annotations

import collections

import torch

from ddim_cold_torch.ops import _build

#: launches per kernel, counted where the kernel is launched and nowhere
#: else (the plain version does not count). Reset by assigning 0.
LAUNCHES: collections.Counter = collections.Counter()

KERNEL_HEAD_DIMS = (32, 64)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load_kernel():
    """Build (first time) and load the kernel library; raises without CUDA."""
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
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 2, 1, 3)  # (B, H, N, 1) → (B, N, H, 1)
    lse = (m + torch.log(l)).reshape(B * H, N)
    return o.to(q.dtype), lse


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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused non-causal attention forward, returning ``(o, lse)``.

    q/k/v: ``(B, N, H, D)``, any strides with a unit innermost stride (the
    model passes the three slices of its ``(B, N, 3, H, D)`` qkv projection
    without copying them). o: ``(B, N, H, D)`` contiguous in q's dtype, so
    ``o.reshape(B, N, H·D)`` is free; lse: ``(B·H, N)`` f32, the residual a
    backward pass needs. On CUDA the kernel takes D ∈ {32, 64} and float32
    or bfloat16, and anything else raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA (kernel) or CPU (plain "
                         f"version), got device {q.device}")
    B, N, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dim {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the flash kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit innermost (head-dim) stride")
    lib = load_kernel()
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, N, H, D,
                            KERNEL_DTYPES[q.dtype], *strides, float(scale),
                            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err} "
                           f"(B={B}, N={N}, H={H}, D={D}, {q.dtype})")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """:func:`flash_forward` without the lse: ``(B, N, H, D)`` in q's dtype."""
    return flash_forward(q, k, v, scale)[0]
