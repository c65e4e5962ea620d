"""Int8 weights for the trunk: the codec, the three matmul modes, the fused Mlp.

Counterpart of ``ddim_cold_tpu/ops/quant.py``. The four trunk linears of a
block (``attn.qkv``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``) hold
symmetric per-output-channel int8 codes and one f32 scale per output
channel; the patch projection, the embeddings, the LayerNorms and the head
stay in float.

**Layout.** The port keeps torch's ``(out, in)`` weight layout: ``w_int8``
is ``(out, in)`` int8 and ``scale`` is ``(out,)`` f32. The JAX package
keeps ``(in, out)``; a JAX code matrix is this one transposed.

* :func:`quantize_weight`, :func:`dequantize_weight`, :func:`quantize_act`:
  the codec, equal to JAX's bit for bit (``torch.round`` rounds half to
  even like ``jnp.round``; an all-zero channel gets scale 1.0; codes are
  clipped to [−127, 127]). The activation scale is per tensor, and a tensor
  split over ranks is still one tensor: inside :func:`act_scale_over` its
  ``max|x|`` is reduced over the ranks that hold the other parts, as JAX's
  ``jnp.max`` over a global array is.
* :func:`quantize_state_dict` (``quantize_params``), :func:`is_quantized`,
  :func:`param_bytes`, :func:`calibrate` over a model's state_dict.
* :func:`dequant_matmul`, ``x @ (w_int8·scale)ᵀ + bias`` with f32
  accumulation, in three modes: ``"xla"`` plain PyTorch; ``"pallas"`` the
  ``csrc/dequant_mm.cu`` kernel on CUDA (:func:`dequant_mm`), its plain
  version on the CPU; ``"w8a8"`` int8 activations too, an int8×int8 product
  that is exact as int32 arithmetic would be.
* :func:`mlp_fused`, ``fc1 → bias → GELU → fc2`` in one launch of
  ``csrc/mlp_fused.cu`` on CUDA, its plain version on the CPU; float, w8a16
  and w8a8 weights.
* :class:`QuantLinear`, the trunk linear over int8 codes.

Both kernels run their bfloat16 forms on the tensor cores (wgmma, through
``csrc/gemm_wgmma.cuh``) and their float32 forms with f32 FMAs on the CUDA
cores.

Each wrapper launches its kernel on a CUDA tensor and takes the plain
version only for a CPU tensor; a CUDA call that cannot launch raises. Each
launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ddim_cold_torch.ops import _build, tiling
from ddim_cold_torch.utils import profiling

#: the JAX package's quantization revision; the weight codec is unchanged
#: since its first revision
QUANT_REV = "w8a16-fused-v2"

#: the modes a model or a SamplerConfig may request
QUANT_MODES = ("xla", "pallas", "w8a8")

#: trunk linears whose weight is quantized, keyed by parent module name
#: (``proj`` alone is ambiguous: the patch embedding's is also ``proj``)
TRUNK_LINEARS = {"attn": ("qkv", "proj"), "mlp": ("fc1", "fc2")}

#: launches per kernel, counted where the kernel is launched and nowhere
#: else (the plain versions do not count). Reset by assigning 0.
LAUNCHES: collections.Counter = collections.Counter()  # guarded-by: _LAUNCH_LOCK
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to :data:`LAUNCHES`, under a lock:
    ``Counter[name] += 1`` is a read and a write, and several threads (the
    fleet's in-process replicas) launch at once."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1

#: the compute types the kernels take on CUDA, and their code in the C
#: interface
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: an f32 sum of int8·int8 products is exact while K·127² < 2²⁴
EXACT_F32_K = (1 << 24) // (127 * 127)


# ---------------------------------------------------------------- codec

def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 codes of an ``(out, in)`` weight:
    ``scale[o] = max_i |w[o, i]| / 127`` (1.0 for an all-zero row), codes
    ``round(w / scale)`` half to even, clipped to [−127, 127]."""
    w32 = weight.detach().float()
    amax = w32.abs().amax(dim=tuple(range(1, w32.dim())))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clip(torch.round(w32 / scale.reshape(-1, *[1] * (w32.dim() - 1))),
                       -127.0, 127.0)
    return codes.to(torch.int8), scale


def dequantize_weight(w_int8: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (w_int8.float() * scale[:, None]).to(dtype)


class _ActScope(threading.local):
    """The ranks that hold the rest of this thread's activations: process
    groups whose ranks hold equal blocks of a ``(B, …)`` activation's rows
    in rank order (``groups``), and the sequence block a ``(B, n, …)``
    activation's tokens are (``tokens``: a ``parallel.mesh.SeqShard``, or
    None). ``whole`` is set while a call already runs on whole tiles."""

    groups: tuple = ()
    tokens: Optional[object] = None
    whole: bool = False

    @property
    def n_valid(self) -> Optional[int]:
        """Leading token rows of dim 1 that are real (None: all of them)."""
        return None if self.tokens is None else self.tokens.n_real

    @property
    def split(self) -> bool:
        """True when this rank holds only a part of the activation."""
        return bool(self.groups) or self.tokens is not None


_ACT_SCOPE = _ActScope()


@contextlib.contextmanager
def act_scale_over(*groups, tokens=None):
    """Make every :func:`quantize_act` in this block (this thread) take the
    per-tensor scale of the whole tensor when its rows or tokens are split
    over ranks: ``max|x|`` is reduced with ``MAX`` over each process group
    of ``groups`` (None entries and groups already in force are skipped, so
    scopes nest; each splits dim 0 into equal blocks in rank order, a later
    one inside an earlier one's block) and over ``tokens``' group.
    ``tokens`` (a ``parallel.mesh.SeqShard``): dim 1 of a ``(B, n, …)``
    activation is this rank's sequence block, of which only the first
    ``n_real`` rows are real tokens (a block's padding is not part of the
    tensor). The samplers enter it with a mesh's ``data`` group and a
    sequence-parallel model with its shard. The fused w8a8 Mlp also runs
    over whole row tiles of the one-process call inside it
    (:func:`mlp_fused`)."""
    scope = _ACT_SCOPE
    saved = scope.groups, scope.tokens
    scope.groups = saved[0] + tuple(g for g in dict.fromkeys(groups)
                                    if g is not None and g not in saved[0])
    if tokens is not None:
        scope.tokens = tokens
    try:
        yield
    finally:
        scope.groups, scope.tokens = saved


def _scope_groups(scope: _ActScope) -> tuple:
    """Every group the scope's activation is split over."""
    tok = () if scope.tokens is None else (scope.tokens.group,)
    return scope.groups + tuple(g for g in tok if g not in scope.groups)


def act_amax(xf: torch.Tensor) -> torch.Tensor:
    """``max|x|`` of an f32 activation as a 0-d tensor: over its real tokens
    and across the ranks of :func:`act_scale_over` (0 for no element)."""
    scope = _ACT_SCOPE
    if scope.n_valid is not None and xf.dim() >= 3:
        xf = xf[:, :scope.n_valid]
    amax = xf.abs().amax() if xf.numel() else xf.new_zeros(())
    for group in _scope_groups(scope):
        amax = amax.reshape(1).clone()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        amax = amax.reshape(())
    return amax


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes of an activation: one scale
    ``max|x| / 127`` (1.0 for an all-zero tensor) as a 0-d f32 tensor,
    ``max|x|`` taken over the whole tensor (:func:`act_amax`)."""
    xf = x.float()
    amax = act_amax(xf)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clip(torch.round(xf / scale), -127.0, 127.0).to(torch.int8), scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ bᵀ`` of int8 codes as f32, equal to the int32 product converted
    to f32: an f32 sum is exact up to K = :data:`EXACT_F32_K`, a float64 one
    beyond."""
    wide = torch.float32 if a.shape[-1] <= EXACT_F32_K else torch.float64
    return F.linear(a.to(wide), b.to(wide)).float()


# ------------------------------------------------------------ state_dict

def is_trunk_weight(key: str) -> bool:
    """True for ``….<parent>.<name>.weight`` with a trunk (parent, name)."""
    parts = key.split(".")
    return (len(parts) >= 3 and parts[-1] == "weight"
            and parts[-2] in TRUNK_LINEARS.get(parts[-3], ()))


def quantize_state_dict(state: dict) -> dict:
    """The JAX ``quantize_params`` over a state_dict: every trunk linear's
    ``weight`` becomes ``w_int8`` + ``scale``; every other entry (biases,
    the patch projection, embeddings, norms, head) is passed through as the
    same tensor, not a copy."""
    out = {}
    for key, value in state.items():
        if is_trunk_weight(key):
            stem = key[:-len("weight")]
            out[stem + "w_int8"], out[stem + "scale"] = quantize_weight(value)
        else:
            out[key] = value
    return out


def is_quantized(state: dict) -> bool:
    return any(key.endswith(".w_int8") for key in state)


def param_bytes(state: dict) -> int:
    """Bytes of every tensor of a state_dict (an int8 trunk holds ≈4× fewer)."""
    return int(sum(t.numel() * t.element_size() for t in state.values()))


def calibrate(state: dict) -> dict:
    """Per trunk linear of a float state_dict: the largest absolute weight
    error of the codec, the largest error over its channel's scale (≤ 0.5 by
    construction), and the scale range. Keys are the module paths."""
    stats = {}
    for key, w in state.items():
        if not is_trunk_weight(key):
            continue
        w_int8, scale = quantize_weight(w)
        err = (w.float() - w_int8.float() * scale[:, None]).abs()
        stats[key[:-len(".weight")]] = {
            "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / scale[:, None]).max()),
            "scale_min": float(scale.min()),
            "scale_max": float(scale.max()),
            "shape": tuple(int(d) for d in w.shape),
        }
    return stats


# --------------------------------------------------- the dequant matmul

def _epilogue(acc: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``acc·scale + bias`` in f32, the bias added at the scale multiply."""
    if bias is None:
        return acc * scale
    return torch.addcmul(bias.float(), acc, scale)


def dequant_mm_reference(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``dequant_mm``: int8 codes widened exactly to
    x's values, products summed in f32, ``acc·scale + bias``; f32 out."""
    return _epilogue(F.linear(x.float(), w_int8.float()), scale.float(), bias)


def mm_error_limit(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                   y_ref: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |y_kernel − y_plain| for the dequant matmul.

    Both sides sum the same K products in f32 in another order: each sum is
    within K·2⁻²⁴ of Σ|x·w| of the exact one, so the two within
    K·2⁻²³·scale·(|x|·|w|ᵀ); the epilogue adds two f32 ulps of |y|. A bf16
    output rounds once on each side and may land one bf16 ulp (2⁻⁷·|y|)
    apart.
    """
    K = x.shape[-1]
    mag = F.linear(x.float().abs(), w_int8.float().abs()) * scale.float()
    limit = K * 2.0**-23 * mag + 2.0**-22 * y_ref.float().abs()
    if y_ref.dtype == torch.bfloat16:
        limit = limit + 2.0**-7 * y_ref.float().abs()
    return limit


def _check_weight(w_int8: torch.Tensor, scale: torch.Tensor, K: int) -> None:
    if w_int8.dtype != torch.int8:
        raise ValueError(f"w_int8 must be int8, got {w_int8.dtype}")
    if w_int8.dim() != 2 or w_int8.shape[1] != K:
        raise ValueError(f"w_int8 must be (out, {K}), got {tuple(w_int8.shape)}")
    if scale.shape != (w_int8.shape[0],):
        raise ValueError(f"scale must be ({w_int8.shape[0]},), got "
                         f"{tuple(scale.shape)}")


def _f32_vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_cuda(what: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA (kernel)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA (kernel) or CPU (plain version), "
                         f"got device {x.device}")
    return True


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def bf16_row_layout(K: int, row_stride: int, data_ptr: int) -> tuple[int, bool]:
    """How the bfloat16 ``dequant_mm`` kernel reads an ``(M, K)`` x: it
    copies x rows and code rows in 16-byte pieces (8 bf16, 16 codes), so it
    takes K a multiple of 16 and x rows on 16-byte boundaries. Returns
    ``(Kp, copy)``: K rounded up to 16, and whether x (row stride
    ``row_stride`` elements, base address ``data_ptr``) must first be
    copied into a zero-padded ``(M, Kp)`` buffer. The codes are padded to
    Kp too when ``Kp != K``; zeros change no sum."""
    Kp = tiling.round_up(K, 16)
    return Kp, Kp != K or row_stride % 8 != 0 or data_ptr % 16 != 0


def _zero_pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    out = t.new_zeros((t.shape[0], cols))
    out[:, :t.shape[1]] = t
    return out


def dequant_mm(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ (w_int8·scale)ᵀ + bias`` over a 2-D ``(M, K)`` x, f32
    accumulation, ``(M, out)`` in ``out_dtype``.

    On CUDA one launch of ``csrc/dequant_mm.cu``: x float32 (f32 FMAs) or
    bfloat16 (wgmma on the tensor cores) with a unit inner stride, and the
    kernel writes ``out_dtype`` (float32, or x's dtype, cast in-register
    from the f32 value: the same value as casting the f32 output). A
    bfloat16 x whose K is not a multiple of 16, or whose rows are not
    16-byte aligned, is copied once into a zero-padded K first, and the
    codes with it (:func:`bf16_row_layout`); the bfloat16 kernel holds a
    CTA's 128 x rows whole, so it takes K up to 448 for a float32 out and
    640 for bfloat16 (beyond, the launch fails and this raises). On the CPU
    the plain version :func:`dequant_mm_reference`, cast to ``out_dtype``.
    Forward only, as the TPU kernel: a call that needs a gradient raises.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    _check_weight(w_int8, scale, K)
    refuse_grad("the dequant matmul kernel", x, bias)
    if not _on_cuda("dequant_mm", x):
        with profiling.scope("dequant_matmul/pallas"):
            return dequant_mm_reference(x, w_int8, scale, bias).to(out_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the dequant_mm kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"out_dtype must be float32 or x's dtype, got {out_dtype}")
    if x.stride(1) != 1:
        x = x.contiguous()
    N = w_int8.shape[0]
    w = w_int8.contiguous()
    if x.dtype == torch.bfloat16:
        Kp, copy = bf16_row_layout(K, x.stride(0), x.data_ptr())
        if copy:
            x = _zero_pad_cols(x, Kp)
        if Kp != K:
            w, K = _zero_pad_cols(w, Kp), Kp
    s, b = _f32_vec(scale), _f32_vec(bias)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _build.load_library("dequant_mm")
    with profiling.scope("dequant_matmul/pallas"), torch.cuda.device(x.device):
        err = lib.dequant_mm(x.data_ptr(), w.data_ptr(), s.data_ptr(), _ptr(b),
                             out.data_ptr(), M, N, K, x.stride(0),
                             KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[out_dtype],
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"dequant_mm (M={M}, N={N}, K={K}, {x.dtype})")
    count_launch("dequant_mm")
    return out


def dequant_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None, mode: str = "xla",
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized linear over the last axis of ``x``: ``x @ (w_int8·scale)ᵀ
    [+ bias]`` with f32 accumulation and the bias added at the scale
    multiply, returned in ``out_dtype`` (f32 by default, as in JAX; the
    caller casts). ``mode``: ``"xla"`` plain PyTorch; ``"pallas"`` the
    dequant matmul kernel on CUDA (:func:`dequant_mm`); ``"w8a8"`` x
    quantized per tensor (:func:`quantize_act`) and an int8×int8 product."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of {QUANT_MODES}, got {mode!r}")
    _check_weight(w_int8, scale, x.shape[-1])
    if mode == "pallas":
        lead = x.shape[:-1]
        y = dequant_mm(x.reshape(-1, x.shape[-1]), w_int8, scale, bias, out_dtype)
        return y.reshape(*lead, w_int8.shape[0])
    if mode == "w8a8":
        xi, xs = quantize_act(x)
        y = _epilogue(int8_matmul(xi, w_int8), xs * scale.float(), bias)
    else:
        y = dequant_mm_reference(x, w_int8, scale, bias)
    return y.to(out_dtype)


class QuantLinear(nn.Module):
    """A trunk linear over int8 codes (JAX ``QuantDense``/``QuantParams``):
    buffers ``w_int8`` ``(out, in)`` int8 and ``scale`` ``(out,)`` f32, and
    a float ``bias`` parameter, under the same module path as the
    ``nn.Linear`` it replaces, so :func:`quantize_state_dict` loads into it.
    The forward runs :func:`dequant_matmul` in ``mode`` and returns x's
    dtype. The ``"pallas"`` kernel has no backward: a forward that needs a
    gradient through it raises."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mode: str = "xla"):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"quant mode must be one of {QUANT_MODES}, got {mode!r}")
        self.mode = mode
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.zeros((out_features, in_features),
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_linear(cls, linear: nn.Linear, mode: str) -> "QuantLinear":
        q = cls(linear.in_features, linear.out_features,
                linear.bias is not None, mode)
        q.w_int8, q.scale = quantize_weight(linear.weight)
        if linear.bias is not None:
            q.bias = nn.Parameter(linear.bias.detach().clone())
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dequant_matmul(x, self.w_int8, self.scale, bias=self.bias,
                              mode=self.mode, out_dtype=x.dtype)


def refuse_grad(what: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need a gradient through a forward-only
    kernel (the JAX kernels have no VJP either)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{what} is forward-only (inference): run it under "
                           "torch.no_grad() or torch.inference_mode()")


# ------------------------------------------------------------ fused Mlp

MLP_MODES = (None, "pallas", "w8a8")
#: rows of one CTA of the fused Mlp kernel, by compute dtype: 32 in the
#: float32 route, two warpgroups of 64 in the bfloat16 one
MLP_ROWS = {torch.float32: 32, torch.bfloat16: 128}
#: the w8a8 kernel takes a legalised ``block_m`` that is a multiple of this,
#: up to 8 times it
MLP_BLOCK_UNIT = 32


def w8a8_block_m(block_m: int, M: int) -> int:
    """The requant block of the w8a8 fused Mlp for a requested ``block_m``
    over M rows: JAX's ``legal_block(block_m, M, int8)``, or a ValueError
    where the kernel cannot take it (not a multiple of
    :data:`MLP_BLOCK_UNIT`, or more than 8 of them)."""
    bm = tiling.legal_block(block_m, M, torch.int8)
    if bm % MLP_BLOCK_UNIT or bm > 8 * MLP_BLOCK_UNIT:
        raise ValueError(f"the w8a8 kernel takes block_m a multiple of "
                         f"{MLP_BLOCK_UNIT} up to {8 * MLP_BLOCK_UNIT}, got {bm}")
    return bm


def mlp_geometry(M: int, block_m: int, cta_rows: int) -> tuple[int, int]:
    """Launch geometry of the w8a8 fused Mlp: ``(rows, cluster)``. The CTAs
    of one thread-block cluster cover ``lcm(block_m, cta_rows)`` rows, so
    that every requant tile of ``block_m`` rows lies inside one cluster;
    the grid covers M rounded up to whole clusters (rows past M's last tile
    form tiles of their own, whose outputs are not written)."""
    span = math.lcm(block_m, cta_rows)
    return tiling.round_up(M, span), span // cta_rows


def _gelu_rounded(y: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, exact-erf GELU in f32 on that value,
    round once more: the kernel's rounding points. f32 values of cdt."""
    return F.gelu(y.to(cdt).float(), approximate="none").to(cdt).float()


def _check_mlp(x, w1, b1, w2, b2, scale1, scale2, mode):
    if mode not in MLP_MODES:
        raise ValueError(f"mlp_fused mode must be None, 'pallas' or 'w8a8', "
                         f"got {mode!r}")
    K, Hf = x.shape[-1], w1.shape[0]
    if w1.dim() != 2 or w1.shape[1] != K or w2.dim() != 2 or w2.shape[1] != Hf:
        raise ValueError(f"w1 must be (hidden, {K}) and w2 (out, hidden), got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    if b1 is None:
        raise ValueError("fc1 needs its bias (the Mlp's fc1 always has one)")
    if mode is not None:
        if scale1 is None or scale2 is None:
            raise ValueError(f"mode={mode!r} needs scale1/scale2 (the per-column "
                             "weight scales)")
        if w1.dtype != torch.int8 or w2.dtype != torch.int8:
            raise ValueError(f"mode={mode!r} needs int8 weights")


def mlp_fused_reference(x, w1, b1, w2, b2=None, *, scale1=None, scale2=None,
                        mode: Optional[str] = None, block_m: int = 256,
                        return_row_scale: bool = False):
    """The plain version of ``mlp_fused``, rounding where the kernel (and
    JAX's ``_mlp_kernel``) rounds; returns x's dtype.

    fc1 in f32 (float weights cast to x's dtype first; int8 codes widened
    exactly), ``·scale1`` for int8 weights, ``+ b1``; round to x's dtype;
    exact GELU; fc2 the same way with ``scale2`` and ``b2``. ``w8a8``: x
    quantized per tensor over all M rows, int8×int8 fc1 with the activation
    scale folded into ``scale1``, and the hidden activation requantized per
    ``legal_block(block_m, M, int8)``-row tile of the zero-padded rows (a
    padded row's hidden value is ``gelu(b1)``, and it counts in its tile's
    amax), int8×int8 fc2 scaled by ``tile scale · scale2``.

    ``return_row_scale=True`` returns ``(y, row_scale)``, the hidden
    requant scale of each row's tile (``(..., 1)`` f32; None unless w8a8),
    for :func:`requant_flip_bound`.
    """
    _check_mlp(x, w1, b1, w2, b2, scale1, scale2, mode)
    if _whole_tiles_due(mode) and not return_row_scale:
        return _over_whole_tiles(lambda rows, bm: mlp_fused_reference(
            rows, w1, b1, w2, b2, scale1=scale1, scale2=scale2, mode=mode,
            block_m=bm), x, block_m)
    row_scale = None
    cdt = x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    b1f = b1.float()
    if mode == "w8a8":
        xi, xs = quantize_act(x)
        xi = xi.reshape(-1, K)
        bm = tiling.legal_block(block_m, M, torch.int8)
        Mp = tiling.round_up(M, bm)
        xi = F.pad(xi, (0, 0, 0, Mp - M))
        h = _gelu_rounded(_epilogue(int8_matmul(xi, w1), scale1.float() * xs, b1f), cdt)
        tiles = h.reshape(Mp // bm, bm, -1)
        amax = tiles.abs().amax(dim=(1, 2), keepdim=True)
        hs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        hi = torch.clip(torch.round(tiles / hs), -127.0, 127.0).to(torch.int8)
        acc = int8_matmul(hi, w2)                        # (tiles, bm, out)
        y = _epilogue(acc, hs * scale2.float(), b2).reshape(Mp, -1)[:M]
        row_scale = hs.expand(-1, bm, 1).reshape(Mp, 1)[:M].reshape(*lead, 1)
    elif mode == "pallas":
        h = _gelu_rounded(dequant_mm_reference(x2, w1, scale1, b1f), cdt)
        y = dequant_mm_reference(h, w2, scale2, b2)
    else:
        h = _gelu_rounded(F.linear(x2.float(), w1.to(cdt).float()) + b1f, cdt)
        y = F.linear(h, w2.to(cdt).float())
        if b2 is not None:
            y = y + b2.float()
    y = y.to(cdt).reshape(*lead, w2.shape[0])
    return (y, row_scale) if return_row_scale else y


def _gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _over_whole_tiles(run, x: torch.Tensor, block_m: int) -> torch.Tensor:
    """The w8a8 fused Mlp of this rank's part of an activation split over
    the ranks of :func:`act_scale_over`, as the one-process call computes
    it: that call requantizes the hidden activation per ``block_m``-row
    tile of the whole ``(B·N)``-row grid, so this rank gathers the whole
    activation (its real tokens, each row tagged with its owner), runs
    ``run(rows, block)`` on every whole tile its own rows touch (the last
    tile zero-padded, as the kernel pads it) and keeps its own rows'
    outputs. A rank runs at most 2·(block − 1) rows more than it holds for
    each contiguous run of its rows."""
    scope = _ACT_SCOPE
    K = x.shape[-1]
    rank = float(dist.get_rank())
    tagged = torch.cat([x, torch.full((*x.shape[:-1], 1), rank, dtype=x.dtype,
                                      device=x.device)], dim=-1)
    tok = scope.tokens
    if tok is not None:
        tagged = _gather_cat(tagged, tok.group, 1)[:, :tok.total]
    for group in reversed(scope.groups):
        tagged = _gather_cat(tagged, group, 0)
    whole = tagged.reshape(-1, K + 1)
    M = whole.shape[0]
    bm = tiling.legal_block(block_m, M, torch.int8)
    mine = (whole[:, K] == rank).nonzero()[:, 0]
    tiles = torch.unique(mine // bm)
    rows = (tiles[:, None] * bm + torch.arange(bm, device=x.device)).reshape(-1)
    sub = torch.zeros((rows.shape[0], K), dtype=x.dtype, device=x.device)
    live = rows < M
    sub[live] = whole[rows[live], :K]
    scope.whole = True
    try:
        y = run(sub, bm)
    finally:
        scope.whole = False
    # own rows in the whole grid's order are this block's in row-major order
    y = y[torch.searchsorted(tiles, mine // bm) * bm + mine % bm]
    if tok is not None:  # the block's padding tokens take zeros
        y = F.pad(y.reshape(x.shape[0], tok.n_real, -1),
                  (0, 0, 0, x.shape[1] - tok.n_real))
    return y.reshape(*x.shape[:-1], -1)


def _whole_tiles_due(mode: Optional[str]) -> bool:
    """True where a w8a8 fused Mlp must run over the one-process call's
    whole tiles (:func:`_over_whole_tiles`)."""
    return mode == "w8a8" and _ACT_SCOPE.split and not _ACT_SCOPE.whole


def requant_flip_bound(row_scale: torch.Tensor, w_codes: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """How far one flipped code moves an output of a w8a8 GEMM whose input
    rows were requantized with ``row_scale`` (``(..., 1)``): a code one step
    off changes ``y[..., n]`` by ``row_scale · w_scale[n] · |w_codes[n, k]|``,
    at most this, the largest ``k``."""
    return row_scale * (w_scale.float() * w_codes.abs().amax(dim=1).float())


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each element's magnitude: ``2^(e − 8)`` for
    ``|t| = m·2^e`` with m in [½, 1) (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def trunk_error_limit(y_ref: torch.Tensor, mode: Optional[str],
                      flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-wise bound on |y_kernel − y_plain| for the fused Mlp and the
    fused trunk attention (``mode``: None, "pallas" or "w8a8").

    float32 ``2⁻¹⁶·|y| + 2⁻¹³·mean|y|``: the same f32 operations summed in
    another order, through two GEMMs and a GELU (or a softmax), a few 2⁻²⁴
    of each term of a sum of random signs. bfloat16 ``ulp(y) +
    2⁻⁵·mean|y|``: each side rounds y once (one ulp apart at most), and the
    hidden activation (the attention's p and context) is rounded to bf16
    from f32 values that differ in their last bits, so a few elements land
    one bf16 ulp (2⁻⁸ relative) apart and move y by a few 2⁻⁸ of a y-sized
    sum, as in ``flash_attention.o_error_limit``.

    w8a8 adds ``2·flip``, two flipped codes per output
    (:func:`requant_flip_bound`): a requantized element that lands within
    the two sides' difference of a code boundary rounds to the neighbouring
    code, which moves every output of its row by one step times a weight.
    In f32 such flips are rare (a last-bit difference must straddle a
    boundary). In bf16 they are common: a one-ulp difference of a hidden
    value is up to half a code step, so about as many codes flip as values
    differ, each a step of up to ``2·amax/|value|`` ulps; the sum of their
    random signs widens the bf16 mean term to ``3·2⁻⁶·mean|y|``.
    """
    ref = y_ref.float().abs()
    if y_ref.dtype == torch.float32:
        limit = 2.0**-16 * ref + 2.0**-13 * ref.mean()
    else:
        mean_term = 3 * 2.0**-6 if mode == "w8a8" else 2.0**-5
        limit = bf16_ulp(ref) + mean_term * ref.mean()
    if mode == "w8a8":
        if flip is None:
            raise ValueError("the w8a8 limit needs the requant flip bound")
        limit = limit + 2.0 * flip
    return limit


def mlp_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: Optional[torch.Tensor] = None, *,
              scale1: Optional[torch.Tensor] = None,
              scale2: Optional[torch.Tensor] = None,
              mode: Optional[str] = None, block_m: int = 256) -> torch.Tensor:
    """The trunk Mlp ``fc1 → bias → exact GELU → fc2 → bias`` in one kernel
    (JAX ``mlp_pallas``); the ``(M, hidden)`` activation never reaches
    device memory. Weights ``(out, in)``: float (``mode=None``, cast to x's
    dtype) or int8 codes with f32 per-output scales (``"pallas"`` w8a16,
    ``"w8a8"``). Returns x's dtype.

    On CUDA one launch of ``csrc/mlp_fused.cu``: f32 FMAs for float32,
    wgmma on the tensor cores for bfloat16 (K and hidden multiples of 16;
    K + hidden up to 768 for float and w8a16 weights, whose shared memory
    holds a CTA's 128 rows of x and of the hidden activation). w8a8 first
    quantizes x per tensor with one reduction over the whole activation, as
    JAX does; the kernel then requantizes the hidden activation per
    ``block_m`` rows with a thread-block cluster (:func:`mlp_geometry`), so
    ``block_m`` must be a multiple of 32 of at most 256 after legalisation.
    On the CPU :func:`mlp_fused_reference`. Forward only: a call that needs
    a gradient raises.
    """
    _check_mlp(x, w1, b1, w2, b2, scale1, scale2, mode)
    refuse_grad("the fused Mlp kernel", x, w1, b1, w2, b2)
    if _whole_tiles_due(mode):
        return _over_whole_tiles(lambda rows, bm: mlp_fused(
            rows, w1, b1, w2, b2, scale1=scale1, scale2=scale2, mode=mode,
            block_m=bm), x, block_m)
    if not _on_cuda("mlp_fused", x):
        with profiling.scope("mlp/pallas"):
            return mlp_fused_reference(x, w1, b1, w2, b2, scale1=scale1,
                                       scale2=scale2, mode=mode, block_m=block_m)
    cdt = x.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the mlp_fused kernel takes float32 or bfloat16, got {cdt}")
    lead, K = x.shape[:-1], x.shape[-1]
    Hf, Nout = w1.shape[0], w2.shape[0]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if cdt == torch.bfloat16 and (K % 16 or Hf % 16):
        raise ValueError(f"the bfloat16 mlp_fused kernel takes K and hidden "
                         f"multiples of 16, got {K} and {Hf}")
    rows, cluster, bm = M, 1, 0
    if mode == "w8a8":
        if max(K, Hf) > EXACT_F32_K:
            raise ValueError(f"the w8a8 kernel sums int8 products in f32: K and "
                             f"hidden must be <= {EXACT_F32_K}")
        x2, xs = quantize_act(x)
        x2 = x2.reshape(-1, K)
        s1 = (scale1.float() * xs).contiguous()
        bm = w8a8_block_m(block_m, M)
        # the padded rows of M's last tile count in its amax
        rows, cluster = mlp_geometry(M, bm, MLP_ROWS[cdt])
    else:
        s1 = _f32_vec(scale1)
        if mode is None:
            w1, w2 = w1.to(cdt), w2.to(cdt)
    # every tensor the kernel reads stays referenced until it is enqueued
    args = (x2.contiguous(), w1.detach().contiguous(), s1, _f32_vec(b1),
            w2.detach().contiguous(), _f32_vec(scale2), _f32_vec(b2))
    out = torch.empty((M, Nout), dtype=cdt, device=x.device)
    lib = _build.load_library("mlp_fused")
    with profiling.scope("mlp/pallas"), torch.cuda.device(x.device):
        err = lib.mlp_fused(
            *(_ptr(t) for t in args), out.data_ptr(), M, rows, K, Hf, Nout, cluster,
            bm, KERNEL_DTYPES[cdt], MLP_MODES.index(mode),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"mlp_fused (M={M}, K={K}, hidden={Hf}, out={Nout}, "
                   f"{cdt}, mode={mode})")
    count_launch("mlp_fused")
    return out.reshape(*lead, Nout)

