"""DiffusionViT — the x̂0-predicting Vision Transformer.

Counterpart of ``ddim_cold_tpu/models/vit.py`` as ``nn.Module``s whose
state_dict keys are the reference torch model's (reference ViT.py:158-218),
so a reference ``.pkl`` and a JAX tree converted by
:func:`ddim_cold_torch.utils.weights.state_dict_from_flax` both load with
``strict=True``.

Kept from the JAX module: images NHWC in [−1, 1] in, x̂0 NHWC float32 out;
the qkv unpack order ``(B, N, 3, H, hd)``; ``scale = qk_scale or hd**-0.5``;
exact-erf GELU; LayerNorm eps 1e-5 with float32 statistics; the time and
positional embeddings added to every token, CLS included; the patch
embedding as a reshape plus one linear map in (row, col, channel) feature
order (the same map as the reference ``Conv2d``, whose weight it holds); the
reference's exact un-patchify pixel map. Parameters live in float32 and are
cast to ``dtype`` (float32 or bfloat16) at use, as the JAX modules do.

``use_flash=True`` routes attention through the hand-written flash kernels
(:mod:`ddim_cold_torch.ops.flash_attention`, forward and backward); ``False``
is the dense einsum path, kept as the kernels' oracle; ``"xla"`` is JAX's
blockwise online-softmax route (``flash_attention.blockwise_attention_xla``
over ``flash_blocks[1]`` keys a block, else 512), plain PyTorch that
launches no kernel. The JAX routing rule holds: the flash and blockwise
routes run only where no attention weights are needed, that is in
evaluation (``deterministic=True``) or with ``attn_drop_rate=0``, and not
on the probed layer; a training forward with attention dropout takes the
dense path and drops attention weights (JAX vit.py:231, :356, :377-381).

``quant`` (None, ``"xla"``, ``"pallas"``, ``"w8a8"``) holds the four trunk
linears of every block as int8 codes (:class:`~ddim_cold_torch.ops.quant.
QuantLinear`, the weights of the seeded float init quantized; a float
state_dict loads after :func:`~ddim_cold_torch.ops.quant.quantize_state_dict`).
``fused=True`` takes JAX's fused routes: the Mlp runs as one kernel
(``mlp_fused``) when ``quant != "xla"`` and its dropout is inactive, and
the attention runs as one qkv → flash → proj kernel (``fused_trunk``) when
``quant`` is ``"pallas"`` or ``"w8a8"`` and the flash rule above holds
(JAX vit.py:116-141, :241-265). The fused kernels are forward-only: a
forward that needs a gradient through them raises. ``flash_blocks``
``(block_q, block_kv)`` is accepted as in JAX: ``block_q`` sets, for
``quant="w8a8", fused=True``, the rows over which the attention context is
requantized, and ``block_kv`` the blockwise route's key block. Without
them the fused attention's ``block_q`` and the fused Mlp's ``block_m`` come
from :mod:`ddim_cold_torch.ops.tuning` for the geometry and the kind of the
device x is on (its table, else JAX's 512 and 256), as JAX's model reads
its tuning table. Every other block size of the JAX package changes only
the f32 summation order, and the CUDA kernels run their own tiles.

``deterministic=False`` is the training forward. It takes an explicit
``torch.Generator`` on the model's device and applies, as flax's
``nn.Dropout`` does (Bernoulli(keep) mask, survivors scaled by 1/keep, rate
0 the identity): ``pos_drop`` on the embedded tokens, attention-weight
dropout (dense path only), the proj dropout and both MLP dropouts, all at
their rates; and per-sample stochastic depth on both residual branches of
every block, a (B, 1, 1) mask at the rates ``linspace(0, drop_path_rate,
depth)``. The bits differ from JAX's: the distributions are the same.

``remat=True`` runs each block under ``torch.utils.checkpoint`` (JAX's
``nn.remat(Block)``, vit.py:891): a block keeps only its input for the
backward and runs its forward again there, so one block's activations are
live at a time (on the flash route the forward kernel launches twice per
block and step). The recomputation draws the block's dropout masks again
from a generator set to the state the first forward started from, and the
caller's generator stays where the first forward left it, so a remat step
is bit for bit the plain one: losses, gradients and the generator.

Sequence parallelism (``seq_mesh`` + ``seq_axis``, a ``DeviceMesh`` of
:mod:`ddim_cold_torch.parallel`; :func:`sp_clone` builds it): the N+1
tokens are split into equal blocks over the ``seq`` group (the last padded),
and each rank holds its block through the whole trunk: the patch embedding,
the class token and the positional rows of its token indices, LayerNorm,
Mlp and head run on its tokens only, and attention alone exchanges
activations, as ``sp_mode`` says: ``"ring"`` (K/V rotation,
:mod:`~ddim_cold_torch.parallel.ring_attention`) or ``"ulysses"`` (two
all-to-alls around the flash kernels, the blockwise route or the dense
einsum by ``use_flash``, :mod:`~ddim_cold_torch.parallel.ulysses`). The head's
outputs are gathered, so every rank of the group returns the whole image.
The JAX rules hold: attention dropout in a training forward raises (the
sequence-parallel routes never hold the weights), and the fused attention
is never taken (JAX vit.py:240-243): a ``quant`` model runs its qkv and
proj as int8 linears around the sequence-parallel attention, and with
``fused`` its Mlp still runs as one kernel, per token. A w8a8 model's
per-tensor activation scale is the whole sequence's: ``max|x|`` is taken
over the block's real tokens and reduced over the group
(``quant.act_scale_over``). Per-token dropout masks are drawn for all N+1
tokens and sliced, and stochastic depth draws one bit a sample, so every
rank of a group, sharing one generator stream, drops what a one-process
forward from that stream drops. ``batch_axis`` is checked and recorded:
each process already holds its own rows. The token cache runs under it
(one global selection of the live tokens, the trunk at their k positions
split over the group), and so does the probe (JAX's dense global weights,
on every rank): see :meth:`DiffusionViT.forward`.

Tensor parallelism (``head_axis``, an axis of ``seq_mesh``; Megatron's
column → row pairs, :mod:`ddim_cold_torch.parallel.sharding`): every rank
draws the whole seeded init and keeps its shard. ``qkv`` holds the q, k
and v columns of its H/m heads and attention runs over them alone (the
flash kernels on ``(B, N, H/m, hd)``; under sequence parallelism Ulysses
splits those heads over ``seq`` and the ring rotates their K/V, with no
qkv all-gather); ``fc1`` holds its hidden units; each input enters through
Megatron's *f* (identity forward, gradient summed over the group), and
``proj``/``fc2`` sum their partial products over the group in float32 and
add their bias once, after the sum. Dropout masks on a shard (the hidden
units, the heads' weights) are drawn whole and sliced, so every rank draws
what one process draws. ``quant`` and ``fused`` under it raise (ROADMAP.md
Queue 1 item 14). ``scan_blocks`` (JAX's stacked layout) keeps the
``blocks.{i}`` modules (the weight bridge unstacks JAX's tree) and takes
JAX's refusals: ``quant``, the step and token caches and the probe.
``pipe_axis`` (needs ``scan_blocks``) keeps this rank's pipeline stage of
depth/p consecutive blocks only; its trunk runs through
``parallel.pipeline.make_pipelined_apply``, over the ``stage="embed"`` and
``stage="head"`` (with ``tokens``) forward hooks. :attr:`plan` is the
layout of every key of the whole state_dict.

The forward records autograd history like any module; the samplers and the
serving engine run it under ``torch.inference_mode()``. The step-cache
hooks of the JAX forward (``capture_split``, ``skip_blocks`` +
``block_delta``, ``capture_tokens``, ``token_cache`` + ``token_k``) are
ported on every route above, and so is the attention probe
(``return_attention_layer``); see :meth:`DiffusionViT.forward`.

Switch-MoE (``num_experts`` > 1, ``moe_capacity_factor``, ``moe_dispatch``:
:mod:`ddim_cold_torch.models.moe`): each block's Mlp is a top-1 routed
expert bank (``blocks.{i}.moe``), in both block layouts, under ``remat``,
the step-cache hooks (the token cache routes its k live tokens, with
capacity from k) and sequence parallelism; ``fused`` launches no Mlp
kernel there (the bank replaces the Mlp) and ``quant`` raises JAX's
ValueError. ``forward(..., losses=[])`` appends every bank call's routing
statistics, the load-balance term's inputs. ``expert_axis`` (an axis of
``seq_mesh``) keeps this rank's E/ep experts of every bank.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ddim_cold_torch.models.init import torch_default_uniform_, trunc_normal_
from ddim_cold_torch.ops import quant as quant_ops
from ddim_cold_torch.ops import tuning
from ddim_cold_torch.ops.flash_attention import (DEFAULT_BLOCK_KV,
                                                 blockwise_attention_xla,
                                                 flash_attention_qkv,
                                                 fused_trunk_attention)
from ddim_cold_torch.parallel import mesh as pmesh
from ddim_cold_torch.parallel import sharding
from ddim_cold_torch.parallel.ring_attention import ring_attention
from ddim_cold_torch.parallel.ulysses import (check_head_axis, heads_error,
                                              ulysses_attention_qkv)
from ddim_cold_torch.utils.platform import resolve_device

#: Model configurations appearing in the reference (same table as the JAX
#: package's MODEL_CONFIGS).
MODEL_CONFIGS = {
    # reference ViT.py:277
    "oxford_flower_64": dict(
        img_size=(64, 64), patch_size=4, embed_dim=256, depth=6, num_heads=4
    ),
    # reference ViT.py:274 / 20220822.yaml:12-15 / ViT_draft2drawing.py:342
    "vit_tiny": dict(
        img_size=(64, 64), patch_size=8, embed_dim=384, depth=7, num_heads=12
    ),
    # checkpoint name only (README.md:28-29); both plausible patch sizes
    "oxford_flower_200_p4": dict(
        img_size=(200, 200), patch_size=4, embed_dim=256, depth=6, num_heads=4
    ),
    "oxford_flower_200_p8": dict(
        img_size=(200, 200), patch_size=8, embed_dim=384, depth=7, num_heads=12
    ),
}

class TensorShard(NamedTuple):
    """This rank's place on a tensor-parallel axis: its ``group``, the axis
    ``size`` and this rank's ``index`` along it."""

    group: object
    size: int
    index: int


def positionalencoding1d(d_model: int, length: int) -> np.ndarray:
    """Sinusoidal 1-D positional encoding (reference ViT_draft2drawing.py:140-156)."""
    if d_model % 2 != 0:
        raise ValueError(f"Cannot use sin/cos positional encoding with odd dim {d_model}")
    pe = np.zeros((length, d_model), dtype=np.float32)
    position = np.arange(0, length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def _linear(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """``lin`` in x's dtype: the float32 weight is cast at use (flax Dense);
    a :class:`QuantLinear` computes in its own mode and returns x's dtype."""
    if isinstance(lin, quant_ops.QuantLinear):
        return lin(x)
    bias = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             shape=None, shard: Optional[pmesh.SeqShard] = None,
             part: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: identity without a generator (deterministic) or at
    rate 0; else a Bernoulli(1 − rate) mask of ``shape`` (default x's; a
    broadcastable shape gives stochastic depth) with survivors scaled by
    1/(1 − rate) in x's dtype. ``shard``: x is a token block; ``part=(dim,
    tp)``: x is this rank's ``tp.index``-th of ``tp.size`` equal parts of
    ``dim`` (heads or hidden units). The mask is drawn for the whole tensor
    and this rank's part taken, so every rank draws what one process
    draws."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if shape is None and (shard is not None or part is not None):
        full = list(x.shape)
        if shard is not None:
            full[1] = shard.total
        if part is not None:
            full[part[0]] *= part[1].size
        mask = torch.rand(full, generator=generator, device=x.device) < keep
        if shard is not None:
            mask = shard.take(mask, True)
        if part is not None:
            dim, tp = part
            n = x.shape[dim]
            mask = mask.narrow(dim, tp.index * n, n)
    else:
        mask = torch.rand(x.shape if shape is None else shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _row_parallel(x: torch.Tensor, lin: nn.Linear, tp: TensorShard) -> torch.Tensor:
    """A row-parallel linear (``proj``, ``fc2``): this rank's partial product
    in float32 (bfloat16 operands are exact in it), summed over the ``model``
    group in float32, the bias added once after the sum, then x's dtype."""
    part = F.linear(x.float(), lin.weight.to(x.dtype).float())
    out = pmesh.reduce_from_group(part, tp.group)
    if lin.bias is not None:
        out = out + lin.bias.to(x.dtype).float()
    return out.to(x.dtype)


def _shrink(lin: nn.Linear, key: str, tp: TensorShard) -> nn.Linear:
    """``lin`` (``attn.qkv``, ``attn.proj``, ``mlp.fc1`` or ``mlp.fc2``, as
    ``key`` names it) cut to this rank's shard along the tensor-parallel
    axis, per the Megatron plan (:mod:`~ddim_cold_torch.parallel.sharding`)."""
    out = nn.Linear(1, 1, bias=lin.bias is not None, device="meta")  # draws nothing
    for name in ("weight", "bias"):
        t = getattr(lin, name)
        if t is None:
            continue
        full = f"blocks.0.{key}.{name}"
        plan = sharding.plan_for({full: t.shape}, "model")[full]
        t = t.detach()
        if plan.sharded:
            t = sharding.take_part(t, plan.dims.index("model"), tp.index, tp.size,
                                   plan.groups)
        setattr(out, name, nn.Parameter(t.clone()))
    out.out_features, out.in_features = out.weight.shape
    return out


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics and affine, cast back to x's dtype
    (flax LayerNorm with a reduced compute dtype)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _token_scores(tokens: torch.Tensor, ref_in: torch.Tensor,
                  has_cls: bool = True) -> torch.Tensor:
    """Each token's squared change against ``ref_in``, summed in float32
    (the difference taken in the model dtype, as JAX does); with
    ``has_cls`` the first token (CLS) scores the float32 maximum."""
    scores = (tokens - ref_in).float().square().sum(-1)
    if has_cls:
        scores[:, 0] = torch.finfo(torch.float32).max
    return scores


def _top_positions(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The (B, k) positions of the k largest scores of each row, in position
    order; ties taken lower index first as ``jax.lax.top_k`` takes them (a
    stable descending sort)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :k].sort(dim=-1).values


def _live_tokens(tokens: torch.Tensor, ref_in: torch.Tensor, k: int) -> torch.Tensor:
    """The (B, k) indices of the k tokens of each row that changed most
    against ``ref_in``, in position order (:func:`_token_scores`, CLS forced
    live; :func:`_top_positions`)."""
    return _top_positions(_token_scores(tokens, ref_in), k)


def _live_tokens_sp(tokens: torch.Tensor, ref_in: torch.Tensor, k: int,
                    shard: pmesh.SeqShard) -> torch.Tensor:
    """:func:`_live_tokens` of a sequence split by ``shard``, from this rank's
    blocks of the stream and the reference: each rank scores its own tokens
    with the one-process arithmetic (CLS forced live on the rank that holds
    position 0), the (B, n_local) scores are gathered over the group and
    the block padding (positions ≥ ``total``) cut off, so a padding row is
    never live, and the one global selection runs on every rank: the same
    (B, k) global positions everywhere, those of one process given the
    same stream and reference."""
    scores = _token_scores(tokens, ref_in, has_cls=shard.lo == 0)
    return _top_positions(shard.gather(scores), k)


def _remat_block(blk: nn.Module, x: torch.Tensor, generator: Optional[torch.Generator],
                 losses: Optional[list] = None, shard=None) -> torch.Tensor:
    """``blk(x, generator)`` under ``torch.utils.checkpoint`` (non-reentrant),
    with the block's dropout masks replayed exactly in the recomputation.
    ``preserve_rng_state`` covers only the global RNGs, and the port draws
    from an explicit generator, so: the first forward draws from the
    caller's generator (leaving it where the plain block would), and the
    recomputation runs with a fresh generator on the same device set to the
    state that forward started from. An expert bank's routing statistics
    reach ``losses`` from the first forward; the recomputation computes
    them again (the same operations) into a list of its own."""
    snapshot = None if generator is None else generator.get_state()
    replay = False

    def run(inp):
        gen = generator
        if replay and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(snapshot)
        sink = losses if losses is None or not replay else []
        return blk(inp, gen, losses=sink, shard=shard)

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    replay = True  # read by the recomputation, during the backward
    return out


class PatchEmbed(nn.Module):
    """Image → patch tokens as one GEMM over (row, col, channel) patch
    features. Holds the reference ``Conv2d``'s weight (E, C, p, p) — for
    kernel = stride = p the convolution is exactly this linear map."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(self.patchify(x))

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, N, p²C) patch features, (row, col, channel)."""
        B, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))


class Mlp(nn.Module):
    """2-layer exact-erf GELU MLP with dropout after each layer (reference
    ViT.py:74-90). ``quant``/``fused`` route it as the JAX module does: one
    ``mlp_fused`` kernel when ``fused and quant != "xla"`` and the dropout
    is inactive, else the two linears (int8 :class:`QuantLinear`s when
    ``quant`` is set, swapped in by :class:`DiffusionViT`). Tensor-parallel
    (:meth:`shard_hidden`): ``fc1`` holds its column shard of the hidden
    units, ``fc2`` its row shard; the input enters through Megatron's *f*
    and ``fc2``'s partial products are summed over the group (*g*)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, quant: Optional[str] = None, fused: bool = False,
                 shard: Optional[pmesh.SeqShard] = None):
        super().__init__()
        self.drop = drop
        self.quant = quant
        self.fused = fused
        self.shard = shard
        self.tp: Optional[TensorShard] = None
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def shard_hidden(self, tp: TensorShard) -> None:
        """Keep this rank's hidden units only (``fc1`` columns, ``fc2``
        rows)."""
        self.fc1, self.fc2 = _shrink(self.fc1, "mlp.fc1", tp), _shrink(self.fc2, "mlp.fc2", tp)
        self.tp = tp

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                shard: Optional[pmesh.SeqShard] = None) -> torch.Tensor:
        """``shard``: the token block x is, when it is not the model's (a
        token-cache reuse step's subset)."""
        tp = self.tp
        shard = self.shard if shard is None else shard
        if tp is not None:
            x = pmesh.copy_to_group(x, tp.group)
            h = F.gelu(_linear(x, self.fc1), approximate="none")
            h = _dropout(h, self.drop, generator, shard=shard, part=(2, tp))
            return _dropout(_row_parallel(h, self.fc2, tp), self.drop, generator,
                            shard=shard)
        if self.fused and self.quant != "xla" and (generator is None or self.drop == 0.0):
            fc1, fc2 = self.fc1, self.fc2
            # the tuned block of this geometry on x's device, else JAX's 256
            # (JAX vit.py:137-138)
            block_m = tuning.mlp_block_m(
                x.shape[-1], fc1.out_features,
                torch.int8 if self.quant == "w8a8" else x.dtype,
                quant=self.quant is not None, device=x.device)
            if self.quant:
                return quant_ops.mlp_fused(
                    x, fc1.w_int8, fc1.bias, fc2.w_int8, fc2.bias, scale1=fc1.scale,
                    scale2=fc2.scale, mode=self.quant, block_m=block_m)
            return quant_ops.mlp_fused(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                                       block_m=block_m)
        x = _dropout(F.gelu(_linear(x, self.fc1), approximate="none"), self.drop,
                     generator, shard=shard)
        return _dropout(_linear(x, self.fc2), self.drop, generator, shard=shard)


class Attention(nn.Module):
    """Multi-head self-attention with fused qkv (reference ViT.py:93-117).
    Tensor-parallel (:meth:`shard_heads`): ``qkv`` holds the q, k and v
    columns of this rank's heads, attention runs over them alone (the
    flash kernels on ``(B, N, H/m, hd)``), and ``proj`` holds its row shard,
    summed over the group with its bias added once after the sum."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_flash: bool = False,
                 quant: Optional[str] = None, fused: bool = False,
                 block_q: Optional[int] = None, block_kv: int = DEFAULT_BLOCK_KV,
                 shard: Optional[pmesh.SeqShard] = None):
        super().__init__()
        self.quant = quant
        self.fused = fused
        self.shard = shard
        self.tp: Optional[TensorShard] = None
        self.block_q = block_q
        self.block_kv = block_kv
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qk_scale = qk_scale
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    @property
    def local_heads(self) -> int:
        """The heads this rank attends over."""
        return self.num_heads // (self.tp.size if self.tp is not None else 1)

    def shard_heads(self, tp: TensorShard) -> None:
        """Keep this rank's heads only (``qkv`` columns, ``proj`` rows)."""
        self.qkv, self.proj = _shrink(self.qkv, "attn.qkv", tp), _shrink(self.proj,
                                                                        "attn.proj", tp)
        self.tp = tp

    def _out(self, out: torch.Tensor, generator, shard=None) -> torch.Tensor:
        """The context ``(B, n, heads·hd)`` through ``proj`` and its dropout."""
        if self.tp is not None:
            out = _row_parallel(out, self.proj, self.tp)
        else:
            out = _linear(out, self.proj)
        return _dropout(out, self.proj_drop, generator, shard=shard)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                need_weights: bool = False,
                shard: Optional[pmesh.SeqShard] = None) -> torch.Tensor:
        """The attention output; with ``need_weights`` the (B, H, N, N)
        attention weights instead (dense path, after attention dropout, as
        JAX's probe returns them; under sequence parallelism the whole
        sequence's, on every rank). ``shard``: the token block x is, when it
        is not the model's (a token-cache reuse step's subset)."""
        B, N, C = x.shape
        shard = self.shard if shard is None else shard
        scale = self.qk_scale or self.head_dim**-0.5
        # the flash, blockwise and fused routes never materialise the
        # weights: they need attention dropout inactive and no probe (JAX's
        # weightless_ok, vit.py:231)
        weightless = not need_weights and (generator is None or self.attn_drop == 0.0)
        if self.tp is not None:
            x = pmesh.copy_to_group(x, self.tp.group)
        if shard is not None:
            return self._seq_parallel(x, generator, need_weights, weightless, scale,
                                      shard)
        if self.fused and self.quant in ("pallas", "w8a8") and weightless:
            # one kernel: the qkv projection and the context never reach
            # device memory (JAX vit.py:241-265); forward-only
            qkv, proj = self.qkv, self.proj
            # explicit flash_blocks win, else the tuned block of this
            # geometry on x's device (JAX vit.py:255-257)
            block_q = self.block_q or tuning.attn_blocks(
                N, C, self.num_heads, torch.int8 if self.quant == "w8a8" else x.dtype,
                device=x.device)[0]
            out = fused_trunk_attention(
                x, qkv.w_int8, qkv.scale, qkv.bias, proj.w_int8, proj.scale,
                proj.bias, num_heads=self.num_heads, scale=scale,
                block_q=block_q, mode=self.quant)
            return _dropout(out, self.proj_drop, generator)
        # (B, N, 3, H, hd) unpack order, as the reference reshape; the flash
        # kernels read q, k, v as strided slices of the projection and write
        # its gradient as one buffer (a rank's column shard of qkv is this
        # layout over its own heads)
        heads = self.local_heads
        qkv = _linear(x, self.qkv).reshape(B, N, 3, heads, self.head_dim)
        if self.use_flash == "xla" and weightless:
            out = blockwise_attention_xla(*qkv.unbind(2), scale, self.block_kv)
        elif self.use_flash and weightless:
            out = flash_attention_qkv(qkv, scale)
        else:
            q, k, v = qkv.unbind(2)
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
            attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            attn = _dropout(attn, self.attn_drop, generator,
                            part=None if self.tp is None else (1, self.tp))
            if need_weights:
                # every head's weights, on every rank of the group
                return attn if self.tp is None else pmesh.gather_cat(
                    attn, self.tp.group, dim=1)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self._out(out.reshape(B, N, heads * self.head_dim), generator)

    def _seq_parallel(self, x, generator, need_weights, weightless, scale, shard):
        """Attention of this rank's token block over the seq group (JAX
        vit.py:286-296, :333-355): ring or Ulysses by the shard's mode, over
        this rank's heads (``head_axis``: no qkv all-gather). The probe
        (``need_weights``) takes JAX's dense global einsum instead
        (vit.py:288-293): q and k gathered over the group (and the heads
        over ``head_axis``), every rank computes the whole (B, H, N, N)
        weights, as one process does."""
        if need_weights:
            return self._global_weights(x, generator, scale, shard)
        if not weightless:
            # a dense fallback would hold the full N×N weights on every rank,
            # the thing sequence parallelism exists to avoid
            raise ValueError(
                "sequence-parallel attention cannot apply attention-dropout "
                f"(attn_drop={self.attn_drop} active in training); set "
                "attn_drop_rate=0.0 on the model")
        B, n, _ = x.shape
        heads = self.local_heads
        qkv = _linear(x, self.qkv).reshape(B, n, 3, heads, self.head_dim)
        if shard.mode == "ulysses":
            out = ulysses_attention_qkv(qkv, group=shard.group, n_valid=shard.total,
                                        scale=scale, use_flash=self.use_flash,
                                        block_kv=self.block_kv)
        else:
            out = ring_attention(*qkv.unbind(2), shard.valid(B, x.device),
                                 group=shard.group, scale=scale)
        return self._out(out.reshape(B, n, heads * self.head_dim), generator, shard)

    def _global_weights(self, x, generator, scale, shard):
        """The probe's weights of the whole sequence from this rank's token
        block: the q and k blocks joined over the seq group (padding cut
        off) and, under tensor parallelism, every rank's heads; then the
        one-process dense softmax and attention dropout (the mask drawn
        whole, so every rank of a generator stream draws one process's)."""
        B, n, _ = x.shape
        qkv = _linear(x, self.qkv).reshape(B, n, 3, self.local_heads, self.head_dim)
        q, k = shard.gather(qkv[:, :, 0]), shard.gather(qkv[:, :, 1])
        if self.tp is not None:
            q, k = (pmesh.gather_cat(a, self.tp.group, dim=2) for a in (q, k))
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return _dropout(attn, self.attn_drop, generator)


class Block(nn.Module):
    """Pre-LN transformer block with stochastic-depth residuals (reference
    ViT.py:120-138). ``num_experts`` > 1 puts a Switch-MoE expert bank
    (``moe``, :class:`~ddim_cold_torch.models.moe.SwitchMlp`) where the
    dense ``mlp`` would be (JAX vit.py:471-494)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, use_flash: bool = False,
                 quant: Optional[str] = None, fused: bool = False,
                 block_q: Optional[int] = None, block_kv: int = DEFAULT_BLOCK_KV,
                 shard: Optional[pmesh.SeqShard] = None, num_experts: int = 1,
                 moe_capacity_factor: float = 1.25, moe_dispatch: str = "einsum"):
        super().__init__()
        if quant and num_experts > 1:
            raise ValueError(
                "quant covers the dense trunk only — the Switch-MoE expert "
                "banks have no quantized path (set num_experts=1)")
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, attn_drop=attn_drop,
                              proj_drop=drop, use_flash=use_flash, quant=quant,
                              fused=fused, block_q=block_q, block_kv=block_kv,
                              shard=shard)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        if num_experts > 1:
            from ddim_cold_torch.models.moe import SwitchMlp

            self.moe = SwitchMlp(dim, num_experts, int(dim * mlp_ratio), dim,
                                 capacity_factor=moe_capacity_factor, drop=drop,
                                 dispatch=moe_dispatch, shard=shard)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, quant=quant,
                           fused=fused, shard=shard)

    def _residual(self, y: torch.Tensor, generator) -> torch.Tensor:
        """Per-sample stochastic depth (reference ViT.py:52-71): one
        Bernoulli(keep) draw per sample, broadcast over tokens and channels."""
        return _dropout(y, self.drop_path, generator, shape=(y.shape[0], 1, 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_attention: bool = False,
                losses: Optional[list] = None,
                shard: Optional[pmesh.SeqShard] = None) -> torch.Tensor:
        """The block's output; with ``return_attention`` its attention
        weights (B, H, N, N) instead (reference Block.return_attention,
        ViT.py:132-135). ``losses``: an expert bank appends its routing
        statistics there. ``shard``: the token block x is under sequence
        parallelism, when it is not the model's (a token-cache reuse step
        runs its k live tokens as blocks of k positions)."""
        if return_attention:
            return self.attn(_layer_norm(x, self.norm1), generator, need_weights=True)
        x = x + self._residual(self.attn(_layer_norm(x, self.norm1), generator,
                                         shard=shard), generator)
        h = _layer_norm(x, self.norm2)
        y = (self.moe(h, generator, losses, shard=shard) if hasattr(self, "moe")
             else self.mlp(h, generator, shard=shard))
        return x + self._residual(y, generator)


class DiffusionViT(nn.Module):
    """The diffusion backbone ``(x_t, t) → x̂0`` (reference ViT.py:158-218).

    ``x``: (B, H, W, C) in [−1, 1]; ``t``: (B,) integer steps in
    [0, total_steps) (out of range raises, as torch indexing does). Returns
    (B, H, W, C) float32. Constructor defaults mirror the reference ctor:
    mlp_ratio=1.0, qkv_bias=True, all drop rates 0.1, total_steps=2000; the
    drop rates act only in the training forward (``deterministic=False``).

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU with the reference initializers (the trunk linears then quantized
    when ``quant`` is set), then moved to ``device`` (None means ``"cuda"``;
    missing CUDA raises). :meth:`clone` builds the same configuration with
    some options changed (JAX ``model.clone``).
    """

    def __init__(self, img_size: Sequence[int] = (64, 64), patch_size: int = 8,
                 in_chans: int = 3, embed_dim: int = 256, depth: int = 3,
                 num_heads: int = 4, mlp_ratio: float = 1.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.1, attn_drop_rate: float = 0.1,
                 drop_path_rate: float = 0.1, total_steps: int = 2000,
                 dtype: torch.dtype = torch.float32,
                 use_sincos_pos: bool = False, use_flash: bool = False,
                 quant: Optional[str] = None, fused: bool = False,
                 flash_blocks: Optional[tuple] = None, remat: bool = False,
                 seq_mesh=None, seq_axis: Optional[str] = None,
                 batch_axis: Optional[str] = None, sp_mode: str = "ring",
                 head_axis: Optional[str] = None, scan_blocks: bool = False,
                 pipe_axis: Optional[str] = None, num_experts: int = 1,
                 moe_capacity_factor: float = 1.25, moe_dispatch: str = "einsum",
                 expert_axis: Optional[str] = None, *, device=None, seed: int = 0):
        ctor = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        if quant is not None and quant not in quant_ops.QUANT_MODES:
            raise ValueError(f"quant must be None or one of "
                             f"{quant_ops.QUANT_MODES}, got {quant!r}")
        if fused and quant == "xla":
            raise ValueError(
                "fused=True requests the Pallas fused trunk kernels but "
                "quant='xla' explicitly opts out of Pallas — use "
                "quant='pallas' or 'w8a8' (or quant=None for the float "
                "fused Mlp alone)")
        if flash_blocks is not None and (
                len(flash_blocks) != 2 or any(int(b) < 1 for b in flash_blocks)):
            raise ValueError(f"flash_blocks must be (block_q, block_kv), got "
                             f"{flash_blocks!r}")
        if quant is not None and scan_blocks:
            # JAX: the stacked kernel layout has no per-layer scale axis
            raise ValueError("quant requires scan_blocks=False")
        shard = _seq_shard(seq_mesh, seq_axis, batch_axis, sp_mode,
                           (img_size[0] // patch_size) * (img_size[1] // patch_size) + 1)
        tp = _tensor_shard(seq_mesh, head_axis, num_heads, int(embed_dim * mlp_ratio),
                           quant, fused)
        ep = _expert_shard(seq_mesh, expert_axis, num_experts)
        if shard is not None and tp is not None and shard.mode == "ulysses" and (
                (num_heads // tp.size) % pmesh.axis_size(seq_mesh, seq_axis)):
            raise heads_error(f"{num_heads}//{tp.size}={num_heads // tp.size}", seq_axis,
                              pmesh.axis_size(seq_mesh, seq_axis))
        stage = None
        if pipe_axis is not None:
            if not scan_blocks:
                raise ValueError("pipelined apply requires scan_blocks=True")
            if pipe_axis not in tuple(getattr(seq_mesh, "mesh_dim_names", None) or ()):
                raise ValueError(f"pipe_axis {pipe_axis!r} is not an axis of seq_mesh")
            stage = sharding.stage_blocks(depth, seq_mesh, pipe_axis)
        if not (use_flash in (True, False) or use_flash == "xla"):
            raise ValueError(f"use_flash must be True (the flash kernels), False "
                             f"(dense) or 'xla' (blockwise), got {use_flash!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        super().__init__()
        device = resolve_device(device)
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.total_steps = total_steps
        self.dtype = dtype
        self.use_flash = "xla" if use_flash == "xla" else bool(use_flash)
        self.remat = bool(remat)
        self.quant = quant
        self.fused = bool(fused)
        self.flash_blocks = None if flash_blocks is None else tuple(flash_blocks)
        self.seq_mesh, self.seq_axis = seq_mesh, seq_axis
        self.batch_axis, self.sp_mode = batch_axis, sp_mode
        self.shard = shard
        self.head_axis, self.tp = head_axis, tp
        self.num_experts = int(num_experts)
        self.moe_capacity_factor, self.moe_dispatch = moe_capacity_factor, moe_dispatch
        self.expert_axis, self.ep = expert_axis, ep
        self.scan_blocks = bool(scan_blocks)
        self.pipe_axis, self.stage = pipe_axis, stage
        self.mlp_ratio = mlp_ratio
        self._ctor = ctor
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.drop_path_rate = drop_path_rate
        E, N = embed_dim, self.num_patches

        self.patch_embed = PatchEmbed(patch_size, E, in_chans)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E))
        self.time_embed = nn.Embedding(total_steps, E)
        if use_sincos_pos:
            self.register_buffer(
                "pos_table", torch.from_numpy(positionalencoding1d(E, N + 1))[None],
                persistent=False)
            self.pos_embed = None
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, N + 1, E))
        # stochastic depth decay rule: linspace(0, rate, depth) (ViT.py:176)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(E, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  qk_scale=qk_scale, drop=drop_rate, attn_drop=attn_drop_rate,
                  drop_path=float(dpr[i]), use_flash=self.use_flash, quant=quant,
                  fused=self.fused,
                  block_q=int(flash_blocks[0]) if flash_blocks else None,
                  block_kv=int(flash_blocks[1]) if flash_blocks else DEFAULT_BLOCK_KV,
                  shard=shard, num_experts=num_experts,
                  moe_capacity_factor=moe_capacity_factor, moe_dispatch=moe_dispatch)
            for i in range(depth))
        self.norm = nn.LayerNorm(E, eps=1e-5)
        self.head = nn.Linear(E, in_chans * patch_size**2)
        self._init_weights(torch.Generator().manual_seed(seed))
        if quant is not None:
            for blk in self.blocks:
                for parent, names in quant_ops.TRUNK_LINEARS.items():
                    mod = getattr(blk, parent)
                    for name in names:
                        setattr(mod, name, quant_ops.QuantLinear.from_linear(
                            getattr(mod, name), quant))
        # the layout of every key of the whole model (names and ranks only)
        self.plan = sharding.plan_for(self.state_dict(), head_axis, pipe_axis,
                                      expert_axis)
        # sharded: every rank draws the whole seeded init, then keeps its part
        for blk in self.blocks:
            _shard_block(blk, tp, ep)
        if stage is not None:
            for i in range(depth):
                if i not in stage:
                    self.blocks[i] = _Elsewhere()
        self.to(device)
        self.eval()

    def clone(self, **overrides) -> "DiffusionViT":
        """A new model of this configuration with ``overrides`` applied (for
        example ``quant=``, ``fused=``), on this model's device unless
        ``device`` is overridden. Its weights come from the seeded init: load
        the ones to serve (a float state_dict through
        :func:`~ddim_cold_torch.ops.quant.quantize_state_dict` for a quant
        clone)."""
        return DiffusionViT(**{**self._ctor, "device": self.device, **overrides})

    def kernel_libraries(self) -> tuple:
        """The kernel libraries (``csrc/<name>.cu``) an inference forward of
        this model launches on CUDA."""
        libs = set()
        # under sequence parallelism the fused attention is gated off
        fused_attn = self.fused and self.quant in ("pallas", "w8a8") and self.shard is None
        if fused_attn:
            libs.add("fused_trunk")
        elif self.use_flash is True and (self.shard is None or self.shard.mode == "ulysses"):
            libs.add("flash_fwd")
        if self.fused and self.quant != "xla" and self.num_experts == 1:
            libs.add("mlp_fused")
        if self.quant == "pallas" and not fused_attn:
            libs.add("dequant_mm")
        return tuple(sorted(libs))

    @property
    def local_tokens(self) -> int:
        """Token rows this rank's trunk holds: N+1, or its sequence block."""
        return self.num_patches + 1 if self.shard is None else self.shard.n_local

    @property
    def num_patches(self) -> int:
        return (self.img_size[0] // self.patch_size) * (self.img_size[1] // self.patch_size)

    @property
    def device(self) -> torch.device:
        return self.cls_token.device

    def _init_weights(self, g: torch.Generator) -> None:
        """Reference init: trunc_normal(.02) on every Linear weight, the
        class token, time and positional embeddings; zero Linear biases;
        LayerNorm (1, 0); torch's default uniform on the patch projection."""
        fan_in = self.in_chans * self.patch_size**2
        torch_default_uniform_(self.patch_embed.proj.weight, fan_in, g)
        torch_default_uniform_(self.patch_embed.proj.bias, fan_in, g)
        trunc_normal_(self.cls_token, g)
        trunc_normal_(self.time_embed.weight, g)
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, g)
        from ddim_cold_torch.models.moe import SwitchMlp

        for mod in self.modules():
            if isinstance(mod, SwitchMlp):
                mod.reset_parameters(g)
            elif isinstance(mod, nn.Linear):
                trunc_normal_(mod.weight, g)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None, *,
                skip_blocks: Optional[tuple] = None,
                block_delta: Optional[torch.Tensor] = None,
                capture_split: Optional[int] = None,
                capture_tokens: bool = False,
                token_cache: Optional[tuple] = None,
                token_k: Optional[int] = None,
                return_attention_layer: Optional[int] = None,
                stage: str = "full", tokens: Optional[torch.Tensor] = None,
                losses: Optional[list] = None, **later):
        """``deterministic=False`` is the training forward and needs
        ``generator`` (on the model's device) for its dropout masks.

        Step-cache hooks (:mod:`ddim_cold_torch.ops.step_cache`, JAX
        vit.py:650-968), each a Python-level decision that launches nothing
        for the blocks it skips:

        * ``capture_split=s`` (1 ≤ s < depth) — a refresh forward: run every
          block and also return the cumulative deltas of the front (blocks
          [0, s)) and rear ([s, depth)) trunk halves, ``(x̂0, (delta_front,
          delta_rear))``, each (B, N+1, E) in the model dtype;
        * ``skip_blocks=(lo, hi)`` + ``block_delta`` — a reuse forward:
          blocks [lo, hi) do not run, and their cached delta is added to the
          token stream where block ``lo`` would have run;
        * ``capture_tokens=True`` — a token refresh: returns ``(x̂0, (ref_in,
          trunk_delta))``, the post-embed stream and the trunk's displacement
          ``trunk_out − ref_in``;
        * ``token_cache=(ref_in, trunk_delta)`` + ``token_k=k`` — a token
          reuse: rank the tokens by their squared change against ``ref_in``
          (float32 sums; CLS forced live), run the trunk on the top k only
          (taken in position order; k = N+1 takes every token with no gather
          and is the plain forward), and scatter the results into the cached
          stream ``tokens + trunk_delta``. The live rows of both cache
          tensors are overwritten IN PLACE, and the pair is returned:
          ``(x̂0, (ref_in, trunk_delta))``.

        The block-delta and token families exclude each other, and so do a
        family's refresh and reuse hooks.

        ``return_attention_layer=i`` — the attention probe: the blocks
        before layer ``i % depth`` run as usual, then that layer's
        attention weights (B, H, N, N) in the model dtype are returned from
        the dense path, whatever ``use_flash`` (JAX vit.py:923-931). The
        probed layer is never rematerialised; the cache hooks exclude it.

        Under sequence parallelism (``seq_mesh``) the cache tensors are this
        rank's token blocks, (B, n_local, E); a token reuse ranks every
        rank's tokens in one global selection (the positions one process
        takes), runs the trunk on the k live tokens laid out as blocks of k
        positions over the same group (``SeqShard.resized``: the attention's
        exchange and padding mask, the w8a8 scale and the expert capacity
        all at k), and each rank writes the live rows it owns back into its
        block. The probe returns the whole sequence's weights on every rank.

        ``stage="embed"`` returns the token stream after the embeddings and
        ``pos_drop`` (this rank's sequence block under sequence
        parallelism); ``stage="head"`` takes ``tokens``, the trunk's output,
        through the final LayerNorm, the head and the un-patchify (JAX
        vit.py:657-662). A pipeline stage's model (``pipe_axis``) runs no
        ``stage="full"`` forward: its trunk is the pipeline's.

        ``losses``: a list every expert bank call appends its
        :class:`~ddim_cold_torch.models.moe.RouterStats` to, the Switch
        load-balance term's inputs (JAX's ``sow`` into ``losses``;
        ``models.moe.mean_load_balance`` turns them into the aux)."""
        if later:
            raise TypeError(f"DiffusionViT.forward got an unexpected argument "
                            f"{next(iter(later))!r}")
        self._check_cache_hooks(skip_blocks, block_delta, capture_split,
                                capture_tokens, token_cache, token_k,
                                return_attention_layer, stage)
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("the training forward (deterministic=False) draws "
                             "dropout masks: pass generator")
        if stage == "head":
            if tokens is None:
                raise ValueError('stage="head" requires tokens')
            return self._head(tokens)
        tokens = self._embed(x, t, generator)
        if stage == "embed":
            return tokens
        if self.stage is not None:
            raise ValueError(
                f"this model holds pipeline stage blocks {list(self.stage)} only: "
                "run its trunk through parallel.pipeline.make_pipelined_apply")
        B = x.shape[0]
        shard = self.shard
        stream_in = tokens  # post-embed stream: the token cache's reference
        live = None
        sub = None  # the live subset's block geometry under sequence parallelism
        if token_cache is not None:
            ref_in, trunk_delta = token_cache
            if token_k < self.num_patches + 1:
                if shard is None:
                    live = _live_tokens(tokens, ref_in, token_k)
                    tokens = tokens.gather(
                        1, live[:, :, None].expand(-1, -1, self.embed_dim))
                else:
                    # one global selection; each rank then runs its block of
                    # the k live tokens, moved from the ranks that hold them
                    live = _live_tokens_sp(tokens, ref_in, token_k, shard)
                    sub = shard.resized(token_k)
                    tokens = pmesh.rows_to_blocks(tokens, shard, live, sub)
            sub_in = tokens  # the trunk below runs at sequence length k
        lo, hi = skip_blocks if skip_blocks is not None else (0, 0)
        tokens_in, tokens_mid = tokens, None
        probe = (None if return_attention_layer is None
                 else return_attention_layer % self.depth)
        # a w8a8 block's activation scale is the whole sequence's (a token
        # reuse step's: its live tokens')
        scope = (quant_ops.act_scale_over(tokens=sub or shard)
                 if shard is not None and self.quant == "w8a8"
                 else contextlib.nullcontext())
        with scope:
            for i, blk in enumerate(self.blocks):
                if lo <= i < hi:
                    if i == lo:
                        tokens = tokens + block_delta.to(self.dtype)
                    continue
                if i == probe:
                    return blk(tokens, generator, return_attention=True)
                tokens = self.run_block(i, tokens, generator, losses, shard=sub)
                if capture_split is not None and i == capture_split - 1:
                    tokens_mid = tokens

        cache = None
        if token_cache is not None:
            sub_out = tokens
            if live is None:  # k = N+1: every row is live, a full overwrite
                ref_in.copy_(sub_in)
                trunk_delta.copy_(sub_out - sub_in)
            elif sub is not None:
                # each owner writes its live rows into its own block; the
                # live rows of the reference are its stream's own rows
                out, owned = pmesh.rows_from_blocks(sub_out, sub, live, shard)
                owned = owned[:, :, None]
                tokens = torch.where(owned, out, stream_in + trunk_delta.to(self.dtype))
                ref_in.copy_(torch.where(owned, stream_in, ref_in))
                trunk_delta.copy_(torch.where(
                    owned, (out - stream_in).to(trunk_delta.dtype), trunk_delta))
            else:
                # stale tokens: last trunk output ≈ the current embedding plus
                # the cached displacement; live rows take this step's output
                rows = torch.arange(B, device=live.device)[:, None]
                tokens = stream_in + trunk_delta.to(self.dtype)
                tokens[rows, live] = sub_out
                ref_in[rows, live] = sub_in
                trunk_delta[rows, live] = (sub_out - sub_in).to(trunk_delta.dtype)
            cache = (ref_in, trunk_delta)
        elif capture_split is not None:
            cache = (tokens_mid - tokens_in, tokens - tokens_mid)
        elif capture_tokens:
            cache = (stream_in, tokens - stream_in)
        out = self._head(tokens)
        return out if cache is None else (out, cache)

    def _embed(self, x: torch.Tensor, t: torch.Tensor, generator) -> torch.Tensor:
        """The token stream after the patch, class, positional and time
        embeddings and ``pos_drop`` (``stage="embed"``): ``(B, N+1, E)``, or
        this rank's padded sequence block."""
        B = x.shape[0]
        x = x.to(self.dtype)
        shard = self.shard
        lo, hi = (0, self.num_patches + 1) if shard is None else (
            shard.lo, shard.lo + shard.n_real)
        if shard is None:
            tokens = self.patch_embed(x)
        else:  # this rank's tokens only: token i ≥ 1 is patch i − 1
            tokens = self.patch_embed.embed(
                self.patch_embed.patchify(x)[:, max(lo - 1, 0):hi - 1])
        if lo == 0:
            cls = self.cls_token.to(self.dtype).expand(B, 1, self.embed_dim)
            tokens = torch.cat([cls, tokens], dim=1)
        # time conditioning: one learned row per step, added to EVERY token
        # (cls included) with the positional embedding (ViT.py:204-205)
        time = F.embedding(t.to(x.device).long(),
                           self.time_embed.weight.to(self.dtype))[:, None, :]
        pos = self.pos_embed if self.pos_embed is not None else self.pos_table
        tokens = tokens + pos[:, lo:hi].to(self.dtype) + time
        if shard is not None:
            tokens = shard.pad(tokens)
        return _dropout(tokens, self.drop_rate, generator, shard=shard)  # pos_drop

    def _head(self, tokens: torch.Tensor) -> torch.Tensor:
        """The trunk's output through the final LayerNorm, the head and the
        un-patchify (``stage="head"``): ``(B, H, W, C)`` float32; a sequence
        block's outputs are gathered, so every rank of the group returns
        the whole image."""
        tokens = _linear(_layer_norm(tokens, self.norm), self.head)
        if self.shard is not None:
            tokens = self.shard.gather(tokens)
        return self.unpatchify(tokens[:, 1:, :]).float()

    def run_block(self, i: int, tokens: torch.Tensor,
                  generator: Optional[torch.Generator],
                  losses: Optional[list] = None,
                  shard: Optional[pmesh.SeqShard] = None) -> torch.Tensor:
        """Block ``i`` on ``tokens`` (rematerialised under ``remat`` when a
        gradient is recorded); an expert bank appends its routing
        statistics to ``losses``; ``shard`` is the block geometry of
        ``tokens`` when it is not the model's (:meth:`Block.forward`)."""
        blk = self.blocks[i]
        if self.remat and torch.is_grad_enabled():
            return _remat_block(blk, tokens, generator, losses, shard)
        return blk(tokens, generator, losses=losses, shard=shard)

    def _check_cache_hooks(self, skip_blocks, block_delta, capture_split,
                           capture_tokens, token_cache, token_k,
                           return_attention_layer=None, stage="full") -> None:
        """The JAX model's validation of the step-cache hooks, the probe and
        ``stage`` (vit.py:713-773, :851-853), with its refusals under
        ``scan_blocks``."""
        if stage not in ("full", "embed", "head"):
            raise ValueError(f"stage must be 'full', 'embed' or 'head', got {stage!r}")
        if skip_blocks is not None or capture_split is not None:
            if self.scan_blocks:
                raise ValueError(
                    "step caching (skip_blocks/capture_split) requires "
                    "scan_blocks=False — one scanned block body cannot "
                    "statically drop layers")
            if stage != "full":
                raise ValueError("step caching composes with stage='full' only")
        if capture_tokens or token_cache is not None:
            if self.scan_blocks:
                raise ValueError(
                    "token caching (capture_tokens/token_cache) requires "
                    "scan_blocks=False — the gathered subset changes the "
                    "scanned body's shape")
            if stage != "full":
                raise ValueError("token caching composes with stage='full' only")
        if return_attention_layer is not None and self.scan_blocks and stage == "full":
            raise ValueError("attention probe requires scan_blocks=False")
        if (skip_blocks is not None or capture_split is not None) and (
                return_attention_layer is not None):
            raise ValueError("step caching excludes the attention probe")
        if skip_blocks is not None and capture_split is not None:
            raise ValueError(
                "skip_blocks (reuse step) and capture_split (refresh step) "
                "are distinct cache branches — pass one or the other")
        if skip_blocks is not None:
            lo, hi = skip_blocks
            if not (0 <= lo < hi <= self.depth):
                raise ValueError(f"skip_blocks {skip_blocks} outside "
                                 f"[0, {self.depth})")
            if block_delta is None:
                raise ValueError("skip_blocks requires the cached block_delta")
        if capture_split is not None and not (1 <= capture_split < self.depth):
            raise ValueError(f"capture_split {capture_split} must split "
                             f"depth {self.depth} into two non-empty halves")
        if (capture_tokens or token_cache is not None) and (
                return_attention_layer is not None):
            raise ValueError("token caching excludes the attention probe")
        if (capture_tokens or token_cache is not None) and (
                skip_blocks is not None or capture_split is not None):
            raise ValueError(
                "token caching (capture_tokens/token_cache) and block-"
                "delta caching (skip_blocks/capture_split) are distinct "
                "cache families — pass one or the other")
        if capture_tokens and token_cache is not None:
            raise ValueError(
                "capture_tokens (refresh step) and token_cache (reuse step) "
                "are distinct cache branches — pass one or the other")
        if token_cache is not None:
            if token_k is None or not (1 <= token_k <= self.num_patches + 1):
                raise ValueError(
                    f"token_cache requires static token_k in "
                    f"[1, {self.num_patches + 1}], got {token_k!r}")
        elif token_k is not None:
            raise ValueError("token_k only applies with token_cache")

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, p²C) → (B, H, W, C): pixel (i·p+a, j·p+b, c) ← feature
        a·pC + b·C + c of patch (i, j) (reference ViT.py:214-217)."""
        p, C = self.patch_size, self.in_chans
        H, W = self.img_size
        x = x.reshape(x.shape[0], H // p, W // p, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(x.shape[0], H, W, C)


def _seq_shard(mesh, seq_axis: Optional[str], batch_axis: Optional[str], sp_mode: str,
               total: int) -> Optional[pmesh.SeqShard]:
    """The model's token block on ``mesh``'s ``seq_axis``; None unless both
    are given (JAX's ``seq_parallel``)."""
    if sp_mode not in ("ring", "ulysses"):
        raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got {sp_mode!r}")
    if mesh is None or seq_axis is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    for what, axis in (("seq_axis", seq_axis), ("batch_axis", batch_axis)):
        if axis is not None and axis not in names:
            raise ValueError(f"{what} {axis!r} is not an axis of the mesh {names}")
    return pmesh.seq_shard(mesh, seq_axis, total, sp_mode)


class _Elsewhere(nn.Module):
    """The place of a block another pipeline stage holds (no parameters)."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this block lives on another pipeline stage")


def _tensor_shard(mesh, head_axis: Optional[str], num_heads: int, hidden: int,
                  quant: Optional[str], fused: bool) -> Optional[TensorShard]:
    """This rank's place on the ``head_axis`` of ``mesh`` (None without
    one), with JAX's head-divisibility error."""
    if head_axis is None:
        return None
    if mesh is None:
        raise ValueError("head_axis names an axis of seq_mesh: pass the mesh")
    m = check_head_axis(mesh, head_axis, num_heads)
    if hidden % m:
        raise ValueError(f"the Mlp's {hidden} hidden units must divide over the "
                         f"'{head_axis}' axis ({m})")
    if quant is not None or fused:
        raise NotImplementedError(
            "quant and fused under tensor parallelism are not ported yet: "
            "ROADMAP.md Queue 1 item 14")
    return TensorShard(mesh.get_group(head_axis), m, pmesh.axis_index(mesh, head_axis))


def _expert_shard(mesh, expert_axis: Optional[str],
                  num_experts: int) -> Optional[TensorShard]:
    """This rank's place on the ``expert_axis`` of ``mesh`` (None without
    one), with JAX's check: the axis needs ``num_experts`` > 1 and divisible
    by it (JAX trainer.py:263-268)."""
    if expert_axis is None:
        return None
    if mesh is None:
        raise ValueError("expert_axis names an axis of seq_mesh: pass the mesh")
    if expert_axis not in tuple(mesh.mesh_dim_names or ()):
        raise ValueError(f"expert_axis {expert_axis!r} is not an axis of seq_mesh")
    size = pmesh.axis_size(mesh, expert_axis)
    if num_experts <= 1 or num_experts % size:
        raise ValueError(f"mesh 'expert' axis of {size} needs num_experts (got "
                         f"{num_experts}) set and divisible by it")
    return TensorShard(mesh.get_group(expert_axis), size,
                       pmesh.axis_index(mesh, expert_axis))


def _shard_block(blk: Block, tp: Optional[TensorShard], ep: Optional[TensorShard]) -> None:
    """Cut a block built whole to this rank's shards: its heads and Mlp
    hidden units along ``tp``, its experts along ``ep`` (an expert bank
    stays whole along ``tp``, as JAX's specs keep it)."""
    if tp is not None:
        blk.attn.shard_heads(tp)
        if hasattr(blk, "mlp"):
            blk.mlp.shard_hidden(tp)
    if ep is not None:
        blk.moe.shard_experts(ep)


def block_template(model: DiffusionViT, *, seq_manual_axis=None, seq_valid_len=None,
                   seq_varying_axes=None) -> Block:
    """A fresh single-layer :class:`Block` of ``model``'s configuration
    (JAX's ``block_template``, vit.py:501-523): its width, heads, drop rates
    (drop path 0: JAX feeds each layer's rate in), kernels route, expert
    bank, sequence block and tensor and expert shards, weights from torch's
    default init (an expert bank's from JAX's, seeded 0). The port's
    pipeline runs the model's own blocks; this is the unit a stage repeats.
    ``seq_manual_axis`` must name the model's own ``seq_axis`` (the port's
    sequence-parallel blocks always run on their local block);
    ``seq_valid_len`` and ``seq_varying_axes`` (JAX's typing aids) are
    accepted and unused."""
    del seq_valid_len, seq_varying_axes
    if seq_manual_axis is not None and seq_manual_axis != model.seq_axis:
        raise ValueError(f"seq_manual_axis {seq_manual_axis!r} is not the model's "
                         f"seq_axis {model.seq_axis!r}")
    blk = Block(model.embed_dim, model.num_heads, mlp_ratio=model.mlp_ratio,
                qkv_bias=model._ctor["qkv_bias"], qk_scale=model._ctor["qk_scale"],
                drop=model.drop_rate, attn_drop=model.attn_drop_rate, drop_path=0.0,
                use_flash=model.use_flash, fused=model.fused,
                block_q=int(model.flash_blocks[0]) if model.flash_blocks else None,
                block_kv=int(model.flash_blocks[1]) if model.flash_blocks else DEFAULT_BLOCK_KV,
                shard=model.shard, num_experts=model.num_experts,
                moe_capacity_factor=model.moe_capacity_factor,
                moe_dispatch=model.moe_dispatch)
    if hasattr(blk, "moe"):
        blk.moe.reset_parameters(torch.Generator().manual_seed(0))
    _shard_block(blk, model.tp, model.ep)
    return blk.to(model.device)


def sp_clone(model: DiffusionViT, mesh, *, sp_mode: str = "ulysses",
             seq_axis: str = "seq", batch_axis: str = "data",
             head_axis=None) -> DiffusionViT:
    """The sequence-parallel variant of ``model`` over ``mesh``, carrying
    ``model``'s weights (JAX ``sp_clone``, vit.py:986); a quant or fused
    model keeps its ``quant`` and ``fused``. ``sp_mode="ulysses"`` needs the
    tp-local head count divisible by the seq axis and falls back to the
    ring otherwise, which has no head constraint. A ``batch_axis`` the mesh
    lacks is dropped. ``head_axis`` (a tensor-parallel axis of ``mesh``):
    each rank holds its heads' shard of the weights and attends over those
    heads only, inside the sequence-parallel attention."""
    parts = pmesh.axis_size(mesh, seq_axis)
    tp = pmesh.axis_size(mesh, head_axis) if head_axis else 1
    if sp_mode == "ulysses" and (model.num_heads // tp) % parts:
        sp_mode = "ring"
    if batch_axis not in tuple(mesh.mesh_dim_names or ()):
        batch_axis = None
    clone = model.clone(seq_mesh=mesh, seq_axis=seq_axis, batch_axis=batch_axis,
                        sp_mode=sp_mode, head_axis=head_axis)
    state = model.state_dict()
    if head_axis is not None:
        state = sharding.shard_state_dict(state, mesh, clone.plan)
    clone.load_state_dict(state, strict=True)
    return clone
