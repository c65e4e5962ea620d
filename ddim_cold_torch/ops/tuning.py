"""Block tuning for the fused sampler-trunk kernels at the 200px geometries.

Counterpart of ``ddim_cold_tpu/ops/tuning.py``, with its names, its
geometry tags, its table key and lookup rule and its static picks, over the
card kernels' own legal blocks:

* the candidate spaces (:func:`attn_candidates`, :func:`mlp_candidates`,
  :func:`dequant_candidates`) are the blocks a CUDA kernel takes. A
  candidate passes the kernel's geometry check
  (``flash_attention.fused_geometry``, ``quant_ops.w8a8_block_m``), is a fixed
  point of ``tiling.legal_block`` (the block timed is the block run), and
  the kernel's shared memory at that geometry, modelled from its own
  arithmetic (:func:`attn_smem_bytes`, :func:`mlp_smem_bytes`,
  :func:`dequant_smem_bytes`), fits ``utils/flops.smem_bytes(kind)``: the
  budget that takes the place of the TPU's VMEM. The TPU's lane and
  sublane padding rules and its padding-waste ceiling have no counterpart:
  the card kernels pad to their own tiles whatever the block. In w8a8 the
  block is a requant block, a whole number of the kernel's row units inside
  one thread-block cluster: ``block_q`` of the fused attention is 64, 128,
  256 or 512 rows, ``block_m`` of the fused Mlp 32, 64, …, 256. In every
  other mode, and in the dequant matmul, the kernel runs one fixed tile
  (``kBlockQ``/``kBlockKV``/``kBM``… in ``csrc/*.cu``), which is the whole
  space: there a block size changes no launch and no value.
* the static picks keep JAX's rule (:func:`pick_attn`: fewest q blocks,
  then fewest kv blocks, then the largest; :func:`pick_mlp`: the largest
  ``block_m``); at 200_p4 in w8a8 they are the fallbacks, 512 and 256.
* :data:`TUNED_BLOCKS` is keyed (device kind, dtype name, geometry tag) as
  in JAX and read by :func:`lookup` (longest prefix of the device kind).
  It holds no row: JAX's rows are a TPU's, and a card row lands only as a
  table diff with the timing evidence of :func:`autotune_attn` /
  :func:`autotune_mlp` beside it. In w8a8 a row also moves the served value
  (the block is where the activation is requantized). So :func:`attn_blocks`
  and :func:`mlp_block_m` return JAX's fallbacks, ``NS_FLASH_BLOCKS`` and
  256, on the CPU and on the card.
* :func:`autotune_attn` / :func:`autotune_mlp` time every candidate on the
  card with CUDA events after a warm launch, hold each output against the
  plain version at the same block (``quant_ops.trunk_error_limit``), and return
  the candidates fastest first. They raise without CUDA: there is no CPU
  timing. ``python -m ddim_cold_torch.ops.tuning`` prints the static picks
  for the 200_p4 and 200_p8 geometries, ``--sweep`` runs both sweeps on the
  card.

The model reads the device kind of the device its tensors are on
(:func:`_local_device_kind`), as JAX reads ``jax.devices()[0]``.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Optional

import torch

from ddim_cold_torch.ops import flash_attention as fa
from ddim_cold_torch.ops import quant as quant_ops
from ddim_cold_torch.ops import tiling
from ddim_cold_torch.utils import flops as flops_util

#: the card the candidate spaces are enumerated for by default
DEVICE_KIND = "NVIDIA H100 80GB HBM3"
#: the shared memory the kernels let one block take (``csrc/*.cu`` check
#: their launches against it): the budget where the device kind is unknown
KERNEL_SMEM_BYTES = 232_448

_F32 = 4

#: the fused attention's fixed tile by x's dtype, (query rows, keys): a
#: float32 CTA of ``fused_trunk.cu``'s FMA kernel (``kBlockQ``, ``kBlockKV``),
#: a bfloat16 CTA of its wgmma kernel (``kBRows``, its 128-key k|v slice)
ATTN_TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 128)}
#: the dequant matmul's fixed tile by x's dtype, (rows, columns, reduction):
#: ``dequant_mm.cu``'s FMA kernel (``kBM``, ``kBN``, ``kBK``), its wgmma
#: kernel (``gm::kRows``, ``gm::kBN``, ``gm::kBK``)
DEQUANT_TILES = {torch.float32: (64, 64, 32), torch.bfloat16: (128, 128, 64)}
#: w8a8 requant blocks offered to the fused attention and the fused Mlp:
#: whole row units up to a cluster's; each kernel's check keeps its own
ATTN_W8A8_BLOCKS = tuple(range(fa.FUSED_ROWS, fa.FUSED_ROWS * fa.FUSED_CLUSTER + 1,
                               fa.FUSED_ROWS))
MLP_W8A8_BLOCKS = tuple(range(quant_ops.MLP_BLOCK_UNIT, 8 * quant_ops.MLP_BLOCK_UNIT + 1,
                              quant_ops.MLP_BLOCK_UNIT))

#: the wgmma GEMM mainloop's constants (``csrc/gemm_wgmma.cuh``)
_GM_ROWS, _GM_BN, _GM_BK, _GM_GROUPS, _GM_MAX_STAGES = 128, 128, 64, 2, 4


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (the table's dtype key)."""
    return str(dtype).split(".")[-1]


def _compute_dtype(act_dtype: torch.dtype, compute_dtype) -> torch.dtype:
    """x's dtype: ``compute_dtype``, else the activation dtype when it is a
    float, else float32 (JAX's sweep of the int8 activations)."""
    if compute_dtype is not None:
        return compute_dtype
    return act_dtype if act_dtype.is_floating_point else torch.float32


def attn_geometry(n: int, c: int, heads: int) -> str:
    """Geometry tag for a fused-attention problem (tokens, embed, heads)."""
    return f"attn_n{n}_c{c}_h{heads}"


def mlp_geometry(c: int, hidden: int, *, quant: bool = True) -> str:
    """Geometry tag for a fused-Mlp problem (embed, hidden width); int8
    weights (``mlp_``) and float weights (``mlpf_``) are two geometries, as
    in JAX."""
    return f"{'mlp' if quant else 'mlpf'}_c{c}_h{hidden}"


def dequant_geometry(m: int, k: int, n: int) -> str:
    """Geometry tag for a standalone dequant-matmul problem."""
    return f"dequant_m{m}_k{k}_n{n}"


# ---------------------------------------------------------------------------
# shared memory, from each kernel's own arithmetic
# ---------------------------------------------------------------------------

def attn_smem_bytes(c: int, heads: int, compute_dtype, mode: str) -> int:
    """Dynamic shared memory of one ``fused_trunk.cu`` block: the float32
    kernel's ``smem_floats<D>(C)``, the bfloat16 kernel's
    ``bf16_smem_bytes<D, MODE>(C)``. Neither depends on ``block_q``."""
    d = c // heads
    if compute_dtype == torch.float32:
        bq, bkv, bk, stride = 64, 64, 32, 64 + 4
        proj_cols = max(2 * d, 64)
        tiles = bk * stride + bk * (proj_cols + 1)
        floats = (bq * d + 2 * (d * (bkv + 1) + bkv * d) + max(bq * bkv, tiles)
                  + c * stride + 8)
        return _F32 * floats
    rows, kb = 128, (64 if mode == "w8a8" else 128)
    return (1024 + 2 * rows * c + (c // 64) * max(2 * d, 64) * kb + 2 * rows * kb
            + 2 * 4 * 64 * 2 * d + (rows * c if mode == "w8a8" else 0) + 64)


def _mlp_bf16_total(k: int, hidden: int, nout: int, mode: Optional[str], stages: int,
                    with_vec: bool) -> int:
    """``MlpSmem<KIND>(K, Hf, Nout, stages, vec).total`` of ``mlp_fused.cu``."""
    row_bytes = 64 if mode == "w8a8" else 128
    kcx, kch = -(-k // _GM_BK), -(-hidden // _GM_BK)
    stage = _GM_GROUPS * 64 * (_GM_BN + 8) * 2
    x_bytes, h_bytes = kcx * _GM_ROWS * row_bytes, kch * _GM_ROWS * 128
    if mode == "w8a8":
        x_bytes = max(x_bytes, kch * _GM_ROWS * 64)
        h_bytes = max(h_bytes, stage)
    else:
        x_bytes = max(x_bytes, stage)
    ring = (2 if mode == "pallas" else stages) * _GM_BN * row_bytes
    return 1024 + x_bytes + h_bytes + ring + 64 + (8 * (hidden + nout) if with_vec else 0)


def mlp_smem_bytes(k: int, hidden: int, nout: int, compute_dtype,
                   mode: Optional[str]) -> int:
    """Dynamic shared memory of one ``mlp_fused.cu`` block: the float32
    kernel's ``smem_bytes(K, Hf)``; the bfloat16 kernel's deepest weight
    ring that fits beside the scale and bias vectors, else two stages
    without them. Neither depends on ``block_m``."""
    if compute_dtype == torch.float32:
        rows_t, bk, ws = 32 + 4, 32, 64 + 1
        return _F32 * ((tiling.round_up(k, bk) + tiling.round_up(hidden, bk)) * rows_t
                       + bk * ws + 256 // 32 + 1)
    for stages in range(2 if mode == "pallas" else _GM_MAX_STAGES, 1, -1):
        total = _mlp_bf16_total(k, hidden, nout, mode, stages, True)
        if total <= KERNEL_SMEM_BYTES:
            return total
    return _mlp_bf16_total(k, hidden, nout, mode, 2, False)


def dequant_smem_bytes(n: int, k: int, compute_dtype) -> int:
    """Shared memory of one ``dequant_mm.cu`` block: the float32 kernel's
    static x and weight tiles; the bfloat16 kernel's ``bf16_smem_bytes``
    with its output in x's dtype (the scale and bias vectors held when they
    fit)."""
    if compute_dtype == torch.float32:
        return _F32 * (32 * (64 + 4) + 32 * (64 + 1))
    base = (1024 + -(-k // _GM_BK) * _GM_ROWS * 128 + 2 * _GM_BN * 128
            + _GM_GROUPS * 64 * (_GM_BN + 8) * compute_dtype.itemsize)
    return base + 8 * n if base + 8 * n <= KERNEL_SMEM_BYTES else base


# ---------------------------------------------------------------------------
# legal candidate enumeration
# ---------------------------------------------------------------------------

def _budget(device_kind: str) -> int:
    return flops_util.smem_bytes(device_kind) or KERNEL_SMEM_BYTES


def attn_candidates(n: int, c: int, heads: int, act_dtype, *,
                    device_kind: str = DEVICE_KIND,
                    compute_dtype=None) -> list[tuple[int, int]]:
    """All (block_q, block_kv) pairs ``fused_trunk.cu`` takes at this
    geometry. ``act_dtype`` int8 is the w8a8 kernel (JAX's key), any float
    the w8a16 one; ``compute_dtype`` is x's dtype (default: the float
    activation dtype, float32 for int8). w8a8: every requant block of
    :data:`ATTN_W8A8_BLOCKS` that ``legal_block`` keeps at N and
    ``fused_geometry`` takes, beside the kernel's key tile; otherwise the
    one fixed tile. Empty when the kernel cannot take the geometry or its
    shared memory does not fit."""
    mode = "w8a8" if act_dtype == torch.int8 else "pallas"
    cdt = _compute_dtype(act_dtype, compute_dtype)
    if cdt not in ATTN_TILES:
        return []
    if attn_smem_bytes(c, heads, cdt, mode) > _budget(device_kind):
        return []
    tile_q, tile_kv = ATTN_TILES[cdt]
    blocks = ATTN_W8A8_BLOCKS if mode == "w8a8" else (tile_q,)
    cands = []
    for bq in blocks:
        if mode == "w8a8" and not tiling.is_legal(bq, n, torch.int8):
            continue
        try:
            fa.fused_geometry(1, n, c, heads, bq, mode)
        except ValueError:
            continue
        cands.append((bq, tile_kv))
    return cands


def mlp_candidates(m: int, k: int, hidden: int, nout: int, act_dtype, *,
                   device_kind: str = DEVICE_KIND, quant: bool = True,
                   compute_dtype=None) -> list[int]:
    """All ``block_m`` values ``mlp_fused.cu`` takes at this geometry: in
    w8a8 (``act_dtype`` int8) every block of :data:`MLP_W8A8_BLOCKS` that
    ``legal_block`` keeps at M and ``quant_ops.w8a8_block_m`` takes; otherwise
    the kernel's fixed rows a block (``quant_ops.MLP_ROWS``). Empty when its
    shared memory does not fit."""
    w8a8 = act_dtype == torch.int8
    mode = "w8a8" if w8a8 else ("pallas" if quant else None)
    cdt = _compute_dtype(act_dtype, compute_dtype)
    if cdt not in quant_ops.MLP_ROWS:
        return []
    if w8a8 and max(k, hidden) > quant_ops.EXACT_F32_K:
        return []
    if cdt == torch.bfloat16 and (k % 16 or hidden % 16):
        return []
    if mlp_smem_bytes(k, hidden, nout, cdt, mode) > _budget(device_kind):
        return []
    if not w8a8:
        return [quant_ops.MLP_ROWS[cdt]]
    cands = []
    for bm in MLP_W8A8_BLOCKS:
        if not tiling.is_legal(bm, m, torch.int8):
            continue
        try:
            quant_ops.w8a8_block_m(bm, m)
        except ValueError:
            continue
        cands.append(bm)
    return cands


def dequant_candidates(m: int, k: int, n: int, act_dtype, *,
                       device_kind: str = DEVICE_KIND) -> list[tuple[int, int, int]]:
    """The (block_m, block_n, block_k) ``dequant_mm.cu`` runs at any M: its
    one fixed tile for x's dtype, when its shared memory fits."""
    del m
    if act_dtype not in DEQUANT_TILES:
        return []
    if dequant_smem_bytes(n, k, act_dtype) > _budget(device_kind):
        return []
    return [DEQUANT_TILES[act_dtype]]


# ---------------------------------------------------------------------------
# static picks + the table
# ---------------------------------------------------------------------------

def pick_attn(n: int, c: int, heads: int, act_dtype, *,
              device_kind: str = DEVICE_KIND,
              compute_dtype=None) -> Optional[tuple[int, int]]:
    """Static pick, JAX's rule: fewest q blocks, then fewest kv blocks, then
    the largest of each, inside the legal space."""
    cands = attn_candidates(n, c, heads, act_dtype, device_kind=device_kind,
                            compute_dtype=compute_dtype)
    if not cands:
        return None
    n_q = lambda bq: tiling.round_up(n, bq) // bq  # noqa: E731
    n_kv = lambda bkv: tiling.round_up(n, bkv) // bkv  # noqa: E731
    return min(cands, key=lambda bqkv: (n_q(bqkv[0]), n_kv(bqkv[1]),
                                        -bqkv[0], -bqkv[1]))


def pick_mlp(m: int, k: int, hidden: int, nout: int, act_dtype, *,
             device_kind: str = DEVICE_KIND, quant: bool = True,
             compute_dtype=None) -> Optional[int]:
    """Static pick, JAX's rule: the largest legal ``block_m``."""
    cands = mlp_candidates(m, k, hidden, nout, act_dtype, device_kind=device_kind,
                           quant=quant, compute_dtype=compute_dtype)
    return max(cands) if cands else None


#: tuned blocks keyed (device kind, dtype name, geometry tag); values as in
#: JAX: attention (block_q, block_kv), Mlp (block_m,), dequant (block_m,
#: block_n, block_k). Empty (see the module): absent keys fall back.
TUNED_BLOCKS: dict[tuple[str, str, str], tuple[int, ...]] = {}


def lookup(device_kind: str, dtype, geometry: str) -> Optional[tuple[int, ...]]:
    """Tuned blocks for (device kind, dtype, geometry), or None; the device
    kind is prefix-matched, the longest entry winning (JAX's rule)."""
    name = dtype_name(dtype)
    best = None
    for (kind, dt, geom), blocks in TUNED_BLOCKS.items():
        if dt == name and geom == geometry and device_kind.startswith(kind):
            if best is None or len(kind) > best[0]:
                best = (len(kind), blocks)
    return best[1] if best else None


def _local_device_kind(device=None) -> str:
    """The kind of ``device`` (the device a model's tensors are on): the
    card's ``torch.cuda.get_device_name``, or ``"cpu"``."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def attn_blocks(n: int, c: int, heads: int, act_dtype, *,
                device_kind: Optional[str] = None, device=None) -> tuple[int, int]:
    """(block_q, block_kv) of a fused-attention problem: the tuned entry for
    (device kind, dtype, geometry), else ``NS_FLASH_BLOCKS`` (JAX's)."""
    kind = device_kind if device_kind is not None else _local_device_kind(device)
    tuned = lookup(kind, act_dtype, attn_geometry(n, c, heads))
    if tuned is not None and len(tuned) == 2:
        return (int(tuned[0]), int(tuned[1]))
    return fa.NS_FLASH_BLOCKS


def mlp_block_m(c: int, hidden: int, act_dtype, *, quant: bool = True,
                device_kind: Optional[str] = None, default: int = 256,
                device=None) -> int:
    """``block_m`` of a fused-Mlp problem: the tuned entry, else ``default``
    (JAX's 256). ``quant`` selects the int8- or float-weight geometry."""
    kind = device_kind if device_kind is not None else _local_device_kind(device)
    tuned = lookup(kind, act_dtype, mlp_geometry(c, hidden, quant=quant))
    if tuned is not None and len(tuned) == 1:
        return int(tuned[0])
    return default


# ---------------------------------------------------------------------------
# on-card timing sweeps
# ---------------------------------------------------------------------------

def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the tuning sweeps time the CUDA kernels on the card: they "
                           f"need a CUDA device, got {device} (there is no CPU timing)")
    return device


def _time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, after one warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _held(y, ref, limit) -> dict:
    diff = (y.float() - ref.float()).abs()
    return {"max_abs_err": diff.max().item(),
            "max_err_over_limit": (diff / limit).max().item(),
            "within_limit": bool((diff <= limit).all()) and bool(torch.isfinite(y).all())}


def _weights(c_out: int, c_in: int, gen, device):
    return quant_ops.quantize_weight(torch.randn((c_out, c_in), generator=gen, device=device)
                                 * 0.05)


@torch.inference_mode()
def autotune_attn(batch: int, n: int, c: int, heads: int, act_dtype, *,
                  mode: str = "pallas", iters: int = 10, device="cuda",
                  seed: int = 0) -> list[dict]:
    """Time ``fused_trunk_attention`` over its legal candidates on the card
    (x in ``act_dtype``, float32 or bfloat16; ``mode`` "pallas" or "w8a8"),
    each held against its plain version at the same block within
    ``quant_ops.trunk_error_limit``; fastest first. Raises without CUDA, and
    when a candidate misses its limit."""
    device = _card(device)
    cdt = act_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, n, c), generator=gen, device=device).to(cdt)
    (wq, sq), (wp, sp) = _weights(3 * c, c, gen, device), _weights(c, c, gen, device)
    bq_, bp_ = (torch.randn(rows, generator=gen, device=device) * 0.1 for rows in (3 * c, c))
    args = (x, wq, sq, bq_, wp, sp, bp_)
    kind = _local_device_kind(device)
    key = torch.int8 if mode == "w8a8" else cdt
    smem = attn_smem_bytes(c, heads, cdt, mode)
    results = []
    for block_q, block_kv in attn_candidates(n, c, heads, key, device_kind=kind,
                                             compute_dtype=cdt):
        kw = dict(num_heads=heads, scale=(c // heads) ** -0.5, block_q=block_q, mode=mode)
        run = functools.partial(fa.fused_trunk_attention, *args, **kw)
        ms = _time_ms(run, iters)
        ref, row_scale = fa.fused_trunk_attention_reference(*args, **kw,
                                                            return_row_scale=True)
        flip = quant_ops.requant_flip_bound(row_scale, wp, sp) if mode == "w8a8" else None
        rec = {"block_q": block_q, "block_kv": block_kv, "seconds": ms / 1e3, "ms": ms,
               "smem_bytes": smem,
               **_held(run(), ref, quant_ops.trunk_error_limit(ref, mode, flip))}
        if not rec["within_limit"]:
            raise RuntimeError(f"fused_trunk at block_q={block_q} misses its limit: {rec}")
        results.append(rec)
    return sorted(results, key=lambda r: r["seconds"])


@torch.inference_mode()
def autotune_mlp(m: int, k: int, hidden: int, act_dtype, *,
                 mode: Optional[str] = "pallas", iters: int = 10, device="cuda",
                 seed: int = 0) -> list[dict]:
    """Time ``mlp_fused`` over its legal ``block_m`` values on the card (x
    ``(m, k)`` in ``act_dtype``; ``mode`` None, "pallas" or "w8a8"), each
    held against its plain version at the same block; fastest first. Raises
    without CUDA, and when a candidate misses its limit."""
    device = _card(device)
    cdt = act_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(cdt)
    (w1, s1), (w2, s2) = _weights(hidden, k, gen, device), _weights(k, hidden, gen, device)
    b1, b2 = (torch.randn(rows, generator=gen, device=device) * 0.1 for rows in (hidden, k))
    if mode is None:
        w1, w2 = quant_ops.dequantize_weight(w1, s1, cdt), quant_ops.dequantize_weight(w2, s2, cdt)
        scales = {}
    else:
        scales = dict(scale1=s1, scale2=s2)
    kind = _local_device_kind(device)
    key = torch.int8 if mode == "w8a8" else cdt
    smem = mlp_smem_bytes(k, hidden, k, cdt, mode)
    results = []
    for block_m in mlp_candidates(m, k, hidden, k, key, device_kind=kind,
                                  quant=mode is not None, compute_dtype=cdt):
        kw = dict(scales, mode=mode, block_m=block_m)
        run = functools.partial(quant_ops.mlp_fused, x, w1, b1, w2, b2, **kw)
        ms = _time_ms(run, iters)
        ref, row_scale = quant_ops.mlp_fused_reference(x, w1, b1, w2, b2, **kw,
                                                   return_row_scale=True)
        flip = quant_ops.requant_flip_bound(row_scale, w2, s2) if mode == "w8a8" else None
        rec = {"block_m": block_m, "seconds": ms / 1e3, "ms": ms, "smem_bytes": smem,
               **_held(run(), ref, quant_ops.trunk_error_limit(ref, mode, flip))}
        if not rec["within_limit"]:
            raise RuntimeError(f"mlp_fused at block_m={block_m} misses its limit: {rec}")
        results.append(rec)
    return sorted(results, key=lambda r: r["seconds"])


#: the 200px geometries (N, C, heads): 200_p4 and 200_p8
GEOMETRIES = ((2501, 256, 4), (626, 384, 12))
#: rows of the serve bucket the Mlp's M counts
ROWS = 8


def _main(argv=None) -> None:  # pragma: no cover — run on the card for --sweep
    """Print the static picks at the 200px geometries, one line each;
    ``--sweep`` adds the 200_p4 bf16 w8a8 sweeps on the card as JSON."""
    parser = argparse.ArgumentParser(description=_main.__doc__)
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args(argv)
    for n, c, h in GEOMETRIES:
        for cdt in (torch.float32, torch.bfloat16):
            for act in (cdt, torch.int8):
                print(attn_geometry(n, c, h), dtype_name(act), dtype_name(cdt),
                      pick_attn(n, c, h, act, compute_dtype=cdt))
                print(mlp_geometry(c, c), dtype_name(act), dtype_name(cdt),
                      pick_mlp(ROWS * n, c, c, c, act, compute_dtype=cdt))
            print(mlp_geometry(c, c, quant=False), dtype_name(cdt), dtype_name(cdt),
                  pick_mlp(ROWS * n, c, c, c, cdt, quant=False))
            for nout in (3 * c, c):
                print(dequant_geometry(ROWS * n, c, nout), dtype_name(cdt),
                      dequant_candidates(ROWS * n, c, nout, cdt))
    if args.sweep:
        n, c, h = GEOMETRIES[0]
        print(json.dumps({"autotune_attn": autotune_attn(ROWS, n, c, h, torch.bfloat16,
                                                         mode="w8a8")}))
        print(json.dumps({"autotune_mlp": autotune_mlp(ROWS * n, c, c, torch.bfloat16,
                                                       mode="w8a8")}))


if __name__ == "__main__":  # pragma: no cover
    _main()
