"""Analytic FLOP accounting for the DiffusionViT — the MFU denominator.

Counterpart of ``ddim_cold_tpu/utils/flops.py``: the same analytic
functions, with the card's tables in place of the TPU ones. The model's
matmul FLOPs are counted from its shapes and divided by (peak · time);
elementwise, softmax and LayerNorm work is not counted, as standard MFU
practice counts tensor-core FLOPs only.

Peaks are per card, dense (not sparse), from NVIDIA's H100 data sheet, keyed
by the exact name ``torch.cuda.get_device_name()`` and ``nvidia-smi``
print, so a record names the hardware it ran on. The lookup is a
longest-prefix match, as the JAX tables' is; there is no bare
``"NVIDIA H100"`` key, so one card's numbers never reach another part.
An unknown kind (``"cpu"``, another card) returns None.

Host-only: no torch import.
"""

from __future__ import annotations

#: bf16 dense peak TFLOP/s per card, by device name (prefix-matched).
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,  # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 756.5,       # H100 PCIe, 350 W
    "NVIDIA H100 NVL": 835.5,        # H100 NVL, 400 W
}

#: int8 dense peak TOP/s per card — the rate the w8a8 trunk's int8 × int8
#: products (``ops/quant.py``, ``csrc/mlp_fused.cu``, ``csrc/fused_trunk.cu``)
#: are entitled to; w8a16 widens its codes and multiplies at the bf16 rate.
PEAK_INT8_TOPS = {
    "NVIDIA H100 80GB HBM3": 1978.9,  # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 1513.0,       # H100 PCIe, 350 W
    "NVIDIA H100 NVL": 1671.0,        # H100 NVL, 400 W
}

#: device-memory bandwidth GB/s per card — the roofline's other axis: a
#: scope whose arithmetic intensity sits below peak/bandwidth is
#: bandwidth-bound however its kernels schedule the tensor cores.
HBM_GB_S = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 2000.0,       # H100 PCIe, 350 W
    "NVIDIA H100 NVL": 3900.0,        # H100 NVL, 400 W
}

#: the opt-in shared memory one thread block may take, in bytes (sm_90:
#: 227 KiB; ``csrc/fused_trunk.cu`` fills it at C=256) — the budget a
#: kernel's per-block footprint must fit inside, in place of the TPU
#: tables' per-core VMEM.
SMEM_BYTES = {
    "NVIDIA H100 80GB HBM3": 232_448,  # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 232_448,       # H100 PCIe, 350 W
    "NVIDIA H100 NVL": 232_448,        # H100 NVL, 400 W
}

#: device-memory capacity per card in bytes — the budget a program's peak
#: live bytes must fit inside.
HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 80 << 30,  # H100 SXM5, 700 W: 80 GiB
    "NVIDIA H100 PCIe": 80 << 30,       # H100 PCIe, 350 W: 80 GiB
    "NVIDIA H100 NVL": 94 * 10**9,      # H100 NVL, 400 W: 94 GB
}


def _prefix_lookup(table: dict, device_kind: str) -> float | None:
    best = None
    for kind, peak in table.items():
        if device_kind.startswith(kind) and (best is None or len(kind) > best[0]):
            best = (len(kind), peak)
    return best[1] if best else None


def peak_tflops(device_kind: str) -> float | None:
    """Longest-prefix match of the device name; None when unknown (CPU etc.)."""
    return _prefix_lookup(PEAK_BF16_TFLOPS, device_kind)


def peak_int8_tops(device_kind: str) -> float | None:
    """int8 dense peak TOP/s; None when unknown."""
    return _prefix_lookup(PEAK_INT8_TOPS, device_kind)


def mixed_peak_tflops(device_kind: str, int8_fraction: float = 0.0) -> float | None:
    """Effective peak when ``int8_fraction`` of a step's matmul FLOPs run at
    the int8 rate and the rest at bf16 — the time-weighted harmonic mix
    (each fraction contributes its FLOPs/rate to the ideal step time).
    With no int8 table entry the whole step is charged at bf16 — MFU stays
    conservative rather than flattering."""
    bf16 = peak_tflops(device_kind)
    if bf16 is None:
        return None
    f = min(max(float(int8_fraction), 0.0), 1.0)
    if f == 0.0:
        return bf16
    int8 = peak_int8_tops(device_kind) or bf16
    return 1.0 / (f / int8 + (1.0 - f) / bf16)


def smem_bytes(device_kind: str) -> int | None:
    """Opt-in shared memory per block in bytes; None when unknown."""
    v = _prefix_lookup(SMEM_BYTES, device_kind)
    return None if v is None else int(v)


def hbm_bytes(device_kind: str) -> int | None:
    """Device-memory capacity in bytes; None when unknown (CPU etc.)."""
    v = _prefix_lookup(HBM_BYTES, device_kind)
    return None if v is None else int(v)


def hbm_gb_s(device_kind: str) -> float | None:
    """Device-memory bandwidth GB/s; None when unknown (CPU etc.)."""
    return _prefix_lookup(HBM_GB_S, device_kind)


def ridge_flops_per_byte(device_kind: str,
                         int8_fraction: float = 0.0) -> float | None:
    """The roofline ridge point: arithmetic intensity (FLOPs/byte) at which
    peak compute and peak memory bandwidth take equal time. Scopes below it
    are memory-bound, above it compute-bound. None when either peak is
    unknown."""
    peak = mixed_peak_tflops(device_kind, int8_fraction)
    bw = hbm_gb_s(device_kind)
    if peak is None or bw is None:
        return None
    return peak * 1e12 / (bw * 1e9)


def vit_forward_flops(*, img_size=(64, 64), patch_size=8, embed_dim=384,
                      depth=7, num_heads=12, mlp_ratio=1.0, in_chans=3) -> float:
    """Matmul FLOPs (2·MACs) for one image's forward pass.

    Per block (dim D, tokens N): qkv 3·N·D², attn scores+values 2·N²·D,
    proj N·D², MLP 2·N·D²·mlp_ratio. Plus patch-embed N·P²·C·D in and the
    head's N·D·P²·C out (ViT.py:158-218 structure).
    """
    H, W = img_size
    n = (H // patch_size) * (W // patch_size) + 1  # +1 cls token
    d = embed_dim
    per_block = 3 * n * d * d + 2 * n * n * d + n * d * d + 2 * n * d * d * mlp_ratio
    patch = n * (patch_size * patch_size * in_chans) * d  # embed + head are
    return 2.0 * (depth * per_block + 2 * patch)          # the same GEMM shape


def vit_trunk_gemm_fraction(*, img_size=(64, 64), patch_size=8, embed_dim=384,
                            depth=7, num_heads=12, mlp_ratio=1.0,
                            in_chans=3) -> float:
    """Fraction of the forward's matmul FLOPs in the quantized trunk denses
    (qkv + proj + MLP; attention score/value GEMMs and patch/head stay
    bf16) — the ``int8_fraction`` a w8a8 forward feeds ``mfu``."""
    H, W = img_size
    n = (H // patch_size) * (W // patch_size) + 1
    d = embed_dim
    dense = depth * (3 * n * d * d + n * d * d + 2 * n * d * d * mlp_ratio)
    attn = depth * 2 * n * n * d
    patch = 2 * n * (patch_size * patch_size * in_chans) * d
    return dense / (dense + attn + patch)


def train_step_flops(batch: int, **model_kwargs) -> float:
    """fwd + bwd ≈ 3× forward (grads w.r.t. inputs and weights each cost one
    forward's worth of matmuls)."""
    return 3.0 * batch * vit_forward_flops(**model_kwargs)


def mfu(flops_per_step: float, step_seconds: float, device_kind: str,
        n_devices: int = 1, int8_fraction: float = 0.0) -> float | None:
    """``int8_fraction`` > 0 charges that share of the FLOPs at the card's
    int8 peak (w8a8 trunks, ops/quant.py) — the denominator grows, so a
    quantized run's MFU stays honest instead of flattering."""
    peak = mixed_peak_tflops(device_kind, int8_fraction)
    if peak is None or step_seconds <= 0:
        return None
    return flops_per_step / (step_seconds * peak * 1e12 * n_devices)


def vit_scope_costs(*, img_size=(64, 64), patch_size=8, embed_dim=384,
                    depth=7, num_heads=12, mlp_ratio=1.0, in_chans=3,
                    flash=False, quant=False, fused=False) -> dict:
    """FLOP + device-memory-byte estimates for ONE image's forward pass,
    split by the named scopes ``utils/profiling.scope`` plants
    (``obs/attrib.py`` joins these against per-scope device time → achieved
    TFLOP/s, MFU, roofline class).

    Each entry is the scope's INCLUSIVE cost — ``sampler/model`` carries the
    whole forward, matching attribution's rollup time (an event inside
    ``flash_attention/fwd`` counts toward both). Byte estimates are the
    minimal memory traffic: weights once per call, activations read+written
    at layer boundaries, and — for the flash path — q/k/v/out streamed
    without materializing the N² score matrix. Elementwise traffic rides
    along with the GEMMs it fuses into, same convention as the FLOP side.
    The conventions are the JAX package's: bf16 activations, int8 trunk
    weights under ``quant``.

    ``fused=True`` models the fused trunk (models/vit.py ``fused``): the
    attention scope becomes ``flash_attention/fused_qkv`` (the one
    ``csrc/fused_trunk.cu`` launch carrying the qkv dequant-GEMM, online
    softmax and proj GEMM; the qkv/context activations never touch device
    memory, so its byte estimate is x in twice + out once + weights), and
    the Mlp scope becomes ``mlp/pallas`` (``csrc/mlp_fused.cu``, the hidden
    activation on chip). ``flash_attention/fwd`` and
    ``dequant_matmul/pallas`` never fire in a fused-quant forward and are
    omitted; fused without quant keeps the plain flash scope.

    One difference from the JAX costs: the port has no
    ``flash_attention/fused_proj`` entry. The JAX kernel writes f32 and
    casts to the compute dtype under that scope; ``fused_trunk.cu`` writes
    the compute dtype itself (``ops/flash_attention.fused_trunk_attention``),
    so the scope has no device work and no site in the port.
    """
    H, W = img_size
    n = (H // patch_size) * (W // patch_size) + 1
    d = embed_dim
    act_b = 2  # bf16 activations
    w_b = 1 if quant else 2  # int8 trunk weights under quant
    attn_flops = 2.0 * depth * 2 * n * n * d
    qkv_proj_flops = 2.0 * depth * (3 * n * d * d + n * d * d)
    mlp_flops = 2.0 * depth * 2 * n * d * d * mlp_ratio
    dense_flops = qkv_proj_flops + mlp_flops
    patch_flops = 2.0 * 2 * n * (patch_size * patch_size * in_chans) * d
    # bytes: flash attention streams q, k, v in and the context out once per
    # layer; trunk denses read their weights plus in/out activations for the
    # qkv, proj and two MLP GEMMs; patch/head move the pixel-space tensors
    # and their (shared-shape) weight once each.
    attn_bytes = float(depth * 4 * n * d * act_b)
    dense_bytes = float(depth * ((4 + 2 * mlp_ratio) * d * d * w_b
                                 + 8 * n * d * act_b))
    patch_bytes = float(2 * n * (patch_size * patch_size * in_chans) * act_b
                        + 2 * (patch_size * patch_size * in_chans) * d * 2)
    costs = {"sampler/model": {
        "flops": attn_flops + dense_flops + patch_flops,
        "bytes": attn_bytes + dense_bytes + patch_bytes}}
    if fused:
        costs["mlp/pallas"] = {
            "flops": mlp_flops,
            "bytes": float(depth * (2 * mlp_ratio * d * d * w_b
                                    + 2 * n * d * act_b))}
        if quant:
            costs["flash_attention/fused_qkv"] = {
                "flops": attn_flops + qkv_proj_flops,
                "bytes": float(depth * (4 * d * d * w_b
                                        + 3 * n * d * act_b))}
        elif flash:
            costs["flash_attention/fwd"] = {"flops": attn_flops,
                                            "bytes": attn_bytes}
        return costs
    if flash:
        costs["flash_attention/fwd"] = {"flops": attn_flops,
                                        "bytes": attn_bytes}
    if quant:
        costs["dequant_matmul/pallas"] = {"flops": dense_flops,
                                          "bytes": dense_bytes}
    return costs
