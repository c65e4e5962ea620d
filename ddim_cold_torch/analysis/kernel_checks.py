"""GRAFT-P001..P003 — Hopper kernel-geometry verification (layer P).

Counterpart of ``ddim_cold_tpu/analysis/kernel_checks.py``, rewritten for the
port's hand-written sm_90a kernels. JAX's layer walks every ``pallas_call``
of its traces and re-derives Mosaic legality from the raw block geometry;
nothing in the port traces, so this layer predicts each kernel's launch at
every geometry :func:`.entries.kernel_entries` registers, from its own
table of the kernels' constants, and checks the prediction against Hopper's
rules. It keeps JAX's stance: the table is a copy, deliberately NOT read
from ``csrc/`` or from ``ops/tuning``, so a regression in the launch code is
caught, not trusted. Tests hold the table against the sources' wgmma
instructions and its shared-memory arithmetic against ``ops/tuning``'s; on
the card, ``chip_smoke.py``'s ``analysis`` phase holds each prediction
against the library's own launch-config query (``csrc/launch_query.cuh``:
the launcher computes its launch through the same C function) and reads
the built kernel's attributes.

What the kernel's launch path decides in Python (the fused attention's
padded rows and w8a8 group, the fused Mlp's requant block and cluster, the
dequant matmul's padded K) is taken from that Python
(``flash_attention.fused_geometry``, ``quant.w8a8_block_m``,
``quant.mlp_geometry``, ``quant.bf16_row_layout``), as the wrapper passes it.
The layer models the bfloat16 kernels, the main path's; the float32 ones are
the exact oracle route, run by the kernel tests only.

**P001 — tile and launch legality.** Each wgmma instruction a warpgroup
runs: M a multiple of 64, N a multiple of 8 and at most 256, K the
instruction's 16 (bf16) or 32 (int8) and the reduction it steps over a
multiple of it; threads a multiple of 128 (a warpgroup) and at most 1,024;
grid x at most 2³¹−1, y and z at most 65,535, every entry a Python ``int``
(JAX's ``np.int64`` lesson: a numpy or tensor integer from block arithmetic
is a value the launch code never meant to pass); every row the kernel
copies asynchronously (cp.async, 16-byte pieces) 16-byte aligned; every
padded extent a whole number of the kernel's tile that covers the logical
extent.

**P002 — fit.** Static plus dynamic shared memory at most
``utils/flops.smem_bytes(kind)`` (232,448 B on an H100). With the card's
``cudaFuncGetAttributes`` (``attrs``): registers at most 255 a thread,
registers × threads at most 65,536, no spill (``localSizeBytes`` 0), the
threads within the kernel's ``maxThreadsPerBlock``, and at least one block
resident on an SM.

**P003 — padding waste.** ``padded / logical`` over each padded axis of an
entry that registers its logical extent (2,501 tokens at 200 px, 626 live
tokens in token mode, the 20,008 rows of a served batch), with JAX's
threshold 1.25. The tile read is the one the kernel computes over: the
nominal ``NS_FLASH_BLOCKS`` key block of 4,096 reaches no card kernel (the
fused attention streams 128-key slices whatever ``block_kv`` says), so it
pads nothing; a kernel that did pad 2,501 keys to 4,096 would waste 64%.
"""

from __future__ import annotations

from dataclasses import dataclass

from ddim_cold_torch.analysis.findings import Finding

#: the card the static budgets default to
DEVICE_KIND = "NVIDIA H100 80GB HBM3"

# --- Hopper (sm_90) limits ---------------------------------------------------
WARPGROUP = 128             # threads of one warpgroup (four warps)
MAX_THREADS = 1024          # threads a block
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65_535
REGS_PER_BLOCK = 65_536     # 32-bit registers one block may hold
MAX_REGS = 255              # registers a thread
SM_SMEM_BYTES = 233_472     # shared memory of one SM (228 KiB)
BLOCK_SMEM_RESERVED = 1024  # the runtime's share of each resident block
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2048
ASYNC_ALIGN = 16            # bytes of one cp.async piece
#: SMs of an H100 SXM: the persistent dequant grid's default (the card
#: phase passes the card's own count)
SMS = 132

#: wgmma's fixed instruction depth K by operand type, and its M and N rules
WGMMA_K = {"bfloat16": 16, "int8": 32}
WGMMA_M = 64
WGMMA_N_UNIT, WGMMA_N_MAX = 8, 256

#: P003 threshold, JAX's: padded compute over logical compute
WASTE_THRESHOLD = 1.25

# --- the kernels' constants, copied (see the module docstring) --------------
SMEM_SLACK = 1024  # every bf16 kernel aligns its dynamic shared memory to 1 KiB
#: rows of the tiles the attention kernels stream (one warpgroup's M)
ATTN_ROWS = 64
#: the fused attention (fused_trunk.cu): a CTA is two warpgroups of 64 query
#: rows, a cluster 4 CTAs; each CTA projects 128-key slices
FUSED_THREADS, FUSED_ROWS, FUSED_CLUSTER = 256, 128, 4
#: the GEMM mainloop (gemm_wgmma.cuh): 2 warpgroups, 128 rows a CTA, 128
#: output columns a tile, 64 reduction elements a chunk, at most 4 stages
GM_THREADS, GM_ROWS, GM_BN, GM_BK, GM_MAX_STAGES = 256, 128, 128, 64, 4
GM_STAGE_PAD = 8  # columns of padding in a staged output row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Tile:
    """One wgmma instruction shape a warpgroup runs: ``m × n × k`` over
    operands of ``dtype``, stepping over a reduction of ``reduction``."""

    what: str
    m: int
    n: int
    k: int
    dtype: str
    reduction: int


@dataclass(frozen=True)
class Extent:
    """An axis the kernel pads: ``logical`` elements computed as ``padded``,
    in whole tiles of ``tile``."""

    axis: str
    logical: int
    padded: int
    tile: int


@dataclass(frozen=True)
class Launch:
    """The predicted launch of one kernel entry, and what P checks in it.

    ``query`` is ``(library, symbol, args)``: the library's
    ``<symbol>_launch_config`` / ``<symbol>_attributes`` arguments for the
    same call. ``function`` is ``(name, template marker)``: the kernel
    function's name and the mark its template arguments leave in the
    mangled name (``cuobjdump`` lists), or ``""``."""

    entry: str
    path: str
    grid: tuple
    threads: int
    smem: int
    cluster: int
    tiles: tuple = ()
    async_rows: tuple = ()   # ((operand, bytes), ...)
    extents: tuple = ()
    query: tuple = ()
    function: tuple = ("", "")

    def as_config(self) -> dict:
        """The launch in the query's terms."""
        return {"grid": list(self.grid), "threads": self.threads,
                "smem": self.smem, "cluster": self.cluster}


def smem_budget(device_kind: str = DEVICE_KIND) -> int:
    """Shared bytes one block may take (``utils/flops.smem_bytes``); an H100's
    where the device kind is unknown."""
    from ddim_cold_torch.utils import flops

    return flops.smem_bytes(device_kind) or flops.smem_bytes(DEVICE_KIND)


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` dynamic shared bytes one SM
    holds by shared memory and threads (registers are the card's to say)."""
    return max(0, min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads,
                      SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED)))


# ---------------------------------------------------------------------------
# shared memory of each bf16 kernel, in bytes
# ---------------------------------------------------------------------------

def flash_fwd_smem(D: int) -> int:
    """flash_fwd: the Q tile and two stages of K and V, 64 rows of 2·D
    bytes each."""
    return SMEM_SLACK + 5 * ATTN_ROWS * 2 * D


def flash_bwd_smem(D: int, which: str) -> int:
    """flash_bwd: six 64-row tiles (the owned rows' two, two stages of the
    streamed pair); dk/dv adds two stages of the streamed lse and δ."""
    base = SMEM_SLACK + 6 * ATTN_ROWS * 2 * D
    return base if which == "dq" else base + 2 * 2 * ATTN_ROWS * 4


def fused_smem(C: int, H: int, mode: str) -> int:
    """fused_trunk: q/context tiles of a CTA's rows, the weight rows of one
    head's q (or k|v, or a 64-row chunk of Wp) in 64-column chunks, the x
    ring of two stages, the own and the consumed k|v slices, the w8a8
    context codes and the amaxes. ``mode`` 'pallas' is w8a16."""
    D = C // H
    row = 64 if mode == "w8a8" else 128  # bytes of a 64-column chunk row
    return (SMEM_SLACK + 2 * FUSED_ROWS * C + (C // 64) * max(2 * D, 64) * row
            + 2 * FUSED_ROWS * row + 2 * 4 * ATTN_ROWS * 2 * D
            + (FUSED_ROWS * C if mode == "w8a8" else 0) + 64)


#: both warpgroups' staged 64 × 128 bfloat16 output tiles
GM_STAGE_BYTES = 2 * ATTN_ROWS * (GM_BN + GM_STAGE_PAD) * 2


def dequant_smem(N: int, Kp: int, budget: int) -> int:
    """dequant_mm (a bfloat16 out): a CTA's 128 x rows whole, a two-stage
    ring of widened code chunks, the staged output, and the scale and bias
    vectors when they fit the budget."""
    base = (SMEM_SLACK + _cdiv(Kp, GM_BK) * GM_ROWS * 128 + 2 * GM_BN * 128
            + GM_STAGE_BYTES)
    return base + 8 * N if base + 8 * N <= budget else base


def _mlp_total(K: int, hidden: int, nout: int, mode, stages: int, vec: bool) -> int:
    row = 64 if mode == "w8a8" else 128
    x = _cdiv(K, GM_BK) * GM_ROWS * row
    h = _cdiv(hidden, GM_BK) * GM_ROWS * 128
    if mode == "w8a8":  # the x codes' buffer takes the hidden codes later
        x, h = max(x, _cdiv(hidden, GM_BK) * GM_ROWS * 64), max(h, GM_STAGE_BYTES)
    else:
        x = max(x, GM_STAGE_BYTES)
    ring = (2 if mode == "pallas" else stages) * GM_BN * row
    return SMEM_SLACK + x + h + ring + 64 + (8 * (hidden + nout) if vec else 0)


def mlp_smem(K: int, hidden: int, nout: int, mode, budget: int) -> int:
    """mlp_fused: a CTA's x and hidden rows, the weight ring at its deepest
    stage count that fits beside the four vectors, else two stages and the
    vectors read from device memory (w8a16 always has two stages)."""
    for stages in range(2 if mode == "pallas" else GM_MAX_STAGES, 1, -1):
        total = _mlp_total(K, hidden, nout, mode, stages, True)
        if total <= budget:
            return total
    return _mlp_total(K, hidden, nout, mode, 2, False)


# ---------------------------------------------------------------------------
# the launch of each kernel entry
# ---------------------------------------------------------------------------

def _flash_tiles(D: int, backward: bool) -> tuple:
    bf = "bfloat16"
    if not backward:
        return (Tile("S=QK^T", WGMMA_M, ATTN_ROWS, 16, bf, D),
                Tile("O+=PV", WGMMA_M, D, 16, bf, ATTN_ROWS))
    return (Tile("S=QK^T", WGMMA_M, ATTN_ROWS, 16, bf, D),
            Tile("dP=dO.V^T", WGMMA_M, ATTN_ROWS, 16, bf, D),
            Tile("grad+=dS.X", WGMMA_M, D, 16, bf, ATTN_ROWS))


def _predict_flash(entry, s, budget, sms) -> Launch:
    B, N, H, D = s["B"], s["N"], s["H"], s["D"]
    kind = entry.kernel
    which = {"flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}.get(kind)
    grid = (_cdiv(N, ATTN_ROWS), B * H, 1)
    smem = flash_fwd_smem(D) if which is None else flash_bwd_smem(D, which)
    if which is None:
        query = ("flash_fwd", "flash_fwd", (B, N, H, D, 1))
        function = ("flash_fwd_bf16_wgmma", f"ILi{D}E")
    else:
        query = ("flash_bwd", "flash_bwd", (1 if which == "dq" else 2, B, N, H, D, 1))
        function = (f"flash_bwd_{which}_bf16_wgmma", f"ILi{D}E")
    rows = _cdiv(N, ATTN_ROWS) * ATTN_ROWS
    return Launch(
        entry.name, entry.path, grid, WARPGROUP, smem, 1,
        tiles=_flash_tiles(D, which is not None),
        # rows of q, k, v (and dO and the gradients) move in 16-byte pieces;
        # the model passes q, k, v as slices of its (B, N, 3, H, D) qkv
        async_rows=(("row", 2 * D), ("qkv token stride", 3 * H * D * 2)),
        extents=(Extent("queries", N, grid[0] * ATTN_ROWS, ATTN_ROWS),
                 Extent("keys", N, rows, ATTN_ROWS)),
        query=query, function=function)


def _predict_fused(entry, s, budget, sms) -> Launch:
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.ops import quant

    B, N, C, H, mode = s["B"], s["N"], s["C"], s["H"], s["mode"]
    D = C // H
    geom = fa.fused_geometry(B, N, C, H, s["block_q"], mode)
    kd = "int8" if mode == "w8a8" else "bfloat16"
    bf = "bfloat16"
    grid = (geom.rows // FUSED_ROWS, B, 1)
    tiles = (Tile("q=xWq", WGMMA_M, D, WGMMA_K[kd], kd, C),
             Tile("kv=xWkv", WGMMA_M, 2 * D, WGMMA_K[kd], kd, C),
             Tile("S=QK^T", WGMMA_M, ATTN_ROWS, 16, bf, D),
             Tile("O+=PV", WGMMA_M, D, 16, bf, ATTN_ROWS),
             Tile("y=ctx.Wp", WGMMA_M, 64, WGMMA_K[kd], kd, C))
    x_row = C * (1 if mode == "w8a8" else 2)
    return Launch(
        entry.name, entry.path, grid, FUSED_THREADS, fused_smem(C, H, mode), FUSED_CLUSTER,
        tiles=tiles, async_rows=(("x row", x_row), ("weight row", C)),
        extents=(Extent("queries", N, geom.rows, FUSED_ROWS * FUSED_CLUSTER),
                 *((Extent("requant tiles", N, geom.rows, ATTN_ROWS * geom.group),)
                   if mode == "w8a8" else ()),
                 Extent("keys", N, _cdiv(N, FUSED_ROWS) * FUSED_ROWS, FUSED_ROWS)),
        query=("fused_trunk", "fused_trunk",
               (B, N, H, D, geom.rows, geom.group, 1, quant.QUANT_MODES.index(mode))),
        function=(f"fused_trunk_{'w8a8' if mode == 'w8a8' else 'w8a16'}_bf16", f"ILi{D}E"))


def _predict_dequant(entry, s, budget, sms) -> Launch:
    from ddim_cold_torch.ops import quant

    M, K, N = s["M"], s["K"], s["N"]
    Kp, _ = quant.bf16_row_layout(K, K, 0)  # the wrapper's zero-padded K
    smem = dequant_smem(N, Kp, budget)
    items = _cdiv(M, GM_ROWS) * _cdiv(N, GM_BN)
    slots = max(1, blocks_per_sm(smem, GM_THREADS)) * sms
    return Launch(
        entry.name, entry.path, (min(items, slots), 1, 1), GM_THREADS, smem, 1,
        tiles=(Tile("y=x.W^T", WGMMA_M, GM_BN, 16, "bfloat16", Kp),),
        async_rows=(("x row", 2 * Kp), ("code row", Kp)),
        extents=(Extent("rows", M, _cdiv(M, GM_ROWS) * GM_ROWS, GM_ROWS),
                 Extent("columns", N, _cdiv(N, GM_BN) * GM_BN, GM_BN)),
        query=("dequant_mm", "dequant_mm", (M, N, Kp, 1, 1)),
        function=("dequant_mm_bf16_wgmma", "I13__nv_bfloat16E"))


def _predict_mlp(entry, s, budget, sms) -> Launch:
    from ddim_cold_torch.ops import quant

    M, K, hidden, nout, mode = s["M"], s["K"], s["hidden"], s["Nout"], s["mode"]
    rows, cluster, bm = M, 1, 0
    if mode == "w8a8":
        bm = quant.w8a8_block_m(s["block_m"], M)
        rows, cluster = quant.mlp_geometry(M, bm, GM_ROWS)
    kd = "int8" if mode == "w8a8" else "bfloat16"
    grid = (_cdiv(rows, GM_ROWS), 1, 1)
    w_item = 2 if mode is None else 1
    tiles = (Tile("h=x.W1^T", WGMMA_M, GM_BN, WGMMA_K[kd], kd, K),
             Tile("y=h.W2^T", WGMMA_M, GM_BN, WGMMA_K[kd], kd, hidden))
    name = {None: "float", "pallas": "w8a16", "w8a8": "w8a8"}[mode]
    return Launch(
        entry.name, entry.path, grid, GM_THREADS, mlp_smem(K, hidden, nout, mode, budget),
        cluster, tiles=tiles,
        async_rows=(("x row", K * (1 if mode == "w8a8" else 2)), ("w1 row", K * w_item),
                    ("w2 row", hidden * w_item)),
        # w8a8: the rows cover whole clusters and whole requant tiles
        extents=(Extent("rows", M, rows if mode == "w8a8" else grid[0] * GM_ROWS,
                        GM_ROWS * cluster),
                 *((Extent("requant tiles", M, rows, bm),) if mode == "w8a8" else ()),
                 Extent("hidden", hidden, _cdiv(hidden, GM_BN) * GM_BN, GM_BN),
                 Extent("columns", nout, _cdiv(nout, GM_BN) * GM_BN, GM_BN)),
        query=("mlp_fused", "mlp_fused",
               (M, rows, K, hidden, nout, cluster, bm, 1, quant.MLP_MODES.index(mode))),
        function=(f"mlp_fused_{name}_bf16", ""))


_PREDICT = {"flash_fwd": _predict_flash, "flash_bwd_dq": _predict_flash,
            "flash_bwd_dkv": _predict_flash, "fused_trunk": _predict_fused,
            "dequant_mm": _predict_dequant, "mlp_fused": _predict_mlp}


def predict(entry, *, device_kind: str = DEVICE_KIND, sms: int = SMS) -> Launch:
    """The launch the bfloat16 kernel of ``entry`` makes on a card of
    ``sms`` SMs. Raises ValueError where the launch path's own Python
    refuses the geometry."""
    return _PREDICT[entry.kernel](entry, entry.shape, smem_budget(device_kind), sms)


# ---------------------------------------------------------------------------
# P001 — tile and launch legality
# ---------------------------------------------------------------------------

def check_legality(launch: Launch) -> list[Finding]:
    out: list[Finding] = []

    def hit(what: str, msg: str) -> None:
        out.append(Finding("GRAFT-P001", launch.path, f"{launch.entry}:{what}", 0,
                           f"kernel entry `{launch.entry}`: {msg}"))

    for t in launch.tiles:
        problems = []
        if t.m % WGMMA_M:
            problems.append(f"M {t.m} is not a multiple of {WGMMA_M} (one warpgroup)")
        if t.n % WGMMA_N_UNIT or not WGMMA_N_UNIT <= t.n <= WGMMA_N_MAX:
            problems.append(f"N {t.n} is not a multiple of {WGMMA_N_UNIT} in "
                            f"[{WGMMA_N_UNIT}, {WGMMA_N_MAX}]")
        k = WGMMA_K.get(t.dtype)
        if k is None or t.k != k:
            problems.append(f"K {t.k} is not wgmma's {k} for {t.dtype}")
        elif t.reduction % k:
            problems.append(f"the reduction {t.reduction} is not a multiple of K {k}")
        if problems:
            hit(f"tile:{t.what}", f"wgmma m{t.m}n{t.n}k{t.k} {t.dtype} ({t.what}): "
                + "; ".join(problems))
    if launch.tiles and launch.threads % WARPGROUP:
        hit("threads", f"{launch.threads} threads are not whole warpgroups of "
            f"{WARPGROUP} (a wgmma kernel)")
    if launch.threads > MAX_THREADS or launch.threads < 1:
        hit("threads", f"{launch.threads} threads a block (at most {MAX_THREADS})")
    kinds = [type(g).__name__ for g in launch.grid if type(g) is not int]
    if len(launch.grid) != 3 or kinds:
        hit("grid", f"grid {launch.grid} is not three Python ints ({'/'.join(kinds)}): "
            "a numpy or tensor integer from block arithmetic is a launch value "
            "the launcher never meant to pass; cast every entry to int")
    elif not (1 <= launch.grid[0] <= MAX_GRID_X
              and all(1 <= g <= MAX_GRID_YZ for g in launch.grid[1:])):
        hit("grid", f"grid {launch.grid} is past Hopper's limits (x ≤ {MAX_GRID_X}, "
            f"y and z ≤ {MAX_GRID_YZ}, all ≥ 1)")
    for operand, nbytes in launch.async_rows:
        if nbytes % ASYNC_ALIGN:
            hit(f"async:{operand}", f"{operand} of {nbytes} bytes is copied in "
                f"{ASYNC_ALIGN}-byte cp.async pieces: it must be a multiple of "
                f"{ASYNC_ALIGN} bytes")
    for e in launch.extents:
        if e.padded % e.tile or e.padded < e.logical:
            hit(f"extent:{e.axis}", f"{e.axis}: {e.logical} computed as {e.padded}, "
                f"not whole tiles of {e.tile} covering it")
    return out


# ---------------------------------------------------------------------------
# P002 — shared memory and register fit
# ---------------------------------------------------------------------------

def check_fit(launch: Launch, attrs: dict | None = None, *,
              device_kind: str = DEVICE_KIND,
              budget_bytes: int | None = None) -> list[Finding]:
    """Shared memory against the budget; with the card's attributes
    (``attrs``: ``shared``, ``regs``, ``local``, ``max_threads``,
    ``blocks_per_sm``, as :func:`card_attributes` reads them), registers,
    spills and residency too."""
    if budget_bytes is None:
        budget_bytes = smem_budget(device_kind)
    out: list[Finding] = []

    def hit(what: str, msg: str) -> None:
        out.append(Finding("GRAFT-P002", launch.path, f"{launch.entry}:{what}", 0,
                           f"kernel entry `{launch.entry}`: {msg}"))

    static = 0 if attrs is None else attrs["shared"]  # the bf16 kernels declare none
    if static + launch.smem > budget_bytes:
        hit("smem", f"{static} static + {launch.smem} dynamic shared bytes are over "
            f"the {budget_bytes} B a block may take on {device_kind}")
    if attrs is None:
        return out
    regs = attrs["regs"]
    if regs > MAX_REGS:
        hit("regs", f"{regs} registers a thread (at most {MAX_REGS})")
    if regs * launch.threads > REGS_PER_BLOCK:
        hit("regs", f"{regs} registers × {launch.threads} threads = "
            f"{regs * launch.threads} (at most {REGS_PER_BLOCK} a block)")
    if attrs["local"]:
        hit("spill", f"{attrs['local']} bytes of local memory a thread: registers spill")
    if launch.threads > attrs["max_threads"]:
        hit("threads", f"{launch.threads} threads over the kernel's "
            f"maxThreadsPerBlock {attrs['max_threads']}")
    if attrs["blocks_per_sm"] < 1:
        hit("occupancy", "no block of this launch fits on an SM")
    return out


# ---------------------------------------------------------------------------
# P003 — padding waste
# ---------------------------------------------------------------------------

def check_padding_waste(launch: Launch, logical: int | None, *,
                        threshold: float = WASTE_THRESHOLD) -> list[Finding]:
    """The worst ``padded / logical`` over the launch's padded axes whose
    logical extent is the entry's registered one (``logical``); none for a
    test geometry (``logical`` None), whose padding costs no serving time."""
    if not logical:
        return []
    worst, why = 1.0, ""
    for e in launch.extents:
        if e.logical != logical:
            continue
        ratio = e.padded / e.logical
        if ratio > worst:
            worst, why = ratio, f"{e.axis}: tile {e.tile} pads {e.logical} → {e.padded}"
    if worst <= threshold:
        return []
    return [Finding(
        "GRAFT-P003", launch.path, f"{launch.entry}:pad", 0,
        f"kernel entry `{launch.entry}` wastes {100 * (worst - 1):.0f}% of its "
        f"compute on padding ({why}; threshold {100 * (threshold - 1):.0f}%) — "
        "pick a tile that divides the extent more tightly")]


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def check_entry(entry, launch: Launch | None = None, attrs: dict | None = None, *,
                device_kind: str = DEVICE_KIND) -> list[Finding]:
    """P001 + P002 + P003 at one entry. A geometry the launch path's own
    Python refuses is a P001 finding."""
    if launch is None:
        try:
            launch = predict(entry, device_kind=device_kind)
        except ValueError as e:
            return [Finding("GRAFT-P001", entry.path, f"{entry.name}:refused", 0,
                            f"kernel entry `{entry.name}`: the launch path refuses "
                            f"its geometry: {e}")]
    return (check_legality(launch)
            + check_fit(launch, attrs, device_kind=device_kind)
            + check_padding_waste(launch, entry.logical))


def run_kernel_checks(entries=None, device_kind: str = DEVICE_KIND) -> list[Finding]:
    """The kernels layer: every registered entry (``entries.kernel_entries``
    by default), with no card."""
    if entries is None:
        from ddim_cold_torch.analysis.entries import kernel_entries

        entries = kernel_entries()
    out: list[Finding] = []
    for entry in entries:
        out += check_entry(entry, device_kind=device_kind)
    return out


# ---------------------------------------------------------------------------
# on the card: the library's own answers
# ---------------------------------------------------------------------------

def _card_call(launch: Launch, what: str) -> list[int]:
    import ctypes

    from ddim_cold_torch.ops import _build

    library, symbol, args = launch.query
    out = (ctypes.c_longlong * 6)()
    err = getattr(_build.load_library(library), f"{symbol}_{what}")(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}_{what}{args} failed: cudaError_t {err}")
    return list(out)


def card_launch_config(launch: Launch) -> dict:
    """The launch the library makes for the same call
    (``<symbol>_launch_config``), in :meth:`Launch.as_config`'s terms."""
    gx, gy, gz, threads, smem, cluster = _card_call(launch, "launch_config")
    return {"grid": [gx, gy, gz], "threads": threads, "smem": smem, "cluster": cluster}


def card_attributes(launch: Launch) -> dict:
    """``cudaFuncGetAttributes`` of the kernel the same call launches, and
    the blocks of it an SM holds at that launch (``<symbol>_attributes``)."""
    shared, max_dyn, regs, local, max_threads, per_sm = _card_call(launch, "attributes")
    return {"shared": shared, "max_dynamic": max_dyn, "regs": regs, "local": local,
            "max_threads": max_threads, "blocks_per_sm": per_sm}


def sass_function(launch: Launch, names) -> str | None:
    """The one ``cuobjdump`` function name (mangled) of ``names`` that is
    this launch's kernel, else None."""
    base, mark = launch.function
    hits = [n for n in names if base in n and mark in n]
    return hits[0] if len(hits) == 1 else None
