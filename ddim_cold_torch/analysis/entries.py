"""The analysis's registries: the serve sweep and the kernel entries.

Counterpart of ``ddim_cold_tpu/analysis/entries.py``, its host half. Nothing
here traces: :func:`serve_sweep` only constructs configs (the witness set
X001 reads, which the trace half of the analysis will trace, ROADMAP Queue
1 item 19), and :func:`kernel_entries` registers each hand-written kernel's
call at the geometries the P layer proves — the main path's at the 200 px
north star, and a small one of the kernel tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: the stride the serve sweep warms (tests/test_serve.py's 4-reverse-step K)
K = 500

#: the warmed (SamplerConfig, buckets) sweep — JAX's entries, in order. They
#: differ STRUCTURALLY (trip count, function identity, quant, sequence flag,
#: shapes): two t_starts with the same step count are one program by design.
def serve_sweep(world: int = 1):
    """The warmed ``(label, SamplerConfig, buckets)`` witness set (JAX
    ``entries.serve_sweep``, entry for entry). It only constructs configs:
    X001 reads it as the lattice's witnesses, and the trace half of the
    analysis (ROADMAP Queue 1 item 19) will trace it. ``world`` is the number
    of ranks an engine spans (the port serves ``sp_degree > 1`` only on a
    mesh of ranks): JAX gates its sequence-parallel entries on the process's
    device count, the port on ``world``; the CLI runs at one."""
    from ddim_cold_torch.serve.batching import SamplerConfig

    # Bucket policy: the bucket axis enters every program the same way (a
    # batch-dim substitution), so two-bucket stability/distinctness is
    # proven by ONE (4, 8) witness per scan family — ddim, cold, inpaint,
    # the sequence variant, fewstep (plus the warmed pairs tests pin).
    # Every other entry traces at (4,) only: each extra bucket is a full
    # extra trace in BOTH J006 worlds, and the single-bucket entries'
    # program structure is already bucket-proven by their family witness.
    sweep = [
        ("ddim_k500", SamplerConfig(k=K), (4, 8)),
        ("ddim_k500_ci2", SamplerConfig(k=K, cache_interval=2), (4,)),
        # cache_mode="full" (whole-trunk reuse steps) had NO sweep entry
        # until the X001 sweep-completeness rule flagged it: a legal,
        # serveable mode with zero J006 coverage
        ("ddim_k500_ci2_full",
         SamplerConfig(k=K, cache_interval=2, cache_mode="full"), (4,)),
        # adaptive/token caching. ONE adaptive threshold value in
        # the whole sweep: signature_hash is constant-blind, so a second
        # threshold would collide by design. Distinct token_k values ARE
        # structurally distinct (the gathered (B, k, E) aval differs).
        ("ddim_k500_adapt",
         SamplerConfig(k=K, cache_interval=2, cache_mode="adaptive",
                       cache_threshold=0.05), (4,)),
        ("ddim_k500_adapt_qxla",
         SamplerConfig(k=K, cache_interval=2, cache_mode="adaptive",
                       cache_threshold=0.05, quant="xla"), (4,)),
        # device-telemetry variants: same cached samplers with a
        # per-step (branch, drift) aux — the extra scan outputs make them
        # structurally distinct from their plain counterparts
        ("ddim_k500_ci2_tel",
         SamplerConfig(k=K, cache_interval=2, telemetry=True), (4,)),
        ("ddim_k500_adapt_tel",
         SamplerConfig(k=K, cache_interval=2, cache_mode="adaptive",
                       cache_threshold=0.05, telemetry=True), (4,)),
        ("ddim_k500_tok3",
         SamplerConfig(k=K, cache_interval=2, cache_mode="token",
                       cache_tokens=3), (4,)),
        ("ddim_k500_tok2",
         SamplerConfig(k=K, cache_interval=2, cache_mode="token",
                       cache_tokens=2), (4,)),
        ("cold_l4_adapt",
         SamplerConfig(sampler="cold", levels=4, cache_interval=2,
                       cache_mode="adaptive", cache_threshold=0.05), (4,)),
        ("inpaint_k500_ci2",
         SamplerConfig(task="inpaint", k=K, cache_interval=2), (4,)),
        ("inpaint_k500_tok3",
         SamplerConfig(task="inpaint", k=K, cache_interval=2,
                       cache_mode="token", cache_tokens=3), (4,)),
        ("cold_l4", SamplerConfig(sampler="cold", levels=4), (4, 8)),
        ("ddim_k500_t999", SamplerConfig(k=K, t_start=999), (4,)),
        ("ddim_k500_qxla", SamplerConfig(k=K, quant="xla"), (4,)),
        # editing workloads (ddim_cold_tpu/workloads) + preview variants:
        # trip counts at K=500/T=2000 — t=None→4, t1200→3, t999→2, t400→1
        ("ddim_k500_pv2", SamplerConfig(k=K, preview_every=2), (4, 8)),
        ("ddim_k500_ci2_pv2",
         SamplerConfig(k=K, cache_interval=2, preview_every=2), (4,)),
        ("inpaint_k500", SamplerConfig(task="inpaint", k=K), (4, 8)),
        ("inpaint_k500_qxla",
         SamplerConfig(task="inpaint", k=K, quant="xla"), (4,)),
        ("inpaint_k500_pv2",
         SamplerConfig(task="inpaint", k=K, preview_every=2), (4,)),
        ("inpaint_k500_ci2_pv2",
         SamplerConfig(task="inpaint", k=K, cache_interval=2,
                       preview_every=2), (4,)),
        ("superres_l3",
         SamplerConfig(task="superres", sampler="cold", levels=3), (4,)),
        ("superres_l3_ci2",
         SamplerConfig(task="superres", sampler="cold", levels=3,
                       cache_interval=2), (4,)),
        # cached+preview crossings (X001): each scan family's cached
        # SEQUENCE variant is a distinct program (_*_cached_seq) the sweep
        # previously never traced — cold here, inpaint and fewstep below
        ("superres_l3_ci2_pv1",
         SamplerConfig(task="superres", sampler="cold", levels=3,
                       cache_interval=2, preview_every=1), (4,)),
        ("superres_l3_pv1",
         SamplerConfig(task="superres", sampler="cold", levels=3,
                       preview_every=1), (4,)),
        ("draft_k500_t1200",
         SamplerConfig(task="draft", k=K, t_start=1200), (4,)),
        ("draft_k500_t1200_ci2",
         SamplerConfig(task="draft", k=K, t_start=1200, cache_interval=2),
         (4,)),
        ("interp_k500_t400",
         SamplerConfig(task="interp", k=K, t_start=400), (4,)),
        # few-step distilled family: scan over steps-1 schedule
        # updates + the final jump-to-clean forward OUTSIDE the scan, so
        # steps=1 lowers scan-free and every k is structurally distinct
        # from the stride family's equal-trip-count scans. NO student
        # variants here: a student config runs the teacher's program on
        # different params (warmup dedup relies on exactly that), so a
        # student entry would be a deliberate J006 collision.
        ("ddim_fs1", SamplerConfig(steps=1), (4, 8)),
        ("ddim_fs2", SamplerConfig(steps=2), (4,)),
        ("ddim_fs4", SamplerConfig(steps=4), (4,)),
        ("ddim_fs4_ci2", SamplerConfig(steps=4, cache_interval=2), (4,)),
        ("ddim_fs4_ci2_pv1",
         SamplerConfig(steps=4, cache_interval=2, preview_every=1), (4,)),
        ("ddim_fs2_pv1", SamplerConfig(steps=2, preview_every=1), (4,)),
        ("ddim_fs1_qxla", SamplerConfig(steps=1, quant="xla"), (4,)),
    ]
    # sequence-parallel program family (sp_mode/sp_degree — the engine's
    # (data, seq)-mesh programs), gated on the ranks a mesh spans
    if world >= 2 and world % 2 == 0:
        sweep += [
            # ulysses vs ring at the same geometry are distinct programs
            # (the all_to_all pair vs the ring's rotation)
            ("ddim_k500_sp2u",
             SamplerConfig(k=K, sp_mode="ulysses", sp_degree=2), (4, 8)),
            ("ddim_k500_sp2r",
             SamplerConfig(k=K, sp_mode="ring", sp_degree=2), (4,)),
            # static (non-adaptive) caching composes with sp — the carry
            # rides the same (data, seq) mesh
            ("ddim_k500_ci2_sp2u",
             SamplerConfig(k=K, cache_interval=2, sp_mode="ulysses",
                           sp_degree=2), (4,)),
        ]
    if world >= 8 and world % 8 == 0:
        # TINY's 4 heads do not divide a seq axis of 8: this entry is the
        # ulysses→ring fallback at the all-local geometry — distinct from
        # sp2r because the mesh differs
        sweep.append(
            ("ddim_k500_sp8u_fallback",
             SamplerConfig(k=K, sp_mode="ulysses", sp_degree=8), (8,)))
    return sweep


# ---------------------------------------------------------------------------
# kernel entries — every hand-written kernel's call at a registered geometry
# ---------------------------------------------------------------------------

#: the model whose main path the kernel entries are taken from
NS_MODEL = "oxford_flower_200_p4"
NS_ROWS = 8        # a served batch (the bucket the serve phases dispatch)
NS_TRAIN_ROWS = 16  # a training batch
NS_TOKEN_K = 626   # the token cache's live tokens at 200_p4 (a quarter)

#: kernel → the ``csrc/`` library that holds it
KERNELS = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
           "flash_bwd_dkv": "flash_bwd", "fused_trunk": "fused_trunk",
           "dequant_mm": "dequant_mm", "mlp_fused": "mlp_fused"}


@dataclass(frozen=True)
class KernelEntry:
    """One bfloat16 kernel call at one geometry, as its wrapper receives it.

    ``shape`` holds the wrapper's shape arguments: ``B, N, H, D`` for the
    flash kernels; ``B, N, C, H, block_q, mode`` for ``fused_trunk``;
    ``M, K, N`` for ``dequant_mm`` (a bfloat16 out); ``M, K, hidden, Nout,
    mode, block_m`` for ``mlp_fused`` (modes are the wrappers' strings).
    ``logical`` is the logical extent of the axis the kernel pads — the
    token count N for the attention kernels (2501 at 200 px, 626 in token
    mode), the row count M for the GEMMs — which P003 charges the padded
    extent against; None for a test geometry, whose padding costs no
    serving time (P001 and P002 still apply)."""

    name: str
    kernel: str
    shape: dict = field(hash=False)
    logical: int | None = None

    @property
    def path(self) -> str:
        return f"ddim_cold_torch/csrc/{KERNELS[self.kernel]}.cu"


def kernel_entries() -> list[KernelEntry]:
    """Every kernel at the main path's geometry (200_p4, bfloat16): the
    flash forward as served (B=8), trained (B=16) and in token mode (626
    live tokens); the backward pair as trained; the fused trunk attention
    in w8a16 and w8a8 at the block the model picks (``tuning.attn_blocks``);
    the dequant matmul at the qkv (C → 3C) and proj (C → C) shapes over the
    B·N rows of a served batch; the fused Mlp float, w8a16 and w8a8 at the
    block the model picks (``tuning.mlp_block_m``). Then one small entry per
    kernel, the smallest shape the card's kernel tests run it at
    (``tests/test_torch_port_kernels.py``): the CPU tests' TINY model (head
    dim 8) reaches no kernel, whose head dims are 32 and 64."""
    import torch

    from ddim_cold_torch.models.vit import MODEL_CONFIGS
    from ddim_cold_torch.ops import tuning

    cfg = MODEL_CONFIGS[NS_MODEL]
    n = (cfg["img_size"][0] // cfg["patch_size"]) \
        * (cfg["img_size"][1] // cfg["patch_size"]) + 1
    c, h = cfg["embed_dim"], cfg["num_heads"]
    hidden = int(c * cfg.get("mlp_ratio", 1.0))
    d, m = c // h, NS_ROWS * n
    entries = [
        KernelEntry("flash200_fwd_serve", "flash_fwd", dict(B=NS_ROWS, N=n, H=h, D=d), n),
        KernelEntry("flash200_fwd_train", "flash_fwd", dict(B=NS_TRAIN_ROWS, N=n, H=h, D=d), n),
        KernelEntry("flash200_fwd_token", "flash_fwd",
                    dict(B=NS_ROWS, N=NS_TOKEN_K, H=h, D=d), NS_TOKEN_K),
        KernelEntry("flash200_bwd_dq", "flash_bwd_dq", dict(B=NS_TRAIN_ROWS, N=n, H=h, D=d), n),
        KernelEntry("flash200_bwd_dkv", "flash_bwd_dkv",
                    dict(B=NS_TRAIN_ROWS, N=n, H=h, D=d), n),
    ]
    for mode, act in (("pallas", torch.bfloat16), ("w8a8", torch.int8)):
        block_q = tuning.attn_blocks(n, c, h, act, device_kind=tuning.DEVICE_KIND)[0]
        entries.append(KernelEntry(
            f"fused200_{'w8a16' if mode == 'pallas' else mode}", "fused_trunk",
            dict(B=NS_ROWS, N=n, C=c, H=h, block_q=block_q, mode=mode), n))
    for label, nout in (("qkv", 3 * c), ("proj", c)):
        entries.append(KernelEntry(f"dequant200_{label}", "dequant_mm",
                                   dict(M=m, K=c, N=nout), m))
    for label, mode in (("float", None), ("w8a16", "pallas"), ("w8a8", "w8a8")):
        block_m = tuning.mlp_block_m(c, hidden, torch.int8 if mode == "w8a8" else torch.bfloat16,
                                     quant=mode is not None, device_kind=tuning.DEVICE_KIND)
        entries.append(KernelEntry(
            f"mlp200_{label}", "mlp_fused",
            dict(M=m, K=c, hidden=hidden, Nout=c, mode=mode, block_m=block_m), m))
    small = dict(B=2, N=129, H=2, D=32)
    entries += [
        KernelEntry("flash_small_fwd", "flash_fwd", small),
        KernelEntry("flash_small_bwd_dq", "flash_bwd_dq", small),
        KernelEntry("flash_small_bwd_dkv", "flash_bwd_dkv", small),
        KernelEntry("fused_small_w8a16", "fused_trunk",
                    dict(B=1, N=300, C=64, H=2, block_q=128, mode="pallas")),
        KernelEntry("dequant_small", "dequant_mm", dict(M=7, K=33, N=50)),
        KernelEntry("mlp_small_w8a16", "mlp_fused",
                    dict(M=300, K=64, hidden=64, Nout=64, mode="pallas", block_m=256)),
    ]
    return entries
