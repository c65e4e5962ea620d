"""The port's block tuning (``ddim_cold_torch/ops/tuning.py``) against the
JAX package's ``ddim_cold_tpu/ops/tuning.py``, on the CPU.

* Geometry tags and ``lookup`` (longest device-kind prefix, dtype and tag
  exact) are JAX's: the same rows monkeypatched into both tables answer
  every query alike. Without a row both fall back to JAX's
  ``NS_FLASH_BLOCKS`` and 256, on ``"cpu"`` and on a card's kind.
* The candidate spaces are the card kernels' own: every candidate passes
  the kernel's geometry check and is a fixed point of ``legal_block``; in
  w8a8 the fused attention takes 64–512 rows and the fused Mlp 32–256, in
  every other mode the one fixed tile; the shared-memory model reproduces
  the footprints the kernels were measured at. The static picks at 200_p4
  and 200_p8 are the model's defaults, 512 and 256, and the table holds no
  row.
* The wiring: with one row for a 32 px w8a8 geometry (N = 65 tokens, M =
  130 rows) in both tables and both device kinds forced to one string, the
  port's fused forward equals JAX's at that non-default block (rtol 2e-4,
  atol 2e-5, ``tests/test_torch_port_fused.py``'s limit) and lies outside
  that limit of the forward at the fallback blocks: the block reached both
  models.
* The sweeps refuse the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import MODEL_CONFIGS
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.ops import flash_attention as pfa
from ddim_cold_torch.ops import quant as pq
from ddim_cold_torch.ops import tiling as ptiling
from ddim_cold_torch.ops import tuning as ptuning
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT as JaxViT
from ddim_cold_tpu.ops import flash_attention as jfa
from ddim_cold_tpu.ops import quant as jq
from ddim_cold_tpu.ops import tuning as jtuning
from ddim_cold_tpu.utils.checkpoint import flax_from_torch_state_dict

H100 = "NVIDIA H100 80GB HBM3"
#: (N, C, heads) of the 200px models: 200_p4, 200_p8
P4, P8 = (2501, 256, 4), (626, 384, 12)
TORCH_OF = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
JAX_OF = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


# ------------------------------------------------------------ tags and lookup

@pytest.mark.parametrize("n,c,h", [P4, P8, (65, 32, 4)])
def test_geometry_tags_are_jaxs(n, c, h):
    assert ptuning.attn_geometry(n, c, h) == jtuning.attn_geometry(n, c, h)
    for q in (True, False):
        assert ptuning.mlp_geometry(c, c, quant=q) == jtuning.mlp_geometry(c, c, quant=q)
    assert (ptuning.dequant_geometry(8 * n, c, 3 * c)
            == jtuning.dequant_geometry(8 * n, c, 3 * c))


ROWS = {("NVIDIA H100", "int8", "attn_n2501_c256_h4"): (256, 128),
        ("NVIDIA H100 80GB", "int8", "attn_n2501_c256_h4"): (128, 128),
        ("NVIDIA H100", "bfloat16", "mlp_c256_h256"): (64,),
        ("cpu", "float32", "mlpf_c32_h32"): (96,)}


def test_lookup_is_jaxs(monkeypatch):
    """The same rows in both tables: every (kind, dtype, geometry) query
    answers alike, the longest matching prefix winning."""
    monkeypatch.setattr(ptuning, "TUNED_BLOCKS", dict(ROWS))
    monkeypatch.setattr(jtuning, "TUNED_BLOCKS", dict(ROWS))
    kinds = ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H10", "cpu", "TPU v5 lite")
    geoms = sorted({g for _, _, g in ROWS} | {"attn_n626_c384_h12"})
    answers = []
    for kind in kinds:
        for name in ("float32", "bfloat16", "int8"):
            for geom in geoms:
                got = ptuning.lookup(kind, TORCH_OF[name], geom)
                assert got == jtuning.lookup(kind, JAX_OF[name], geom), (kind, name, geom)
                answers.append(got)
    assert ptuning.lookup(H100, torch.int8, "attn_n2501_c256_h4") == (128, 128)
    assert ptuning.lookup("NVIDIA H100 PCIe", torch.int8, "attn_n2501_c256_h4") == (256, 128)
    assert sum(a is not None for a in answers) == 5
    # the model's two readers take a row of their own kind alike
    for kind in kinds:
        assert (ptuning.attn_blocks(*P4, torch.int8, device_kind=kind)
                == tuple(jtuning.attn_blocks(*P4, jnp.int8, device_kind=kind)))
        assert (ptuning.mlp_block_m(256, 256, torch.bfloat16, device_kind=kind)
                == jtuning.mlp_block_m(256, 256, jnp.bfloat16, device_kind=kind))
        assert (ptuning.mlp_block_m(32, 32, torch.float32, quant=False, device_kind=kind)
                == jtuning.mlp_block_m(32, 32, jnp.float32, quant=False, device_kind=kind))


@pytest.mark.parametrize("kind", ["cpu", H100])
def test_fallbacks_are_jaxs(kind):
    """No port row: JAX's ``NS_FLASH_BLOCKS`` and 256, which JAX's own table
    gives on the CPU."""
    assert ptuning.TUNED_BLOCKS == {}
    for name in ("float32", "bfloat16", "int8"):
        for n, c, h in (P4, P8):
            assert (ptuning.attn_blocks(n, c, h, TORCH_OF[name], device_kind=kind)
                    == tuple(jtuning.attn_blocks(n, c, h, JAX_OF[name], device_kind="cpu"))
                    == pfa.NS_FLASH_BLOCKS == tuple(jfa.NS_FLASH_BLOCKS))
            for q in (True, False):
                assert (ptuning.mlp_block_m(c, c, TORCH_OF[name], quant=q, device_kind=kind)
                        == jtuning.mlp_block_m(c, c, JAX_OF[name], quant=q,
                                               device_kind="cpu") == 256)
    assert ptuning._local_device_kind(torch.device("cpu")) == "cpu"
    assert ptuning.attn_blocks(*P4, torch.int8, device="cpu") == pfa.NS_FLASH_BLOCKS


# ------------------------------------------------------------ candidate spaces

def _geometries():
    """(N, C, heads) of every model config, and two TINY ones."""
    out = {((cfg["img_size"][0] // cfg["patch_size"]) * (cfg["img_size"][1]
                                                        // cfg["patch_size"]) + 1,
            cfg["embed_dim"], cfg["num_heads"]) for cfg in MODEL_CONFIGS.values()}
    return sorted(out | {(17, 32, 4), (65, 32, 4)})


@pytest.mark.parametrize("n,c,h", _geometries())
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_every_candidate_passes_the_kernels_checks(n, c, h, cdt):
    for act, mode in ((cdt, "pallas"), (torch.int8, "w8a8")):
        cands = ptuning.attn_candidates(n, c, h, act, compute_dtype=cdt)
        for bq, bkv in cands:
            pfa.fused_geometry(8, n, c, h, bq, mode)  # raises where it cannot take it
            assert (bq, bkv)[1] == ptuning.ATTN_TILES[cdt][1]
            if mode == "w8a8":
                assert ptiling.is_legal(bq, n, torch.int8) and bq in (64, 128, 256, 512)
        if mode == "pallas":
            assert cands in ([], [ptuning.ATTN_TILES[cdt]])
    for act, q in ((cdt, False), (cdt, True), (torch.int8, True)):
        m = 8 * n
        cands = ptuning.mlp_candidates(m, c, c, c, act, quant=q, compute_dtype=cdt)
        if act != torch.int8:
            assert cands in ([], [pq.MLP_ROWS[cdt]])
            continue
        for bm in cands:
            assert pq.w8a8_block_m(bm, m) == bm and ptiling.is_legal(bm, m, torch.int8)
            rows, cluster = pq.mlp_geometry(m, bm, pq.MLP_ROWS[cdt])
            assert rows % bm == 0 and 1 <= cluster <= 8
    assert ptuning.dequant_candidates(8 * n, c, 3 * c, cdt) == [ptuning.DEQUANT_TILES[cdt]]


def test_w8a8_spaces_at_the_200px_geometries():
    for n, c, h in (P4, P8):
        for cdt in (torch.float32, torch.bfloat16):
            assert [bq for bq, _ in ptuning.attn_candidates(
                n, c, h, torch.int8, compute_dtype=cdt)] == [64, 128, 256, 512]
            assert ptuning.mlp_candidates(8 * n, c, c, c, torch.int8,
                                          compute_dtype=cdt) == list(range(32, 257, 32))
    # a sequence shorter than a requant unit: no legal w8a8 block on the card
    assert ptuning.attn_candidates(17, 32, 4, torch.int8) == []


def test_shared_memory_model_is_the_kernels():
    """The footprints the kernels were measured at: mlp_fused w8a16 bf16 at
    C = 256 169,024 B, dequant_mm bf16 (N = 768, K = 256) 140,288 B; the
    fused attention's bf16 kernel takes C = 256 at head dim 64 and 384 at
    head dim 32, not 384 at 64."""
    assert ptuning.mlp_smem_bytes(256, 256, 256, torch.bfloat16, "pallas") == 169_024
    assert ptuning.dequant_smem_bytes(768, 256, torch.bfloat16) == 140_288
    budget = ptuning.KERNEL_SMEM_BYTES
    for mode in ("pallas", "w8a8"):
        assert ptuning.attn_smem_bytes(256, 4, torch.bfloat16, mode) <= budget
    assert ptuning.attn_smem_bytes(384, 12, torch.bfloat16, "pallas") <= budget
    assert ptuning.attn_smem_bytes(384, 6, torch.bfloat16, "pallas") > budget
    assert ptuning.attn_candidates(2501, 384, 6, torch.bfloat16) == []


@pytest.mark.parametrize("n,c,h", [P4, P8])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_static_picks_are_the_defaults(n, c, h, cdt):
    """JAX's rule over the card's spaces gives the model's fallbacks: the
    w8a8 attention 512 rows (fewest requant blocks), the w8a8 Mlp 256 (the
    largest); every other mode its fixed tile."""
    assert ptuning.pick_attn(n, c, h, torch.int8, compute_dtype=cdt)[0] \
        == pfa.NS_FLASH_BLOCKS[0] == 512
    assert ptuning.pick_mlp(8 * n, c, c, c, torch.int8, compute_dtype=cdt) \
        == ptuning.mlp_block_m(c, c, torch.int8, device_kind=H100) == 256
    assert ptuning.pick_attn(n, c, h, cdt) == ptuning.ATTN_TILES[cdt]
    assert ptuning.pick_mlp(8 * n, c, c, c, cdt, quant=False) == pq.MLP_ROWS[cdt]
    assert not [k for k in ptuning.TUNED_BLOCKS if k[0].startswith("NVIDIA")]


def test_sweeps_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        ptuning.autotune_attn(1, 65, 64, 1, torch.float32, mode="w8a8", device="cpu")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        ptuning.autotune_mlp(64, 64, 64, torch.float32, mode="w8a8", device="cpu")


# ------------------------------------------------------------ the model's block

#: 32 px, patch 4: N = 65 tokens, C = 32, 4 heads, hidden 32; B = 2, M = 130
SMALL = dict(img_size=(32, 32), patch_size=4, embed_dim=32, depth=2, num_heads=4,
             total_steps=2000)
KIND = "tuning-test-kind"
#: non-default blocks for SMALL: 3 requant blocks of the attention's 65 rows
#: (default: one of 96), 5 of the Mlp's 130 (default: one of 160)
TINY_ROWS = {(KIND, "int8", "attn_n65_c32_h4"): (32, 32),
             (KIND, "int8", "mlp_c32_h32"): (32,)}


@pytest.fixture(scope="module")
def small_models():
    rs = np.random.RandomState(0)
    state = {k: (v + torch.from_numpy(rs.randn(*v.shape).astype(np.float32)) * 0.02
                 if k.endswith("bias") else v)
             for k, v in PortViT(**SMALL, device="cpu").state_dict().items()}
    jparams = jq.quantize_params(flax_from_torch_state_dict(state, 4))
    port = PortViT(**SMALL, use_flash=True, quant="w8a8", fused=True, device="cpu")
    port.load_state_dict(pq.quantize_state_dict(state_dict_from_flax(
        flax_from_torch_state_dict(state, 4), 4)), strict=True)
    jmodel = JaxViT(**SMALL, use_flash=True).clone(quant="w8a8", fused=True)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    t = rs.randint(0, 2000, size=(2,)).astype(np.int32)
    return port, jmodel, jparams, x, t


def _forwards(small_models):
    port, jmodel, jparams, x, t = small_models
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return got, want


def test_a_tuned_w8a8_block_reaches_both_models(small_models, monkeypatch):
    default_got, default_want = _forwards(small_models)
    np.testing.assert_allclose(default_got, default_want, rtol=2e-4, atol=2e-5)
    monkeypatch.setattr(ptuning, "TUNED_BLOCKS", dict(TINY_ROWS))
    monkeypatch.setattr(jtuning, "TUNED_BLOCKS", dict(TINY_ROWS))
    monkeypatch.setattr(ptuning, "_local_device_kind", lambda device=None: KIND)
    monkeypatch.setattr(jtuning, "_local_device_kind", lambda: KIND)
    got, want = _forwards(small_models)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the block moved the value past the parity limit: a model that had kept
    # its fallback block would fail the comparison above
    assert not np.allclose(got, default_got, rtol=2e-4, atol=2e-5)


def test_explicit_flash_blocks_win_over_the_table(small_models, monkeypatch):
    """``flash_blocks`` set the attention's block whatever the table says
    (JAX's ``self.flash_blocks or tuning.attn_blocks(...)``): with a row for
    the attention, the model built with ``(512, 4096)`` keeps the fallback's
    value while the model without them moves."""
    port, _, _, x, t = small_models
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    pinned = PortViT(**SMALL, use_flash=True, quant="w8a8", fused=True,
                     flash_blocks=(512, 4096), device="cpu")
    pinned.load_state_dict(port.state_dict(), strict=True)
    monkeypatch.setattr(ptuning, "_local_device_kind", lambda device=None: KIND)
    with torch.no_grad():
        fallback = port(x, t)
        monkeypatch.setattr(ptuning, "TUNED_BLOCKS",
                            {(KIND, "int8", "attn_n65_c32_h4"): (32, 32)})
        assert torch.equal(pinned(x, t), fallback)
        assert not torch.equal(port(x, t), fallback)


# ------------------------------------------------------------ flash_blocks in the trainer

@pytest.mark.parametrize("use_flash", [True, "xla"])
def test_flash_blocks_train_what_no_blocks_train(tmp_path, synthetic_image_dir,
                                                 monkeypatch, use_flash):
    """The trainer with ``flash_blocks: [512, 1024]`` against the same run
    without them, the flash (or blockwise) route in training (attention
    dropout 0): every parameter and the validation losses bit for bit. The
    flash route's tiles are fixed; the blockwise route's key block of 1024
    holds the 5 tokens whole, as 512 does."""
    import functools
    import os

    from ddim_cold_torch import config as port_config
    from ddim_cold_torch.train import trainer as port_trainer
    from ddim_cold_torch.utils import checkpoint as port_ckpt

    monkeypatch.setattr(port_trainer, "DiffusionViT",
                        functools.partial(PortViT, attn_drop_rate=0.0))
    runs = []
    for blocks in (None, (512, 1024)):
        cfg = port_config.ExperimentConfig(
            exp_name="blocks", framework="port", batch_size=2, epoch=(0, 1),
            base_lr=0.005, data_storage=(synthetic_image_dir,) * 2, image_size=(16, 16),
            patch_size=8, embed_dim=32, depth=1, head=2, use_flash=use_flash,
            flash_blocks=blocks)
        runs.append(port_trainer.run(cfg, str(tmp_path / str(blocks)), max_steps=3,
                                     device="cpu"))
    assert runs[0].last_val_loss == runs[1].last_val_loss
    a, b = (port_ckpt.load_checkpoint(os.path.join(r.run_dir, "lastepoch.ckpt"))
            for r in runs)
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
