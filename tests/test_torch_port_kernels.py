"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only, so it runs on a machine with the
card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

The tests that take the ``cuda_device`` fixture need the card and skip
without it; the others check the build's keying and placement on any
machine. The quantized trunk's kernels (``dequant_mm``, ``mlp_fused``,
``fused_trunk``) are held element-wise to ``quant.mm_error_limit`` and
``quant.trunk_error_limit``, whose docstrings give the arithmetic.
Tolerances of the flash kernels: O element-wise within ``fa.o_error_limit`` (float32
1e-5; bfloat16 one bf16 ulp of each element plus 2⁻⁵·mean|O|, for p rounded
against the running row max); lse 1e-5 for both (and, where inputs ×8 put
|lse| in the hundreds, 2⁻²⁰·|lse| + 1e-5: 8 f32 ulps, since one ulp there
is already 1.5e-5); dq, dk and dv element-wise within ``fa.grad_error_limit``
(float32 2⁻¹⁶·|g| + 2⁻¹³·mean|g|; bfloat16 one bf16 ulp of each element plus
2⁻⁶·mean|g|).
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ddim_cold_torch.analysis import kernel_checks
from ddim_cold_torch.analysis.entries import kernel_entries
from ddim_cold_torch.ops import _build
from ddim_cold_torch.ops import flash_attention as fa
from ddim_cold_torch.ops import quant

ROOT = Path(__file__).resolve().parents[1]


def test_build_is_keyed_by_source_and_lands_in_ignored_dir():
    path = _build.library_path("flash_fwd")
    assert path.parent == ROOT / "build" / "ddim_cold_torch"
    assert path.name.startswith("flash_fwd-") and path.suffix == ".so"
    assert set(_build.SIGNATURES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert ignored.returncode in (0, 128)  # 128: a copy without .git


#: per csrc/ header, the sources that include it, directly or through
#: another header (gemm_wgmma.cuh includes attn_wgmma.cuh)
HEADER_INCLUDERS = {
    "attn_wgmma.cuh": {"flash_fwd", "flash_bwd", "fused_trunk", "dequant_mm", "mlp_fused"},
    "gemm_wgmma.cuh": {"dequant_mm", "mlp_fused"},
    "launch_query.cuh": {"flash_fwd", "flash_bwd", "fused_trunk", "dequant_mm", "mlp_fused"},
}


@pytest.mark.parametrize("header_name", sorted(HEADER_INCLUDERS))
def test_build_key_follows_the_included_headers(tmp_path, monkeypatch, header_name):
    """Editing a csrc/ header changes the library path of every source that
    includes it, directly or through another header, so no stale library
    stays loaded, and of no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    header = csrc / header_name
    includers = HEADER_INCLUDERS[header_name]
    assert includers == {name for name in _build.SIGNATURES
                         if header in _build._inputs(name)}
    before = {name: _build.library_path(name) for name in _build.SIGNATURES}
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SIGNATURES}
    changed = {name for name in before if before[name] != after[name]}
    assert changed == includers


def _ulp_up(t: torch.Tensor) -> torch.Tensor:
    """The next bf16 value away from zero, at every element."""
    return (t.view(torch.int16) + 1).view(torch.bfloat16)


def test_bf16_error_limit_admits_one_ulp_and_refuses_a_scale_fault():
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((1, 626, 3, 4, 32), generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, _ = fa.flash_forward_reference(q, k, v, 32**-0.5)
    limit = fa.o_error_limit(o)
    o_ulp = _ulp_up(o)
    assert bool(((o_ulp.float() - o.float()).abs() <= limit).all())
    assert bool(((o.float() * 1.02 - o.float()).abs() > limit).any())


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_grad_error_limit_admits_one_ulp_and_refuses_a_scale_fault(which):
    """At a ragged 200px/p8-like shape: dq, dk and dv one bf16 ulp off pass
    the limit; any of them scaled 2% wrong fails it (f32 too)."""
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn((1, 157, 3, 4, 32), generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_forward_reference(q, k, v, 32**-0.5)
    do = torch.randn(o.shape, generator=gen).to(torch.bfloat16)
    g = fa.flash_backward_reference(q, k, v, o, lse, do, 32**-0.5)[:, :, "qkv".index(which[1])]
    limit = fa.grad_error_limit(g)
    assert bool(((_ulp_up(g).float() - g.float()).abs() <= limit).all())
    assert bool(((g.float() * 1.02 - g.float()).abs() > limit).any())
    g32 = fa.flash_backward_reference(*(t.float() for t in (q, k, v, o)), lse,
                                      do.float(), 32**-0.5)[:, :, "qkv".index(which[1])]
    assert bool(((g32 * 1.02 - g32).abs() > fa.grad_error_limit(g32)).any())


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU form")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


#: (B, N, H, D): the 200px/p4 and p8 geometries, ragged tails, one token,
#: and N around the 64-key tile (63, 64, 65 and 129 keys: a tile one short,
#: exact, one over, and a second tile of one key)
FLASH_SHAPES = [(2, 2501, 4, 64), (2, 626, 12, 32), (3, 37, 2, 64), (1, 1, 1, 32),
                (2, 63, 2, 64), (2, 64, 3, 32), (1, 65, 2, 64), (2, 129, 2, 32)]


def _flash_inputs(device, dtype, B, N, H, D, layout, seed=0, gain=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = (torch.randn((B, N, 3, H, D), generator=gen, device=device) * gain).to(dtype)
    if layout == "separate":
        return tuple(t.contiguous() for t in qkv.unbind(2))
    return qkv.unbind(2)  # strided views: the kernel reads them in place


@pytest.mark.parametrize("layout", ["qkv", "separate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, dtype, B, N, H, D, layout):
    q, k, v = _flash_inputs(cuda_device, dtype, B, N, H, D, layout)
    before = fa.LAUNCHES["flash_fwd"]
    o, lse = fa.flash_forward(q, k, v, D**-0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, D**-0.5)
    assert o.dtype == dtype and o.shape == (B, N, H, D) and o.is_contiguous()
    assert lse.shape == (B * H, N)
    err = (o.float() - o_ref.float()).abs()
    assert bool((err <= fa.o_error_limit(o_ref)).all()), err.max().item()
    assert (lse - lse_ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("B,N,H,D", [(2, 2501, 4, 64), (2, 129, 2, 32)])
def test_flash_kernel_large_logits(cuda_device, B, N, H, D):
    """bfloat16 inputs ×8, so logits ×64 (|logit| up to a few hundred): the
    running max moves by far more than the softmax's range from tile to
    tile, and the -1e30 mask must stay below every real logit. O is held to
    the same ``o_error_limit``; lse to 8 f32 ulps of its size (a float32
    kernel is not run here: at these logits one f32 rounding of a logit
    moves O by more than the float32 limit's 1e-5)."""
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, B, N, H, D, "qkv", seed=6, gain=8.0)
    o, lse = fa.flash_forward(q, k, v, D**-0.5)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, D**-0.5)
    assert lse_ref.abs().max().item() > 100.0
    err = (o.float() - o_ref.float()).abs()
    assert bool((err <= fa.o_error_limit(o_ref)).all()), err.max().item()
    lse_err = (lse - lse_ref).abs()
    assert bool((lse_err <= 2.0**-20 * lse_ref.abs() + 1e-5).all()), lse_err.max().item()


def _flash_backward(device, dtype, B, N, H, D, seed=1, gain=1.0, do_view=False):
    """dq, dk, dv from the two kernels (one launch each) and from the plain
    version on the same inputs and the same lse, each as one (B, N, 3, H, D)
    buffer; the lse; and the inputs (q, k, v, o, dO). ``do_view``: dO is the second slice of a
    (B, N, 2, H, D) buffer, a non-contiguous view with 16-byte rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = (torch.randn((B, N, 3, H, D), generator=gen, device=device) * gain).to(dtype)
    q, k, v = qkv.unbind(2)
    scale = D**-0.5
    o, lse = fa.flash_forward_reference(q, k, v, scale)
    if do_view:
        do = torch.randn((B, N, 2, H, D), generator=gen, device=device).to(dtype)[:, :, 1]
        assert not do.is_contiguous()
    else:
        do = torch.randn((B, N, H, D), generator=gen, device=device).to(dtype)
    before = (fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"])
    grad = fa.flash_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"]) == (
        before[0] + 1, before[1] + 1)
    ref = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
    assert grad.shape == (B, N, 3, H, D) and grad.dtype == dtype
    assert bool(torch.isfinite(grad.float()).all())
    return grad, ref, lse, (q, k, v, o, do)


def _assert_within_limit(grad, ref, names="qkv"):
    for name in names:
        i = "qkv".index(name)
        err = (grad[:, :, i].float() - ref[:, :, i].float()).abs()
        limit = fa.grad_error_limit(ref[:, :, i])
        assert bool((err <= limit).all()), (name, err.max().item(),
                                            (err / limit).max().item())


#: (B, N, H, D): the 200px/p4 and p8 geometries, a ragged tail, one token,
#: and one row or key in the last 64-row tile (65, 129, 257)
FLASH_BWD_SHAPES = [(2, 2501, 4, 64), (2, 626, 12, 32), (3, 37, 2, 64), (1, 1, 1, 32),
                    (1, 65, 2, 64), (2, 129, 2, 32), (1, 257, 3, 64), (2, 257, 2, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", FLASH_BWD_SHAPES)
def test_flash_backward_kernels_match_plain(cuda_device, dtype, B, N, H, D):
    """dq, dk, dv from the two kernels against the plain version on the
    same inputs and the same lse, written into one (B, N, 3, H, D) buffer."""
    _assert_within_limit(*_flash_backward(cuda_device, dtype, B, N, H, D)[:2])


@pytest.mark.parametrize("B,N,H,D", [(2, 2501, 4, 64), (2, 129, 2, 32)])
def test_flash_backward_large_logits(cuda_device, B, N, H, D):
    """bfloat16 inputs ×8, so logits ×64 (|lse| in the hundreds): P is
    rebuilt from an lse far from zero and the masked tails must stay zero,
    or dq, dk and dv would not be finite. dv = Pᵀ·dO, the product of P
    alone, is held to ``grad_error_limit``; dq and dk to it plus
    ``ds_flip_bound``, since their nearly one-hot softmax rows make each
    element a difference of dS terms far larger than itself, and one dS
    rounding that flips moves it past the bare limit, whichever side is
    right. A dq or dk 2% too large fails that gate."""
    grad, ref, lse, (q, k, v, o, do) = _flash_backward(cuda_device, torch.bfloat16, B, N, H,
                                                       D, seed=6, gain=8.0)
    assert lse.abs().max().item() > 100.0
    _assert_within_limit(grad, ref, names="v")
    flips = fa.ds_flip_bound(q, k, v, do, lse, fa.backward_delta(o, do), D**-0.5)
    for i, name in enumerate("qk"):
        limit = fa.grad_error_limit(ref[:, :, i]) + flips[i]
        err = (grad[:, :, i].float() - ref[:, :, i].float()).abs()
        assert bool((err <= limit).all()), (name, (err / limit).max().item())
        fault = (grad[:, :, i].float() * 1.02 - ref[:, :, i].float()).abs()
        assert bool((fault > limit).any()), name


def test_flash_backward_large_logits_against_jax(cuda_device):
    """The bf16 backward kernels against the JAX package's own backward at
    the large-logit case of ROADMAP.md Queue 3 (``tools/bwd_fixture.py``):
    the fixture's inputs are what the CUDA generator draws for the case, and
    the kernels, fed the JAX forward's O and lse, are held to the gate of
    :func:`test_flash_backward_large_logits` around JAX's dq, dk and dv: dv
    within ``grad_error_limit``, dq and dk within it plus ``ds_flip_bound``,
    and a 2% fault of dq or dk fails that gate."""
    from ddim_cold_torch.tools import bwd_fixture

    t = bwd_fixture.load(cuda_device)
    drawn = bwd_fixture.large_logit_inputs(cuda_device, **bwd_fixture.CASE)
    for name, x in zip(bwd_fixture.INPUTS, drawn):
        assert torch.equal(x.view(torch.int16), t[name].view(torch.int16)), name
    scale = bwd_fixture.CASE["D"] ** -0.5
    grad = fa.flash_backward(t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"], scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(grad.float()).all())
    flips = fa.ds_flip_bound(t["q"], t["k"], t["v"], t["do"], t["lse"],
                             fa.backward_delta(t["o"], t["do"]), scale)
    for i, name in enumerate(("dq", "dk", "dv")):
        ref = t[name].float()
        limit = fa.grad_error_limit(t[name]) + (flips[i] if i < 2 else 0.0)
        err = (grad[:, :, i].float() - ref).abs()
        assert bool((err <= limit).all()), (name, (err / limit).max().item())
        if i < 2:
            assert bool(((grad[:, :, i].float() * 1.02 - ref).abs() > limit).any()), name


@pytest.mark.parametrize("B,N,H,D", [(2, 2501, 4, 64), (2, 129, 2, 32)])
def test_flash_backward_reads_a_strided_do_view(cuda_device, B, N, H, D):
    """A non-contiguous bfloat16 dO whose rows are 16-byte aligned is read
    in place by the tensor-core kernels."""
    _assert_within_limit(*_flash_backward(cuda_device, torch.bfloat16, B, N, H, D, seed=7,
                                          do_view=True)[:2])


def test_flash_backward_refuses_misaligned_bf16_rows(cuda_device):
    """The bf16 backward kernels refuse a misaligned q or dO with ValueError
    before any launch; ``flash_backward`` copies a misaligned dO once (so a
    training step is never refused for it) and matches the plain version."""
    B, N, H, D = 1, 70, 2, 32
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_forward_reference(q, k, v, D**-0.5)
    delta = torch.zeros((B * H, N), device=cuda_device)
    flat = torch.randn(1 + B * N * H * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    bad = flat[1:].view(B, N, H, D)  # base 2 bytes off
    grad = torch.empty((B, N, 3, H, D), dtype=torch.bfloat16, device=cuda_device)
    dq, dk, dv = grad.unbind(2)
    before = dict(fa.LAUNCHES)
    for args in ((bad, k, v, q), (q, k, v, bad)):  # a misaligned q, then dO
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_bwd_dq(*args, lse, delta, dq, 1.0)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_bwd_dkv(*args, lse, delta, dk, dv, 1.0)
    assert dict(fa.LAUNCHES) == before
    got = fa.flash_backward(q, k, v, o, lse, bad, D**-0.5)
    torch.cuda.synchronize()
    ref = fa.flash_backward_reference(q, k, v, o, lse, bad, D**-0.5)
    for i in range(3):
        err = (got[:, :, i].float() - ref[:, :, i].float()).abs()
        assert bool((err <= fa.grad_error_limit(ref[:, :, i])).all()), (i, err.max().item())


def test_flash_autograd_runs_the_kernels(cuda_device):
    """``flash_attention_qkv`` forward and backward on the card launch one
    forward and one of each backward kernel, and the gradient reaches the
    projection as one buffer."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, 300, 3, 4, 64), generator=gen, device=cuda_device)
    qkv.requires_grad_(True)
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention_qkv(qkv, 0.125)
    (g,) = torch.autograd.grad(o, qkv, torch.ones_like(o))
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name] == before.get(name, 0) + 1
    q, k, v = qkv.detach().unbind(2)
    o2, lse = fa.flash_forward_reference(q, k, v, 0.125)
    ref = fa.flash_backward_reference(q, k, v, o2, lse, torch.ones_like(o2), 0.125)
    assert bool(((g - ref).abs() <= fa.grad_error_limit(ref)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["ddim", "cold"])
def test_distill_student_backward_runs_the_kernels(cuda_device, monkeypatch, dtype,
                                                   variant):
    """One distillation step of a small flash model (32 px, patch 4: 65
    tokens, 2 heads of 64): the teacher's two forwards and the student's
    one launch depth × 3 flash forwards, the student's backward depth × one
    of each backward kernel, and every backward call's dq, dk and dv lie
    within ``fa.grad_error_limit`` of the plain version on the same
    inputs."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.train import distill

    model = DiffusionViT(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2,
                         num_heads=2, dtype=dtype, use_flash=True, seed=1,
                         device=cuda_device)
    calls = []
    backward = fa.flash_backward

    def recording(q, k, v, o, lse, do, scale):
        grad = backward(q, k, v, o, lse, do, scale)
        calls.append((q, k, v, o, lse, do, scale, grad))
        return grad

    monkeypatch.setattr(fa, "flash_backward", recording)
    state = distill.make_student_state(model, 1e-3, 4)
    step = distill.make_distill_step(model, steps=2, variant=variant, cold_levels=4)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x0 = distill.synthetic_batch(gen, 4, (32, 32), 3)
    before = dict(fa.LAUNCHES)
    _, loss, _ = step(state, model, x0, gen, torch.zeros((), device=cuda_device))
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before.get(k, 0)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    assert launched == {"flash_fwd": 3 * model.depth, "flash_bwd_dq": model.depth,
                        "flash_bwd_dkv": model.depth}
    assert len(calls) == model.depth and bool(torch.isfinite(loss))
    for q, k, v, o, lse, do, scale, grad in calls:
        ref = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
        _assert_within_limit(grad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_flash_training_is_bitwise_the_plain_route(cuda_device, dtype):
    """Two training steps of a 64 px, patch 4 flash model (B=2, 257 tokens,
    4 heads of 64, dropout and drop path 0.1, attention dropout 0) with and
    without remat: losses, parameters and the generator's state bit for bit
    equal (the kernels are deterministic and the recomputation sees the
    same inputs and replays the same masks); remat launches the forward
    kernel twice per block and step, each backward kernel once."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    batches = [(torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randint(0, 2000, (2,), generator=gen, device=cuda_device))
               for _ in range(2)]
    got = {}
    for remat in (False, True):
        model = DiffusionViT(img_size=(64, 64), patch_size=4, embed_dim=256, depth=2,
                             num_heads=4, dtype=dtype, use_flash=True, remat=remat,
                             attn_drop_rate=0.0, seed=5, device=cuda_device)
        state = create_train_state(model, 1e-3, 10)
        step = make_train_step(model)
        g = torch.Generator(device=cuda_device).manual_seed(6)
        rec = torch.tensor(5.0, device=cuda_device)
        before = dict(fa.LAUNCHES)
        losses = []
        for b in batches:
            state, loss, rec = step(state, b, g, rec)
            losses.append(loss)
        torch.cuda.synchronize()
        launched = {k: fa.LAUNCHES[k] - before.get(k, 0)
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        got[remat] = (torch.stack(losses), [p.detach().clone() for p in model.parameters()],
                      g.get_state(), launched)
    (l0, p0, g0, n0), (l1, p1, g1, n1) = got[False], got[True]
    assert torch.equal(l0, l1) and bool(torch.isfinite(l0).all())
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(g0, g1)
    steps = len(batches)
    assert n0 == {"flash_fwd": 2 * steps, "flash_bwd_dq": 2 * steps,
                  "flash_bwd_dkv": 2 * steps}
    assert n1 == {"flash_fwd": 2 * 2 * steps, "flash_bwd_dq": 2 * steps,
                  "flash_bwd_dkv": 2 * steps}


@pytest.mark.parametrize("dispatch", ["einsum", "index"])
def test_moe_remat_training_is_bitwise_the_plain_route(cuda_device, dispatch):
    """The Switch-MoE model on the card (64 px, patch 4, 4 experts at
    capacity 0.5, so tokens drop; dropout on the banks' hidden units and
    outputs and drop path 0.1, attention dropout 0, ``moe_aux_weight``
    0.01): two steps with and without remat bit for bit equal (losses,
    parameters, the generator), the recomputed banks' statistics kept out of
    the aux; each flash kernel once a block and step (the forward twice
    under remat)."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.train.step import create_train_state, make_train_step

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    batches = [(torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randint(0, 2000, (2,), generator=gen, device=cuda_device))
               for _ in range(2)]
    got = {}
    for remat in (False, True):
        model = DiffusionViT(img_size=(64, 64), patch_size=4, embed_dim=256, depth=2,
                             num_heads=4, use_flash=True, remat=remat, attn_drop_rate=0.0,
                             num_experts=4, moe_capacity_factor=0.5, moe_dispatch=dispatch,
                             seed=5, device=cuda_device)
        state = create_train_state(model, 1e-3, 10)
        step = make_train_step(model, moe_aux_weight=0.01)
        g = torch.Generator(device=cuda_device).manual_seed(6)
        rec = torch.tensor(5.0, device=cuda_device)
        before = dict(fa.LAUNCHES)
        losses = []
        for b in batches:
            state, loss, rec = step(state, b, g, rec)
            losses.append(loss)
        torch.cuda.synchronize()
        launched = {k: fa.LAUNCHES[k] - before.get(k, 0)
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        got[remat] = (torch.stack(losses), [p.detach().clone() for p in model.parameters()],
                      g.get_state(), launched)
    (l0, p0, g0, n0), (l1, p1, g1, n1) = got[False], got[True]
    assert torch.equal(l0, l1) and bool(torch.isfinite(l0).all())
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(g0, g1)
    assert n0 == {"flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    assert n1 == {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blockwise_route_against_the_flash_kernel(cuda_device, dtype):
    """``blockwise_attention_xla`` (plain PyTorch, f32 softmax, no launch)
    against ``flash_forward`` at 200_p4 B=2 (2501 tokens, 4 heads of 64):
    within ``fa.o_error_limit`` of the blockwise result."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((2, 2501, 4, 64), generator=gen, device=cuda_device).to(dtype)
               for _ in range(3))
    before = dict(fa.LAUNCHES)
    xla = fa.blockwise_attention_xla(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == before
    o, _ = fa.flash_forward(q, k, v, 0.125)
    assert xla.dtype == o.dtype == dtype
    err = (o.float() - xla.float()).abs()
    assert bool((err <= fa.o_error_limit(xla)).all()), err.max().item()


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 2, 16), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(x, x, x, 1.0)
    x = torch.zeros((1, 8, 2, 32), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        fa.flash_forward(x, x, x, 1.0)
    x = torch.zeros((1, 8, 32, 2), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="innermost"):
        fa.flash_forward(x, x, x, 1.0)
    # bfloat16 rows are copied in 16-byte pieces: an odd base or token stride is refused
    flat = torch.zeros(1 + 8 * 2 * 32, device=cuda_device, dtype=torch.bfloat16)
    x = flat[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_forward(x, x, x, 1.0)
    x = torch.zeros((1, 8, 2 * 32 + 1), device=cuda_device, dtype=torch.bfloat16)
    x = x[:, :, :64].unflatten(2, (2, 32))
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_forward(x, x, x, 1.0)


def _codes(gen, rows, cols, device):
    return quant.quantize_weight(torch.randn((rows, cols), generator=gen,
                                             device=device) * 0.05)


@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("M,K,N", [(2501, 256, 768), (2501, 256, 256), (626, 384, 384),
                                   (7, 33, 50)])
def test_dequant_mm_kernel_matches_plain(cuda_device, dtype, out_dtype, M, K, N):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(dtype)
    w, s = _codes(gen, N, K, cuda_device)
    bias = torch.randn(N, generator=gen, device=cuda_device)
    before = quant.LAUNCHES["dequant_mm"]
    y = quant.dequant_mm(x, w, s, bias, out_dtype)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["dequant_mm"] == before + 1
    ref = quant.dequant_mm_reference(x, w, s, bias).to(out_dtype)
    assert y.dtype == out_dtype and y.shape == (M, N)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= quant.mm_error_limit(x, w, s, ref)).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [None, "pallas", "w8a8"])
@pytest.mark.parametrize("M,C", [(2 * 2501, 256), (626, 384), (300, 64)])
def test_mlp_fused_kernel_matches_plain(cuda_device, dtype, mode, M, C):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((M, C), generator=gen, device=cuda_device).to(dtype)
    b1 = torch.randn(C, generator=gen, device=cuda_device) * 0.1
    b2 = torch.randn(C, generator=gen, device=cuda_device) * 0.1
    flip = None
    if mode is None:
        w1 = torch.randn((C, C), generator=gen, device=cuda_device) * 0.05
        w2 = torch.randn((C, C), generator=gen, device=cuda_device) * 0.05
        kw = {}
    else:
        (w1, s1), (w2, s2) = _codes(gen, C, C, cuda_device), _codes(gen, C, C, cuda_device)
        kw = dict(scale1=s1, scale2=s2, mode=mode)
    before = quant.LAUNCHES["mlp_fused"]
    with torch.no_grad():
        y = quant.mlp_fused(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["mlp_fused"] == before + 1
    ref, row_scale = quant.mlp_fused_reference(x, w1, b1, w2, b2, **kw,
                                               return_row_scale=True)
    if mode == "w8a8":
        flip = quant.requant_flip_bound(row_scale, w2, s2)
    assert y.dtype == dtype and y.shape == (M, C)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= quant.trunk_error_limit(ref, mode, flip)).all()), err.max().item()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,stride", [(33, 33), (256, 260), (40, 44)])
def test_dequant_mm_bf16_copies_what_it_cannot_read_in_place(cuda_device, out_dtype, K,
                                                             stride):
    """A bfloat16 x with K not a multiple of 16, or rows not 16-byte aligned
    (a column slice of a wider buffer), is copied once into a zero-padded K
    (the codes too) and still takes one launch of the wgmma kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    wide = torch.randn((300, stride), generator=gen, device=cuda_device).to(torch.bfloat16)
    x = wide[:, :K]
    w, s = _codes(gen, 96, K, cuda_device)
    bias = torch.randn(96, generator=gen, device=cuda_device)
    Kp, copy = quant.bf16_row_layout(K, x.stride(0), x.data_ptr())
    assert copy and Kp == -(-K // 16) * 16
    before = quant.LAUNCHES["dequant_mm"]
    y = quant.dequant_mm(x, w, s, bias, out_dtype)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["dequant_mm"] == before + 1
    ref = quant.dequant_mm_reference(x, w, s, bias).to(out_dtype)
    err = (y.float() - ref.float()).abs()
    limit = quant.mm_error_limit(x, w, s, ref)
    assert bool((err <= limit).all()), err.max().item()
    assert bool(((y.float() * 1.02 - ref.float()).abs() > limit).any())


#: (M, block_m): w8a8 requant tiles that are not whole 128-row CTAs of the
#: bfloat16 kernel: M = 90 legalises block_m 256 to 96 rows (a cluster of 3
#: CTAs covers 4 tiles); 96-row tiles over 300 rows; 160-row tiles (clusters
#: of 5)
MLP_ODD_BLOCKS = [(90, 256), (300, 96), (626, 160)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,block_m", MLP_ODD_BLOCKS)
def test_mlp_fused_w8a8_block_not_a_multiple_of_64(cuda_device, dtype, M, block_m):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    C = 256
    x = torch.randn((M, C), generator=gen, device=cuda_device).to(dtype)
    b1 = torch.randn(C, generator=gen, device=cuda_device) * 0.1
    b2 = torch.randn(C, generator=gen, device=cuda_device) * 0.1
    (w1, s1), (w2, s2) = _codes(gen, C, C, cuda_device), _codes(gen, C, C, cuda_device)
    kw = dict(scale1=s1, scale2=s2, mode="w8a8", block_m=block_m)
    before = quant.LAUNCHES["mlp_fused"]
    with torch.no_grad():
        y = quant.mlp_fused(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["mlp_fused"] == before + 1
    ref, row_scale = quant.mlp_fused_reference(x, w1, b1, w2, b2, **kw,
                                               return_row_scale=True)
    limit = quant.trunk_error_limit(ref, "w8a8", quant.requant_flip_bound(row_scale, w2, s2))
    err = (y.float() - ref.float()).abs()
    assert bool((err <= limit).all()), err.max().item()
    assert bool(((y.float() * 1.02 - ref.float()).abs() > limit).any())


#: (mode, B, N, C, H, block_q): the 200px/p4 and p8 geometries, a narrow
#: ragged one, one token, vit_tiny's 65 tokens, one row past a cluster of
#: 512; in w8a8 also every requant block of 64 to 256 rows (one token, and
#: 65 tokens at block_q > 64, have no block of whole CTAs: see the refusal
#: test)
FUSED_CASES = ([("pallas", 2, 2501, 256, 4, 512), ("pallas", 2, 626, 384, 12, 512),
                ("pallas", 1, 300, 64, 2, 128), ("pallas", 1, 1, 256, 4, 512),
                ("pallas", 2, 65, 384, 12, 512), ("pallas", 1, 513, 256, 4, 512)]
               + [("w8a8", 2, 2501, 256, 4, 512), ("w8a8", 2, 626, 384, 12, 512),
                  ("w8a8", 1, 300, 64, 2, 128), ("w8a8", 2, 65, 384, 12, 64),
                  ("w8a8", 1, 257, 256, 4, 256)]
               + [("w8a8", 1, 513, 256, 4, bq) for bq in (64, 128, 256, 512)])


def _trunk_inputs(device, dtype, B, N, C):
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((B, N, C), generator=gen, device=device).to(dtype)
    w_qkv, s_qkv = _codes(gen, 3 * C, C, device)
    w_p, s_p = _codes(gen, C, C, device)
    b_qkv = torch.randn(3 * C, generator=gen, device=device) * 0.1
    b_p = torch.randn(C, generator=gen, device=device) * 0.1
    return x, w_qkv, s_qkv, b_qkv, w_p, s_p, b_p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,B,N,C,H,block_q", FUSED_CASES)
def test_fused_trunk_kernel_matches_plain(cuda_device, dtype, mode, B, N, C, H, block_q):
    args = _trunk_inputs(cuda_device, dtype, B, N, C)
    w_p, s_p = args[4], args[5]
    kw = dict(num_heads=H, scale=(C // H) ** -0.5, block_q=block_q, mode=mode)
    before = fa.LAUNCHES["fused_trunk"]
    with torch.no_grad():
        y = fa.fused_trunk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_trunk"] == before + 1
    ref, row_scale = fa.fused_trunk_attention_reference(*args, **kw,
                                                        return_row_scale=True)
    flip = quant.requant_flip_bound(row_scale, w_p, s_p) if mode == "w8a8" else None
    assert y.dtype == dtype and y.shape == (B, N, C)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= quant.trunk_error_limit(ref, mode, flip)).all()), err.max().item()


def test_fused_trunk_kernel_refuses_what_it_does_not_take(cuda_device):
    """A w8a8 requant block that is not whole CTAs of one cluster (one
    token: JAX's block is 32 rows), and bfloat16 x whose rows cannot be
    copied in 16-byte pieces, raise before any launch."""
    args = _trunk_inputs(cuda_device, torch.bfloat16, 1, 1, 256)
    before = fa.LAUNCHES["fused_trunk"]
    with torch.no_grad(), pytest.raises(ValueError, match="block_q of 64, 128, 256 or 512"):
        fa.fused_trunk_attention(*args, num_heads=4, scale=0.125, mode="w8a8")
    flat = torch.zeros(1 + 3 * 256, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match=re.escape("16-byte")):
        fa.fused_trunk_attention(flat[1:].view(1, 3, 256), *args[1:], num_heads=4,
                                 scale=0.125)
    assert fa.LAUNCHES["fused_trunk"] == before


#: each hand-written kernel's profiler scope (a substring of its device
#: function names, the scope ``profiling.scope`` opens around its launch)
KERNEL_SCOPES = {"flash_fwd": "flash_attention/fwd", "flash_bwd_dq": "flash_attention/dq",
                 "flash_bwd_dkv": "flash_attention/dkv",
                 "fused_trunk": "flash_attention/fused_qkv",
                 "dequant_mm": "dequant_matmul/pallas", "mlp_fused": "mlp/pallas"}


def test_card_capture_attributes_every_kernel_to_its_scope(cuda_device, tmp_path):
    """A small bf16 model (32 px, patch 4: 65 tokens, 2 heads of 64),
    traced on the card with ``profiling.trace`` and read by
    ``obs.attrib``: a 2-row DDIM batch on the float flash route, the
    ``quant="pallas"`` route and the fused w8a16 route, then one training
    forward and backward. Each hand-written kernel's device events land in
    its scope, as many as it launched and as the trace holds by name (the
    backward pair's launched on autograd's thread); the sampler batches'
    coverage is at least ``attrib.COVERAGE_FLOOR``."""
    from torch.autograd import DeviceType

    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.obs import attrib
    from ddim_cold_torch.ops import sampling
    from ddim_cold_torch.utils import profiling

    kw = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2, num_heads=2,
              dtype=torch.bfloat16, use_flash=True, seed=1, device=cuda_device)
    kind = torch.cuda.get_device_name(0)

    def counts():
        return {k: fa.LAUNCHES[k] + quant.LAUNCHES[k] for k in KERNEL_SCOPES}

    def captured(label, fn):
        fn()  # builds and loads the libraries outside the capture
        torch.cuda.synchronize()
        before = counts()
        with profiling.trace(str(tmp_path / label)) as prof:
            fn()
            torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in counts().items() if n > before[k]}
        by_name = {k: sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA and k in e.name)
                   for k in launched}
        report = attrib.attribute(str(tmp_path / label), device_kind=kind)
        events = {k: report["scopes"].get(KERNEL_SCOPES[k], {}).get("events")
                  for k in launched}
        assert events == launched == by_name, (label, events, launched, by_name)
        return report

    for label, extra in (("float", {}), ("pallas", dict(quant="pallas")),
                         ("fused", dict(quant="pallas", fused=True))):
        model = DiffusionViT(**kw, **extra)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        report = captured(label, lambda: sampling.ddim_sample(
            model, gen, n=2, k=500, device=cuda_device))
        assert report["coverage"] >= attrib.COVERAGE_FLOOR, (label, report["coverage"])
        assert report["scopes"]["sampler/model"]["events"] > 0

    model = DiffusionViT(**kw, attn_drop_rate=0.0)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator(device=cuda_device)
                    .manual_seed(2), device=cuda_device)
    t = torch.tensor([3, 900], device=cuda_device)
    report = captured("train", lambda: model(x, t).float().square().mean().backward())
    for scope in ("flash_attention/fwd", "flash_attention/dq", "flash_attention/dkv"):
        assert report["scopes"][scope]["events"] == model.depth


def test_two_ranks_on_the_card_attend_as_one_process(cuda_device):
    """Two gloo ranks on the one card with CUDA tensors (NCCL refuses two
    ranks on one device), ``{seq: 2}`` at the 200_p4 attention shape in
    bf16: Ulysses through the flash kernel (each rank the whole sequence for
    2 of the 4 heads) and the ring (f32 blocks) against the one-process
    flash kernel on the same inputs, within ``fa.o_error_limit``; every rank
    returns the whole result."""
    from ddim_cold_torch.tools import dist_cases

    shape = dict(B=2, N=2501, H=4, D=64)
    cases = [("attention", dict(spec={"seq": 2}, fn=fn, dtype="bfloat16", use_flash=True,
                                grad=False, **shape)) for fn in ("ulysses", "ring")]
    results = dist_cases.run_world(cases, 2, device="cuda", backend="gloo", timeout_s=180)
    q, k, v, _ = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in dist_cases.qkv_inputs(0, *shape.values()))
    ref = fa.flash_forward(q, k, v, 64**-0.5)[0].float().cpu()
    limit = fa.o_error_limit(ref.to(torch.bfloat16))
    for (fn, _), ranks in zip(cases, results):
        for got in ranks:
            err = (torch.from_numpy(got["out"]) - ref).abs()
            assert bool((err <= limit).all()), (fn, float(err.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_tuning_candidate_matches_plain(cuda_device, dtype):
    """The w8a8 sweeps of ``ops/tuning.py`` at B=2, N=513, C=256, 4 heads
    (M = 1,026 rows): every candidate block launches and is held to its
    plain version at the same block within ``quant.trunk_error_limit`` (the
    sweeps raise otherwise): ``fused_trunk`` at 64, 128, 256 and 512 rows,
    ``mlp_fused`` at 32, 64, …, 256."""
    from ddim_cold_torch.ops import tuning

    attn = tuning.autotune_attn(2, 513, 256, 4, dtype, mode="w8a8", iters=2,
                                device=cuda_device)
    assert sorted(r["block_q"] for r in attn) == [64, 128, 256, 512]
    mlp = tuning.autotune_mlp(2 * 513, 256, 256, dtype, mode="w8a8", iters=2,
                              device=cuda_device)
    assert sorted(r["block_m"] for r in mlp) == list(range(32, 257, 32))
    assert all(r["within_limit"] and r["ms"] > 0 for r in attn + mlp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_n_step_dispatch_is_bitwise_single_steps(cuda_device, dtype):
    """Four steps of a 64 px, patch 4 flash model (B=2, 257 tokens, 4 heads
    of 64, dropout and drop path 0.1, attention dropout 0) as two dispatches
    of ``steps_per_dispatch=2`` and as four single calls, each step's
    generator from its step: parameters, moments, losses and the EMA loss
    bit for bit, each flash kernel launched once a block and step."""
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.train.step import (create_train_state, make_train_step,
                                            step_generator)

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    batches = [(torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randn((2, 64, 64, 3), generator=gen, device=cuda_device),
                torch.randint(0, 2000, (2,), generator=gen, device=cuda_device))
               for _ in range(4)]
    got = {}
    for n in (1, 2):
        model = DiffusionViT(img_size=(64, 64), patch_size=4, embed_dim=256, depth=2,
                             num_heads=4, dtype=dtype, use_flash=True, attn_drop_rate=0.0,
                             seed=5, device=cuda_device)
        state = create_train_state(model, 1e-3, 10)
        step = make_train_step(model, steps_per_dispatch=n)
        rec = torch.tensor(5.0, device=cuda_device)
        before = dict(fa.LAUNCHES)
        losses = []
        for i in range(0, 4, n):
            if n == 1:
                state, loss, rec = step(state, batches[i],
                                        step_generator(7, state.step, cuda_device), rec)
            else:
                stacked = tuple(map(torch.stack, zip(*batches[i:i + n])))
                state, loss, rec = step(state, stacked,
                                        lambda s: step_generator(7, s, cuda_device), rec)
            losses.append(loss)
        torch.cuda.synchronize()
        launched = {k: fa.LAUNCHES[k] - before.get(k, 0)
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        got[n] = (torch.stack(losses), [p.detach().clone() for p in model.parameters()],
                  [m.clone() for m in state.mu + state.nu], rec, launched)
    (l1, p1, m1, r1, n1), (l2, p2, m2, r2, n2) = got[1], got[2]
    assert all(torch.equal(l2[j], l1[2 * j:2 * j + 2].mean()) for j in range(2))
    assert bool(torch.isfinite(l1).all())
    assert all(torch.equal(a, b) for a, b in zip(p1 + m1, p2 + m2))
    assert torch.equal(r1, r2)
    assert n1 == n2 == {"flash_fwd": 2 * 4, "flash_bwd_dq": 2 * 4, "flash_bwd_dkv": 2 * 4}


#: the static analysis's kernel entries: every kernel at the main path's
#: geometry and a small one each (``analysis.entries.kernel_entries``)
ANALYSIS_ENTRIES = {e.name: e for e in kernel_entries()}


@pytest.mark.parametrize("name", sorted(ANALYSIS_ENTRIES))
def test_launch_config_query_is_the_static_prediction(cuda_device, name):
    """Each library's ``<name>_launch_config`` query (the launcher computes
    its launch through the same C function) equals the P layer's predicted
    grid, threads, dynamic shared bytes and cluster, and the built kernel's
    attributes pass P001–P003 (``analysis/kernel_checks.py``)."""
    entry = ANALYSIS_ENTRIES[name]
    kind = torch.cuda.get_device_name(0)
    launch = kernel_checks.predict(
        entry, device_kind=kind, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert kernel_checks.card_launch_config(launch) == launch.as_config()
    attrs = kernel_checks.card_attributes(launch)
    assert kernel_checks.check_entry(entry, launch, attrs, device_kind=kind) == []
    assert attrs["local"] == 0 and attrs["blocks_per_sm"] >= 1
