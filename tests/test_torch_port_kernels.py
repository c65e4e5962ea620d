"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only, so it runs on a machine with the
card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

The tests that take the ``cuda_device`` fixture need the card and skip
without it; the others check the build's keying and placement on any
machine. Tolerances: O element-wise within ``fa.o_error_limit`` (float32
1e-5; bfloat16 one bf16 ulp of each element plus 2⁻⁵·mean|O|, for p rounded
against the running row max); lse 1e-5 for both.
"""

import subprocess
from pathlib import Path

import pytest
import torch

from ddim_cold_torch.ops import _build
from ddim_cold_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]


def test_build_is_keyed_by_source_and_lands_in_ignored_dir():
    path = _build.library_path("flash_fwd")
    assert path.parent == ROOT / "build" / "ddim_cold_torch"
    assert path.name.startswith("flash_fwd-") and path.suffix == ".so"
    assert set(_build.SIGNATURES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert ignored.returncode in (0, 128)  # 128: a copy without .git


def test_bf16_error_limit_admits_one_ulp_and_refuses_a_scale_fault():
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((1, 626, 3, 4, 32), generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, _ = fa.flash_forward_reference(q, k, v, 32**-0.5)
    limit = fa.o_error_limit(o)
    # the next bf16 value away from zero: one ulp at every element
    o_ulp = (o.view(torch.int16) + 1).view(torch.bfloat16)
    assert bool(((o_ulp.float() - o.float()).abs() <= limit).all())
    assert bool(((o.float() * 1.02 - o.float()).abs() > limit).any())


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", [(2, 2501, 4, 64), (2, 626, 12, 32),
                                     (3, 37, 2, 64), (1, 1, 1, 32)])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, N, H, D):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device=cuda_device).to(dtype)
    q, k, v = qkv.unbind(2)  # strided views: the kernel reads them in place
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
