"""The large-logit backward fixture against the JAX package's backward.

``ddim_cold_torch/tools/data/bwd_large_logits.npz`` holds the inputs of the
failing case of ROADMAP.md Queue 3 ((B, N, H, D) = (2, 129, 2, 32), the CUDA
generator seeded with 6, q, k, v ×8, bfloat16), drawn on the card by
``python3 -m ddim_cold_torch.tools.bwd_fixture``, and the JAX package's O,
lse, dq, dk and dv at them. The card cannot run JAX, so the card test
``test_torch_port_kernels.py::test_flash_backward_large_logits_against_jax``
reads them from the file; this file pins the file to the reference:

* the JAX package's forward and backward (``_fwd_kernel``, ``_bwd_dq_kernel``
  and ``_bwd_dkv_kernel`` in interpret mode, float32 matmul precision),
  recomputed here from the stored inputs, equal the stored arrays bit for
  bit;
* the port's plain version, on the CPU at the same inputs, O and lse, lies
  within ``grad_error_limit`` of the JAX gradients;
* the diagnosis of the Queue 3 fault, in float64 from the stored inputs,
  lse and O: the dS element the kernel rounds the other way lies closer to
  its bf16 rounding boundary than float32 can resolve, so no float32
  ordering is held to JAX's side of it, and a dS carried unrounded moves dq
  further from JAX's, not closer.

Run as a script on the CPU to (re)write the fixture from the inputs the
card wrote::

    JAX_PLATFORMS=cpu python3 tests/test_torch_port_bwd_fixture.py inputs.npz
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ddim_cold_torch.ops import flash_attention as fa  # noqa: E402
from ddim_cold_torch.tools import bwd_fixture  # noqa: E402
from ddim_cold_tpu.ops import flash_attention as jfa  # noqa: E402

#: the JAX package's default blocks (``flash_attention(..., block_q=256,
#: block_kv=512)``), legalised inside for N=129
BLOCK_Q, BLOCK_KV = 256, 512


def jax_reference(inputs: dict) -> dict:
    """The JAX package's O, lse and dq, dk, dv at ``inputs`` (int16 bit
    patterns of bfloat16 q, k, v, do), as fixture arrays."""
    q, k, v, do = (jnp.asarray(np.asarray(inputs[n]).view(ml_dtypes.bfloat16))
                   for n in bwd_fixture.INPUTS)
    B, N, H, D = q.shape
    scale = D**-0.5
    with jax.default_matmul_precision("float32"):
        o, lse = jfa._flash_forward(q, k, v, scale, BLOCK_Q, BLOCK_KV)
        dq, dk, dv = jfa._flash_backward(q, k, v, o, lse, do, scale, BLOCK_Q, BLOCK_KV)
    bits = lambda a: np.asarray(a).view(np.int16)  # noqa: E731
    out = {"o": bits(o), "lse": np.asarray(lse, np.float32)[:, :N].copy(),
           "dq": bits(dq), "dk": bits(dk), "dv": bits(dv)}
    out.update({n: np.asarray(inputs[n], np.int16) for n in bwd_fixture.INPUTS})
    return out


@pytest.fixture(scope="module")
def stored():
    with np.load(bwd_fixture.FIXTURE) as z:
        return {name: z[name] for name in z.files}


def test_fixture_holds_the_case(stored):
    c = bwd_fixture.CASE
    shape = (c["B"], c["N"], c["H"], c["D"])
    for name in bwd_fixture.BF16:
        assert stored[name].shape == shape and stored[name].dtype == np.int16, name
    assert stored["lse"].shape == (c["B"] * c["H"], c["N"])
    assert stored["lse"].dtype == np.float32
    # the gain put the logits where the fault shows: |lse| in the hundreds
    assert np.abs(stored["lse"]).max() > 100.0
    loaded = bwd_fixture.load("cpu")
    assert loaded["dq"].dtype == torch.bfloat16 and loaded["dq"].shape == shape


def test_fixture_is_the_jax_backward(stored):
    want = jax_reference(stored)
    for name in ("o", "lse", "dq", "dk", "dv"):
        np.testing.assert_array_equal(stored[name], want[name], err_msg=name)


def test_plain_version_is_within_the_limit_of_jax(stored):
    """At large logits the port's plain version (f32 einsums, dS rounded to
    bf16 where the TPU kernels round it) agrees with the JAX package's
    backward within the bare ``grad_error_limit``: the reference and the
    plain version round dS alike."""
    t = bwd_fixture.load("cpu")
    scale = bwd_fixture.CASE["D"] ** -0.5
    grad = fa.flash_backward_reference(t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"],
                                       scale)
    for i, name in enumerate(("dq", "dk", "dv")):
        ref = t[name]
        err = (grad[:, :, i].float() - ref.float()).abs()
        limit = fa.grad_error_limit(ref)
        assert bool((err <= limit).all()), (name, (err / limit).max().item())


#: the element of dS whose bf16 rounding the kernel flips: (b, h, row, key)
FLIP = (0, 1, 56, 83)


def test_queue3_flip_lies_inside_f32_rounding_noise():
    """ROADMAP.md Queue 3, recorded. In float64 from the fixture's bf16
    inputs and JAX's lse and O (P = exp(S·scale − lse), δ = rowsum(dO∘O),
    dS = P∘(dP − δ)): the flipped element of dS lies 5.94e-6 of itself above
    its bf16 rounding boundary, while rounding its exponent argument S·scale
    (140.80) to float32 alone moves P by 7.63e-6 relative, and the dot
    products' ordering error may move it by 4.2e-4: which side a float32
    computation lands on depends on its summation order. With dS
    rounded to bf16 as the kernels round it, dq reads ≤ 0.01× the limit of
    JAX's dq (0.0059×); with dS unrounded (what a hi/lo bf16 split of dS
    would compute) 11.19×, past it at 33 elements: a more precise dS moves
    the port away from JAX."""
    t = {n: a.double() for n, a in bwd_fixture.load("cpu").items()}
    c = bwd_fixture.CASE
    B, N, H, D = c["B"], c["N"], c["H"], c["D"]
    scale = D**-0.5
    arg = torch.einsum("bnhd,bmhd->bhnm", t["q"], t["k"]) * scale
    p = torch.exp(arg - t["lse"].reshape(B, H, N, 1))
    dp = torch.einsum("bnhd,bmhd->bhnm", t["do"], t["v"])
    delta = (t["do"] * t["o"]).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)

    exact = ds[FLIP].item()
    lo = np.float32(exact).view(np.int32) & ~0xFFFF  # the bf16 value below
    boundary = (np.int32(lo).view(np.float32)
                + np.int32(lo + 0x10000).view(np.float32)) / 2.0
    rel = (exact - float(boundary)) / exact
    half_ulp = float(np.spacing(np.float32(arg[FLIP].item()))) / 2.0
    assert abs(exact - 2.8984547) < 1e-6 and float(boundary) == 2.8984375
    assert 5.9e-6 < rel < 6.0e-6, rel
    assert abs(arg[FLIP].item() - 140.80) < 0.01
    # rounding the argument of exp to f32 moves P (relatively) by more
    # than dS's distance to its boundary, and an f32 dot product's ordering
    # error, D·2⁻²⁴·scale·Σ|q||k|, by far more again
    assert abs(half_ulp - 7.63e-6) < 1e-8 and half_ulp > rel
    b, h, row, key = FLIP
    order = D * 2.0**-24 * scale * (t["q"][b, row, h].abs() @ t["k"][b, key, h].abs()).item()
    assert abs(order - 4.2e-4) < 1e-5 and order > half_ulp

    ref = bwd_fixture.load("cpu")["dq"]
    limit = fa.grad_error_limit(ref).double()
    ratios = {}
    for name, d in (("rounded", ds.to(torch.bfloat16).double()), ("unrounded", ds)):
        dq = (scale * torch.einsum("bhnm,bmhd->bnhd", d, t["k"])).to(torch.bfloat16)
        ratios[name] = ((dq.double() - ref.double()).abs() / limit)
    assert ratios["rounded"].max().item() <= 0.01, ratios["rounded"].max().item()
    assert ratios["unrounded"].max().item() > 1.0
    assert abs(ratios["unrounded"].max().item() - 11.19) < 0.01
    assert int((ratios["unrounded"] > 1.0).sum()) == 33


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    jax.config.update("jax_platforms", "cpu")
    with np.load(argv[0]) as z:
        arrays = jax_reference({n: z[n] for n in bwd_fixture.INPUTS})
    bwd_fixture.FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(bwd_fixture.FIXTURE, **arrays)
    print(f"wrote {bwd_fixture.FIXTURE}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
