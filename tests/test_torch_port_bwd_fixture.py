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
  within ``grad_error_limit`` of the JAX gradients.

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
