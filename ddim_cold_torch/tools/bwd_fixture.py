"""The large-logit flash backward case, and the JAX package's answer to it.

The bfloat16 backward kernels leave their plain version's ``grad_error_limit``
at large logits (ROADMAP.md Queue 3). This module pins that case so the
kernels can also be held against the JAX package's own backward
(``ddim_cold_tpu/ops/flash_attention.py`` ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``), which the card cannot run:

* :func:`large_logit_inputs` draws q, k, v (×gain) and dO from a seeded
  generator on a device, exactly as ``chip_smoke.py``'s ``bwd-large-logits``
  phase and ``tools/flash_bwd_probe.py`` do. At :data:`CASE` it must run on
  the card: the CUDA generator's numbers are the failing inputs.
* ``data/bwd_large_logits.npz`` (:data:`FIXTURE`) holds those inputs, and
  the JAX package's forward (O, lse) and backward (dq, dk, dv) at them, all
  computed on the CPU in interpret mode. bfloat16 arrays are stored as their
  int16 bit patterns. :func:`load` returns it as tensors.

Write the inputs on a CUDA machine from the repository root::

    python3 -m ddim_cold_torch.tools.bwd_fixture inputs.npz

then complete the fixture with JAX on the CPU (the test module holds the
JAX side, one definition for writing and for checking)::

    JAX_PLATFORMS=cpu python3 tests/test_torch_port_bwd_fixture.py inputs.npz
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

#: the failing case of ROADMAP.md Queue 3: (B, N, H, D), the generator's
#: seed and the gain on q, k and v
CASE = {"B": 2, "N": 129, "H": 2, "D": 32, "seed": 6, "gain": 8.0}
FIXTURE = Path(__file__).resolve().parent / "data" / "bwd_large_logits.npz"
INPUTS = ("q", "k", "v", "do")
#: bfloat16 arrays of the fixture; lse is float32
BF16 = INPUTS + ("o", "dq", "dk", "dv")


def large_logit_inputs(device, B: int, N: int, H: int, D: int, seed: int,
                       gain: float):
    """q, k, v (the slices of one ``(B, N, 3, H, D)`` buffer, ×gain) and dO,
    bfloat16, drawn in that order from ``torch.Generator(device)`` seeded
    with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = (torch.randn((B, N, 3, H, D), generator=gen, device=device) * gain).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn((B, N, H, D), generator=gen, device=device).to(torch.bfloat16)
    return q, k, v, do


def to_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor as a host int16 array of its bit patterns."""
    return t.detach().contiguous().view(torch.int16).cpu().numpy()


def from_bits(a: np.ndarray, device=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int16)).view(torch.bfloat16).to(device)


def load(device=None, path: Path = FIXTURE) -> dict:
    """The fixture as tensors on ``device``: q, k, v, do, o, dq, dk, dv
    ``(B, N, H, D)`` bfloat16 and lse ``(B·H, N)`` float32."""
    with np.load(path) as z:
        out = {name: from_bits(z[name], device) for name in BF16}
        out["lse"] = torch.from_numpy(z["lse"]).to(device)
    return out


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        raise SystemExit("the inputs come from the CUDA generator: run this on the card")
    tensors = large_logit_inputs("cuda", **CASE)
    np.savez(argv[0], **{n: to_bits(t) for n, t in zip(INPUTS, tensors)})
    print(f"wrote {', '.join(INPUTS)} of {CASE} to {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
