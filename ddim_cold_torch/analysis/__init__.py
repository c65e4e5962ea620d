"""graftcheck of the port — static analysis of the ddim_cold_torch invariants.

Counterpart of ``ddim_cold_tpu/analysis/``, its host half and its kernel
layer, run over the port's own sources and kernels:

* :mod:`.ast_checks` — GRAFT-A001..A005 source lint.
* :mod:`.thread_checks` — GRAFT-T001..T005 lockset/lock-order analysis of
  the threaded host layer (``# guarded-by:`` annotation grammar).
* :mod:`.protocol_checks` — GRAFT-R001..R005 proofs of the fleet's RPC
  protocol.
* :mod:`.config_checks` — GRAFT-X001..X003 over the SamplerConfig lattice
  and :func:`.entries.serve_sweep`, its witness set.
* :mod:`.kernel_checks` — GRAFT-P001..P003 Hopper tile/launch legality,
  shared-memory fit and padding waste of every hand-written kernel at the
  geometries :func:`.entries.kernel_entries` registers.
* :mod:`.cli` — ``python -m ddim_cold_torch.analysis``; nonzero exit on
  non-baselined findings; ``--fix-baseline`` regenerates the reviewed
  allowlist (``--only`` limits it to selected rule families).

The trace layers (J, M, C, S) are still to port (ROADMAP Queue 1 item 19).
This module stays import-light: no torch until a layer needs it.
"""

from ddim_cold_torch.analysis.findings import RULES, Finding  # noqa: F401
