"""Startup warmup: make the first request pay nothing.

Counterpart of ``ddim_cold_tpu/serve/warmup.py``. PyTorch runs eagerly, so
what a first request would otherwise pay is building and loading the kernel
libraries, building a config's model variant (the int8 state of a quant
config), the first launch of each kernel, and the first use of each
(config, bucket) batch shape (cuBLAS handles and workspaces, the caching
allocator's blocks), and, for a cached config, allocating its spare step
cache. ``warmup`` does all of it up front (``Engine.warm``): it loads the
kernels, then for
every (config, bucket) allocates the spare cache (``Engine.prewarm_cache``)
and builds and runs the program once on a zero batch. The libraries loaded
are those of every warmed config's variant
(``DiffusionViT.kernel_libraries``). ``Engine.stats["programs"]`` counts
the warmed pairs; serving a warmed set adds none (the tests pin it). A
program that fails to warm raises, or with ``tolerate_errors=True`` is
recorded and skipped, as in the JAX package.

Sequence-parallel configs (``sp_degree > 1``) warm like any other: every
degree's ``(data, seq)`` mesh is built first, and the report's
``sp_meshes`` lists them (``{degree: {axis: size}}``, JAX's key).

An engine across ranks (``Engine(mesh=...)``) warms on every rank in
lockstep: every rank calls ``warmup`` with the same configs, and
:meth:`Engine.warm` does the ranks' part (the table of configs they can
run, the meshes built on every rank at once, rank 0 running each program as
it serves a batch while the others follow).

JAX's ``persistent_cache``, ``cache_dir`` and ``dedup`` have no
counterpart: there is no compiler cache to wire (the kernel libraries are
built once into ``build/`` and loaded from there by every process) and no
traced program to fingerprint and alias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ddim_cold_torch.serve.batching import SamplerConfig


def warmup(engine, configs: Sequence[SamplerConfig],
           buckets: Optional[Sequence[int]] = None, *,
           tolerate_errors: bool = False) -> dict:
    """Load the kernels and run every (config, bucket) program once;
    ``buckets=None`` means the engine's own buckets (the fleet router warms
    each replica with ``rep.warm(configs, buckets)``). Returns the number of
    programs this call added, the total, what was warmed, and ``errors``:
    ``{(config, bucket): exception}``.

    ``tolerate_errors=True`` keeps warming the remaining programs when one
    fails (degraded startup beats no startup: a config whose program is
    broken fails at its own dispatch instead of taking the deployment
    down); by default the first failure raises. The counts are emitted as
    ``warmup.*`` under the engine's metrics scope."""
    buckets = tuple(buckets) if buckets is not None else engine.buckets
    before = engine.stats["programs"]
    warmed = engine.warm(configs, buckets, tolerate_errors=tolerate_errors)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    programs = engine.stats["programs"]
    engine.metrics.inc("warmup.new_programs", programs - before)
    engine.metrics.gauge("warmup.programs", programs)
    return {
        "new_programs": programs - before,
        "programs": programs,
        "buckets": buckets,
        "configs": len(set(configs)),
        "sp_meshes": warmed["sp_meshes"],
        "errors": warmed["errors"],
    }
