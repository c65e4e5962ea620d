"""Startup warmup: make the first request pay nothing.

Counterpart of ``ddim_cold_tpu/serve/warmup.py``. PyTorch runs eagerly, so
what a first request would otherwise pay is building and loading the kernel
libraries, building a config's model variant (the int8 state of a quant
config), the first launch of each kernel, and the first use of each
(config, bucket) batch shape (cuBLAS handles and workspaces, the caching
allocator's blocks), and, for a cached config, allocating its spare step
cache. ``warmup`` does all of it up front: it loads the kernels, then for
every (config, bucket) allocates the spare cache (``Engine.prewarm_cache``)
and builds and runs the program once on a zero batch. The libraries loaded
are those of every warmed config's variant
(``DiffusionViT.kernel_libraries``). ``Engine.stats["programs"]`` counts
the warmed pairs; serving a warmed set adds none (the tests pin it).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ddim_cold_torch.serve.batching import SamplerConfig


def warmup(engine, configs: Sequence[SamplerConfig]) -> dict:
    """Load the kernels and run every (config, engine bucket) program once.
    Returns the number of programs this call added, the total, and what was
    warmed."""
    buckets = engine.buckets
    before = engine.stats["programs"]
    engine.load_kernels(configs)
    for config in configs:
        for bucket in buckets:
            engine.prewarm_cache(config, bucket)
            engine.run_program(config, bucket, engine.zero_inputs(config, bucket))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    programs = engine.stats["programs"]
    return {
        "new_programs": programs - before,
        "programs": programs,
        "buckets": buckets,
        "configs": len(set(configs)),
    }
