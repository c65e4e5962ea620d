"""Data and sequence parallelism, one process per device (counterpart of
``ddim_cold_tpu/parallel/``): the mesh and its collectives
(:mod:`~ddim_cold_torch.parallel.mesh`), ring attention
(:mod:`~ddim_cold_torch.parallel.ring_attention`) and Ulysses
(:mod:`~ddim_cold_torch.parallel.ulysses`). JAX's ``_compat.py`` is a shim
over JAX versions and has no counterpart; tensor and pipeline parallelism
(``sharding.py``, ``pipeline.py``, ``layout.py``) are ROADMAP.md Queue 1
item 14."""

from ddim_cold_torch.parallel.mesh import (
    data_axis_size,
    initialize_distributed,
    make_mesh,
    shard_batch,
    shard_params,
    shard_train_state,
    submesh,
)
from ddim_cold_torch.parallel.ring_attention import ring_attention, ring_self_attention
from ddim_cold_torch.parallel.ulysses import (
    SeqParallelConfigError,
    ulysses_attention,
    ulysses_self_attention,
)

__all__ = [
    "SeqParallelConfigError",
    "data_axis_size",
    "initialize_distributed",
    "make_mesh",
    "ring_attention",
    "ring_self_attention",
    "shard_batch",
    "shard_params",
    "shard_train_state",
    "submesh",
    "ulysses_attention",
    "ulysses_self_attention",
]
