"""Data, sequence, tensor, pipeline and expert parallelism, one process per device
(counterpart of ``ddim_cold_tpu/parallel/``): the mesh and its collectives
(:mod:`~ddim_cold_torch.parallel.mesh`), ring attention
(:mod:`~ddim_cold_torch.parallel.ring_attention`), Ulysses
(:mod:`~ddim_cold_torch.parallel.ulysses`), the Megatron shard plan over
the state_dict (:mod:`~ddim_cold_torch.parallel.sharding`), GPipe
microbatching (:mod:`~ddim_cold_torch.parallel.pipeline`) and the layout a
mesh selects (:mod:`~ddim_cold_torch.parallel.layout`), the ``expert``
axis of the Switch-MoE banks among its axes. JAX's ``_compat.py`` is a
shim over JAX versions and has no counterpart."""

from ddim_cold_torch.parallel.layout import layout_for_mesh, model_axes
from ddim_cold_torch.parallel.mesh import (
    data_axis_size,
    initialize_distributed,
    make_mesh,
    shard_batch,
    shard_params,
    shard_train_state,
    submesh,
)
from ddim_cold_torch.parallel.pipeline import make_pipelined_apply, pipeline_blocks
from ddim_cold_torch.parallel.ring_attention import ring_attention, ring_self_attention
from ddim_cold_torch.parallel.sharding import (
    gather_state_dict,
    param_partition_specs,
    pipeline_param_specs,
    shard_state_dict,
)
from ddim_cold_torch.parallel.ulysses import (
    SeqParallelConfigError,
    ulysses_attention,
    ulysses_self_attention,
)

__all__ = [
    "SeqParallelConfigError",
    "data_axis_size",
    "gather_state_dict",
    "initialize_distributed",
    "layout_for_mesh",
    "make_mesh",
    "make_pipelined_apply",
    "model_axes",
    "param_partition_specs",
    "pipeline_blocks",
    "pipeline_param_specs",
    "ring_attention",
    "ring_self_attention",
    "shard_batch",
    "shard_params",
    "shard_state_dict",
    "shard_train_state",
    "submesh",
    "ulysses_attention",
    "ulysses_self_attention",
]
