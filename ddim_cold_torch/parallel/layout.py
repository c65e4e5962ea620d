"""Mesh axes → the parameter layout and the apply function (counterpart of
``ddim_cold_tpu/parallel/layout.py``), shared by the trainer and the tests
so they run the same wiring.

* a ``pipe`` axis: every block belongs to one stage, the ``model`` and
  ``expert`` splits inside it when the mesh has them
  (``sharding.pipeline_param_specs``; JAX layout.py:26-37), and the GPipe
  apply (``pipeline.make_pipelined_apply``);
* a ``model`` or ``expert`` axis: Megatron's column/row plan and the
  expert banks' split (``sharding.param_partition_specs``);
* otherwise: every parameter replicated, the model's own forward.
"""

from __future__ import annotations

from typing import Callable, Optional

from ddim_cold_torch.parallel import mesh as pmesh


def model_axes(mesh) -> dict:
    """The sharding options a model built on ``mesh`` takes
    (``DiffusionViT(seq_mesh=mesh, **model_axes(mesh))``): ``head_axis`` for
    a ``model`` axis, ``expert_axis`` for an ``expert`` axis, ``pipe_axis``
    and ``scan_blocks`` for a ``pipe`` axis (JAX's ``build_model`` forces
    the stacked layout under ``pipe``), each of more than one rank."""
    out = {}
    if pmesh.axis_size(mesh, "model") > 1:
        out["head_axis"] = "model"
    if pmesh.axis_size(mesh, "expert") > 1:
        out["expert_axis"] = "expert"
    if pmesh.axis_size(mesh, "pipe") > 1:
        out.update(pipe_axis="pipe", scan_blocks=True)
    return out


def layout_for_mesh(model, mesh, params=None, *,
                    n_microbatch: int = 2) -> tuple[Optional[dict], Optional[Callable]]:
    """→ (plan or None, apply_fn or None) for a model built with
    :func:`model_axes` (JAX's ``layout_for_mesh``): the key → ``KeyPlan``
    of ``params`` (default: the model's whole state_dict keys, which the
    model's own ``plan`` covers) and the pipelined apply under ``pipe``."""
    from ddim_cold_torch.parallel.pipeline import make_pipelined_apply
    from ddim_cold_torch.parallel.sharding import (param_partition_specs,
                                                   pipeline_param_specs)

    state = model.state_dict() if params is None else params
    tensor_axes = tuple(a for a in ("model", "expert") if pmesh.axis_size(mesh, a) > 1)
    if pmesh.axis_size(mesh, "pipe") > 1:
        return (pipeline_param_specs(state, tensor_axes=tensor_axes),
                make_pipelined_apply(model, mesh, n_microbatch=n_microbatch))
    if tensor_axes:
        return param_partition_specs(state, axes=tensor_axes), None
    return None, None
