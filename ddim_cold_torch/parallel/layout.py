"""Mesh axes → the parameter layout and the apply function (counterpart of
``ddim_cold_tpu/parallel/layout.py``), shared by the trainer and the tests
so they run the same wiring.

* a ``pipe`` axis: every block belongs to one stage, the ``model`` split
  inside it when the mesh has one (``sharding.pipeline_param_specs``), and
  the GPipe apply (``pipeline.make_pipelined_apply``);
* a ``model`` axis: Megatron's column/row plan
  (``sharding.param_partition_specs``);
* otherwise: every parameter replicated, the model's own forward.
"""

from __future__ import annotations

from typing import Callable, Optional

from ddim_cold_torch.parallel import mesh as pmesh


def model_axes(mesh) -> dict:
    """The sharding options a model built on ``mesh`` takes
    (``DiffusionViT(seq_mesh=mesh, **model_axes(mesh))``): ``head_axis`` for
    a ``model`` axis, ``pipe_axis`` and ``scan_blocks`` for a ``pipe`` axis
    (JAX's ``build_model`` forces the stacked layout under ``pipe``), each
    of more than one rank."""
    out = {}
    if pmesh.axis_size(mesh, "model") > 1:
        out["head_axis"] = "model"
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
    if pmesh.axis_size(mesh, "pipe") > 1:
        tensor_axes = ("model",) if pmesh.axis_size(mesh, "model") > 1 else ()
        return (pipeline_param_specs(state, tensor_axes=tensor_axes),
                make_pipelined_apply(model, mesh, n_microbatch=n_microbatch))
    if pmesh.axis_size(mesh, "model") > 1:
        return param_partition_specs(state, axes=("model",)), None
    return None, None
