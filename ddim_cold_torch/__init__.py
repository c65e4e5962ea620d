"""PyTorch/CUDA port of the DDIM-COLD diffusion system, for NVIDIA Hopper.

The JAX package ``ddim_cold_tpu`` beside it is the reference; this package
never imports it. Module names mirror it:

* ``ops.schedule``        — DDIM schedule tables (numpy, identical to JAX's)
* ``ops.flash_attention`` — flash-attention forward: ``csrc/flash_fwd.cu``
                            on CUDA tensors, its plain version on CPU ones
* ``ops.sampling``        — ``ddim_sample``, ``ddim_inpaint``, ``ddim_sample_fewstep``,
                            ``cold_sample``, ``sample_from``, slerp interpolation
* ``workloads``           — inpaint, super-resolution, draft→drawing, interpolation
* ``models.vit``          — ``DiffusionViT`` (reference state_dict names)
* ``utils.weights``       — JAX parameter tree → this package's state_dict
* ``serve``               — bucketed ``Engine`` (tasks, previews, student) + ``warmup``
* ``__main__``            — ``python -m ddim_cold_torch train <ExpName>``

Entry points run on the card (``device=None`` means ``"cuda"``) and raise
when CUDA is missing; tests pass ``device="cpu"``.
"""
