"""Guided-editing workloads: inpainting, super-resolution, draft→drawing and
slerp interpolation, directly and served.

Counterpart of ``ddim_cold_tpu/workloads``. Each task is an (init state,
schedule suffix, per-step constraint) triple over ``ops/sampling.py``,
usable as one function call or as a ``SamplerConfig(task=...)`` through the
``Engine``, with the bitwise-vs-direct and no-program-after-warmup
contracts. ``preview.py`` pins the streaming-preview frame schedule
(``SamplerConfig(preview_every=m)`` + ``Ticket.previews()``).

Direct (``gen = torch.Generator("cuda").manual_seed(0)``)::

    from ddim_cold_torch import workloads
    out  = workloads.inpaint(model, gen, known, mask, k=10)
    hi   = workloads.super_resolve(model, low_res, level=3)
    img  = workloads.draft_to_drawing(model, gen, draft, t_start=1800)
    path = workloads.interpolate(model, gen, img_a, img_b, n_interp=8)

Served, with streaming previews::

    from ddim_cold_torch import serve, workloads
    eng = serve.Engine(model, buckets=(8, 32))
    serve.warmup(eng, workloads.default_edit_configs(preview_every=2))
    cfg = serve.SamplerConfig(task="draft", t_start=1800, preview_every=2)
    t = eng.submit(seed=0, x_init=draft, config=cfg)
    eng.run()
    for step, frames in t.previews():   # intermediate x̂0 frames, in order
        show(step, frames)
    final = t.result()

This package never imports ``serve`` at module level: serve/engine.py
imports it for the shared init functions.
"""

from ddim_cold_torch.workloads.preview import preview_indices
from ddim_cold_torch.workloads.tasks import (EDIT_TASKS, TASKS,
                                             default_edit_configs, draft_init,
                                             draft_to_drawing, inpaint,
                                             interp_init, interpolate,
                                             normalize_mask, super_resolve,
                                             superres_init, superres_project)

__all__ = [
    "EDIT_TASKS", "TASKS", "default_edit_configs", "draft_init",
    "draft_to_drawing", "inpaint", "interp_init", "interpolate",
    "normalize_mask", "preview_indices", "super_resolve", "superres_init",
    "superres_project",
]
