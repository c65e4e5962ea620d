"""Observability of the port.

* :mod:`ddim_cold_torch.obs.spans` — per-request trace spans created at
  ``Engine.submit`` and closed at delivery or failure, with the pipeline
  stages as child spans; exported as Chrome trace-event JSON or JSONL.
* :mod:`ddim_cold_torch.obs.metrics` — the process registry of named
  counters, gauges and histograms the engine, warmup and fault injection
  emit into; ``Engine.stats`` / ``Engine.health()`` are rendered from it.
* :mod:`ddim_cold_torch.obs.device` — the step-cached samplers' telemetry
  decoded into per-ticket summaries.

``spans`` and ``metrics`` are host-only (stdlib; no torch).
"""

from ddim_cold_torch.obs import device, metrics, spans

__all__ = ["device", "metrics", "spans"]
