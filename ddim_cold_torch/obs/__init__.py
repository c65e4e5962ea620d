"""Observability of the port.

* :mod:`ddim_cold_torch.obs.spans` — per-request trace spans created at
  ``Engine.submit`` and closed at delivery or failure, with the pipeline
  stages as child spans; exported as Chrome trace-event JSON or JSONL.
* :mod:`ddim_cold_torch.obs.metrics` — the process registry of named
  counters, gauges and histograms the engine, warmup and fault injection
  emit into; ``Engine.stats`` / ``Engine.health()`` are rendered from it.
* :mod:`ddim_cold_torch.obs.device` — the step-cached samplers' telemetry
  decoded into per-ticket summaries.
* :mod:`ddim_cold_torch.obs.attrib` — profiler-trace attribution: device
  time per named scope from Kineto's traces, flop/byte joins → achieved
  TFLOP/s, MFU, roofline class, fusion candidates.
* :mod:`ddim_cold_torch.obs.trend` — the ``BENCH_r*``/``MULTICHIP_r*``
  trajectory loader + noise-banded regression gate (``python -m
  ddim_cold_torch.obs.trend``).

``spans``, ``metrics``, ``attrib`` and ``trend`` are host-only (stdlib; no
torch).
"""

from ddim_cold_torch.obs import attrib, device, metrics, spans, trend

__all__ = ["attrib", "device", "metrics", "spans", "trend"]
