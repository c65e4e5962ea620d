"""Latency order statistics (counterpart of ``latency_summary`` in
``ddim_cold_tpu/utils/profiling.py``; profiler scopes come with the
observability slice, ROADMAP.md Queue 1 item 16)."""

from __future__ import annotations

import numpy as np


def latency_summary(samples_s) -> dict:
    """Order statistics over a list of latencies in seconds — the serving
    engine's per-request report."""
    arr = np.asarray(list(samples_s), dtype=np.float64)
    if arr.size == 0:
        return {"n": 0, "count": 0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0,
                "mean_s": 0.0, "max_s": 0.0}
    return {
        "n": int(arr.size),
        "count": int(arr.size),  # explicit alias: dashboards key on "count"
        "p50_s": float(np.percentile(arr, 50)),
        "p95_s": float(np.percentile(arr, 95)),
        "p99_s": float(np.percentile(arr, 99)),
        "mean_s": float(arr.mean()),
        "max_s": float(arr.max()),
    }
