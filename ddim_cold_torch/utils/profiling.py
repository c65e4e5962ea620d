"""Latency order statistics and span-keyed profiler traces (counterparts of
``latency_summary`` and ``span_trace`` in ``ddim_cold_tpu/utils/profiling.py``;
the ``record_function``/NVTX scopes come with the rest of the observability
layer, ROADMAP.md Queue 1 item 16)."""

from __future__ import annotations

import contextlib
import os

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


@contextlib.contextmanager
def span_trace(log_dir: str, span=None):
    """A ``torch.profiler`` session keyed to an ``obs.spans`` span: the
    Chrome trace lands in ``log_dir/trace_<trace_id>_<span_id>/trace.json``
    (``log_dir/trace.json`` when no span, or tracing is disabled), so a slow
    request's profiler timeline is findable from its span ids. Records the
    CPU, and CUDA where the card is present. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ctx = getattr(span, "ctx", None)
    if ctx is not None:
        log_dir = os.path.join(log_dir, f"trace_{ctx.trace_id}_{ctx.span_id}")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
