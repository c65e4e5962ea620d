"""Step telemetry of the cached samplers: the host side.

Counterpart of ``ddim_cold_tpu/obs/device.py``, numpy-only. A cached DDIM
sampler asked for telemetry (``ddim_sample(..., telemetry=True)``,
``SamplerConfig(telemetry=True)``) returns, beside the images, per step the
cache branch actually taken (after the adaptive drift gate) and the gate's
drift: :class:`StepTelemetry`. The serving engine decodes it once per batch
with :func:`summarize` into ``Ticket.telemetry``.

Layout: ``branch`` — int32 ``(n_steps,)``, 0 = refresh
(``ops/schedule.CACHE_REFRESH``); ``drift`` — float32 ``(n_steps,)``, the
batch-max relative drift of the adaptive gate (0 in the other modes). The
port's samplers know ``branch`` on the host and leave ``drift`` on the
sampling device; :func:`summarize` takes host arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ddim_cold_torch.ops import schedule


class StepTelemetry(NamedTuple):
    """The cached sampler's per-step aux."""

    branch: "np.ndarray"  # (n_steps,) int32 — branch taken, post-gate
    drift: "np.ndarray"   # (n_steps,) float32 — adaptive drift (0 otherwise)


def static_schedule(n_steps: int, cache_interval: int,
                    cache_mode: str = "delta") -> np.ndarray:
    """The branch sequence of the static schedule alone: what the gate's
    output is at τ = ∞ (it never promotes), and the baseline promoted
    refreshes are counted against."""
    return np.asarray(
        schedule.cache_branch_sequence(n_steps, cache_interval, cache_mode),
        dtype=np.int32)


def summarize(tel: StepTelemetry, *, cache_interval: int,
              cache_mode: str, cache_threshold: float = 0.0,
              cache_tokens: int = 0) -> dict:
    """The per-ticket summary dict of a telemetry aux (host arrays).

    ``promoted_refreshes`` counts the reuse steps the adaptive gate turned
    into refreshes beyond the static schedule: 0 in the other modes, and
    the quantity the drift threshold τ trades against speed.
    """
    branch = np.asarray(tel.branch)
    drift = np.asarray(tel.drift, dtype=np.float64)
    n_steps = int(branch.size)
    refreshes = int(np.sum(branch == schedule.CACHE_REFRESH))
    planned = static_schedule(n_steps, cache_interval, cache_mode)
    planned_refreshes = int(np.sum(planned == schedule.CACHE_REFRESH))
    return {
        "steps": n_steps,
        "cache_mode": cache_mode,
        "cache_interval": cache_interval,
        "cache_threshold": cache_threshold,
        "cache_tokens": cache_tokens,
        "refreshes": refreshes,
        "reuses": n_steps - refreshes,
        "planned_refreshes": planned_refreshes,
        "promoted_refreshes": refreshes - planned_refreshes,
        "refresh_ratio": round(refreshes / n_steps, 4) if n_steps else 0.0,
        "drift_max": float(drift.max()) if n_steps else 0.0,
        "drift_mean": float(drift.mean()) if n_steps else 0.0,
        "branch": branch.tolist(),
        "drift": [round(float(d), 6) for d in drift],
    }
