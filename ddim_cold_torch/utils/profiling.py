"""Profiler traces, named scopes, numeric-debug hooks and latency statistics.

Counterpart of ``ddim_cold_tpu/utils/profiling.py``:

* ``trace(log_dir)`` — a ``torch.profiler`` capture (the CPU, and CUDA
  where the card is present) that writes Kineto's Chrome trace to
  ``log_dir/trace.json`` when it closes; ``start_trace`` / ``stop_trace``
  are its step-bounded form (the trainer's ``profile_steps``), and
  ``span_trace`` keys the directory to an ``obs.spans`` span.
  ``obs/attrib.py`` reads what they write.
* ``scope(name)`` — a named range around the work of one stage or kernel
  (``sampler/model``, ``flash_attention/fwd``, …): a ``record_function``
  range, which Kineto records as a ``user_annotation`` on the launching
  thread and which reaches NVTX when the caller runs under
  ``torch.autograd.profiler.emit_nvtx``. JAX's ``named_scope`` is metadata
  and costs nothing at run time; a ``record_function`` costs the host
  about 10 µs (a served batch opens about 700), so the range is opened
  only while a profiler is collecting on this thread, and a scope costs
  one check otherwise. It changes no numerics.
* ``annotate(name)`` — a host range of the same kind around a region.
* ``enable_nan_checks(enable)`` — the counterpart of ``jax_debug_nans``:
  raise where the first non-finite value appears (see the function).
"""

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


# ---------------------------------------------------------------- traces

#: the Chrome trace file every writer below leaves in its directory
TRACE_FILE = "trace.json"


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed work into ``log_dir/trace.json``
    (Kineto's Chrome trace: host operators, the ``scope`` ranges, and on
    the card every kernel, copy and set with its launch). Yields the
    profiler, whose ``events()`` stay readable after the block."""
    os.makedirs(log_dir, exist_ok=True)
    with _profiler() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


_ACTIVE: dict = {}


def start_trace(log_dir: str) -> None:
    """Step-bounded tracing (the trainer's ``profile_steps``): start here,
    ``stop_trace()`` when the window closes. One trace at a time, as
    ``jax.profiler.start_trace``."""
    if _ACTIVE:
        raise RuntimeError(f"a trace into {_ACTIVE['dir']} is already running")
    os.makedirs(log_dir, exist_ok=True)
    prof = _profiler()
    prof.start()
    _ACTIVE.update(prof=prof, dir=log_dir)


def stop_trace():
    """Close the trace ``start_trace`` opened and write its
    ``trace.json``; returns the profiler, whose ``events()`` stay
    readable."""
    if not _ACTIVE:
        raise RuntimeError("no trace is running")
    prof, log_dir = _ACTIVE.pop("prof"), _ACTIVE.pop("dir")
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    return prof


def span_trace(log_dir: str, span=None):
    """A :func:`trace` keyed to an ``obs.spans`` span: the Chrome trace
    lands in ``log_dir/trace_<trace_id>_<span_id>/trace.json``
    (``log_dir/trace.json`` when no span, or tracing is disabled), so a slow
    request's profiler timeline is findable from its span ids. Yields the
    profiler."""
    ctx = getattr(span, "ctx", None)
    if ctx is not None:
        log_dir = os.path.join(log_dir, f"trace_{ctx.trace_id}_{ctx.span_id}")
    return trace(log_dir)


# ---------------------------------------------------------------- ranges

def _range(name: str):
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def scope(name: str):
    """Named range around one stage's or one kernel's work, so a trace
    attributes its device time (``obs/attrib.py``). Opened only while a
    profiler collects on this thread; a no-op context otherwise."""
    return _range(name)


def annotate(name: str):
    """Named host range inside a trace (a region, a step)."""
    return _range(name)


# ------------------------------------------------------------ nan checks

_NAN: dict = {}


def enable_nan_checks(enable: bool = True, model=None) -> None:
    """Raise where the first non-finite value appears, the counterpart of
    ``jax_debug_nans``, in two parts:

    * the forward: a global module forward hook reads ``isfinite`` of every
      module's output (a host sync per module: a debug mode's price) and
      raises :class:`FloatingPointError` naming the first module whose
      output holds a NaN or an infinity — named by its path in ``model``
      when one is given, else by its class;
    * the backward: autograd's anomaly mode with ``check_nan=True``, which
      raises at the first backward function (the flash kernels'
      ``autograd.Function`` included) that returns a NaN.

    Both are process-wide: ``enable_nan_checks(False)`` removes the hook and
    puts anomaly mode back as it was before the checks were enabled."""
    import torch

    if not enable:
        if _NAN:
            _NAN.pop("hook").remove()
            torch.autograd.set_detect_anomaly(*_NAN.pop("anomaly"))
            _NAN.clear()
        return
    if _NAN:
        enable_nan_checks(False)
    names = {id(m): n for n, m in model.named_modules()} if model is not None else {}

    def tensors(out):
        if isinstance(out, (tuple, list)):
            for o in out:
                yield from tensors(o)
        elif isinstance(out, torch.Tensor) and out.is_floating_point():
            yield out

    def check_output(module, args, output):
        for t in tensors(output):
            if not bool(torch.isfinite(t).all()):
                name = names.get(id(module)) or type(module).__name__
                raise FloatingPointError(
                    f"non-finite output of module {name!r} "
                    f"({type(module).__name__}), shape {tuple(t.shape)}")

    _NAN["anomaly"] = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    _NAN["hook"] = torch.nn.modules.module.register_module_forward_hook(check_output)
    torch.autograd.set_detect_anomaly(True, check_nan=True)
