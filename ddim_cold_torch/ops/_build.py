"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds); a source may include headers from ``csrc/``
(``#include "name.cuh"``). Libraries land in ``build/ddim_cold_torch/`` at
the repository root, keyed by a hash of the source, the headers it
includes and the flags, and are
built on first use by :func:`load_library`, each source under its own lock
(so two sources may build at once, from two threads).

Nothing here runs at import: the CPU tests import every module of the port,
and this machine-independent module only touches ``nvcc`` and the GPU when a
kernel is first asked for. There is no fallback: a missing toolkit, a failed
compile or a missing card raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddim_cold_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: per source ``csrc/<name>.cu``, the C signature of each of its entry
#: points (restype is always c_int: the launch's or the query's
#: cudaError_t). Beside each launcher, ``<name>_launch_config`` takes the
#: launcher's shape, dtype and mode arguments and writes the launch it
#: makes, and ``<name>_attributes`` the attributes of the kernel it launches
#: (``csrc/launch_query.cuh``), each into six long longs
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_F, _P],
        "flash_fwd_launch_config": [_I] * 5 + [_P],
        "flash_fwd_attributes": [_I] * 5 + [_P],
    },
    "flash_bwd": {
        "flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_L] * 15 + [_F, _P],
        "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_L] * 15 + [_F, _P],
        "flash_bwd_launch_config": [_I] * 6 + [_P],
        "flash_bwd_attributes": [_I] * 6 + [_P],
    },
    "dequant_mm": {
        "dequant_mm": [_P] * 5 + [_I] * 3 + [_L] + [_I] * 2 + [_P],
        "dequant_mm_launch_config": [_I] * 5 + [_P],
        "dequant_mm_attributes": [_I] * 5 + [_P],
    },
    "mlp_fused": {
        "mlp_fused": [_P] * 8 + [_I] * 9 + [_P],
        "mlp_fused_launch_config": [_I] * 9 + [_P],
        "mlp_fused_attributes": [_I] * 9 + [_P],
    },
    "fused_trunk": {
        "fused_trunk": [_P] * 8 + [_I] * 8 + [_F, _P],
        "fused_trunk_launch_config": [_I] * 8 + [_P],
        "fused_trunk_attributes": [_I] * 8 + [_P],
    },
}

# one lock per source: two sources build at once, one source builds once
_locks = {name: threading.Lock() for name in SIGNATURES}
_loaded: dict = {}  # name -> ctypes.CDLL, guarded-by: _locks[name]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at "
                       "first use")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header: the source first, then the headers sorted."""
    source = CSRC / f"{name}.cu"
    headers: set = set()
    todo = [source]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / inc
            if path.is_file() and path not in headers:
                headers.add(path)
                todo.append(path)
    return [source, *sorted(headers)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source, the headers
    it includes and the flags, so editing a header rebuilds every source
    that includes it and no other."""
    digest = hashlib.sha256()
    for path in _inputs(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed.
    Raises when CUDA is unavailable: the kernels have no CPU form."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device, and "
                           "torch.cuda.is_available() is False")
    with _locks[name]:
        lib = _loaded.get(name)
        if lib is None:
            _build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
