"""ctypes binding to the native C++ data pipeline (``native/ddim_data.cc``).

The port's own copy of ``ddim_cold_tpu/data/native.py``: the same entry
points over the same C++ source, so a batch decoded here is byte for byte
the JAX package's. The per-image work (libjpeg/libpng decode, the
torch-convention bilinear resize, the cold degradation, batch assembly) runs
in a C++ thread pool that fills numpy-owned buffers: no Python and no GIL on
the hot path. Every entry point returns None where the library cannot help
(not built, a format it rejects), and the caller takes the PIL/numpy path
for that file alone (``data/datasets.py``): the tier is an accelerator,
never a dependency. ``DDIM_COLD_NO_NATIVE=1`` turns it off (read at every
call).

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` (``-ffp-contract=off`` keeps the float32 arithmetic
bit-exact with ``data/resize.py``) into ``build/ddim_cold_torch/``, named
with a hash of the source and the flags, written to a temp file and renamed
into place, so concurrent processes never load half a file. It never writes
or loads ``native/libddim_data.so``, which the JAX package builds for
itself. A build the compiler refuses (a machine without the libjpeg or
libpng headers) leaves its output in ``<library>.err``, and later processes
read that instead of running ``g++`` again: delete the file to retry.

Host-only: numpy and the standard library; no torch, no PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "ddim_data.cc")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "ddim_cold_torch")
#: ``native/Makefile``'s CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")
KILL_SWITCH = "DDIM_COLD_NO_NATIVE"

#: formats the native decoder handles; everything else goes through PIL.
NATIVE_EXTS = {".jpg", ".jpeg", ".png"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_build_error: Optional[str] = None  # guarded-by: _lock


def library_path() -> str:
    """Where the library builds to: keyed by the source and the flags."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return os.path.join(BUILD_DIR, f"libddim_data-{digest.hexdigest()[:16]}.so")


def build_error() -> Optional[str]:
    """The compiler's output when the build failed (None otherwise)."""
    return _build_error


def _build(out: str) -> bool:
    global _build_error
    err = f"{out}.err"
    if os.path.isfile(err):  # an earlier process's compiler refused this source
        with open(err) as f:
            _build_error = f.read()
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, "-shared", SOURCE, "-o", tmp, *LDLIBS],
                              capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:  # no g++, or it hung
        _build_error = repr(e)
        return False
    if proc.returncode != 0:
        _build_error = proc.stderr or proc.stdout
        if os.path.exists(tmp):
            os.unlink(tmp)
        with open(f"{err}.{os.getpid()}.tmp", "w") as f:
            f.write(_build_error)
        os.replace(f"{err}.{os.getpid()}.tmp", err)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if os.environ.get(KILL_SWITCH):
        return None
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        out = library_path() if os.path.isfile(SOURCE) else None
        if out is None or not (os.path.isfile(out) or _build(out)):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            _lib_failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        charpp = ctypes.POINTER(ctypes.c_char_p)
        c_int = ctypes.c_int
        for name, argtypes, restype in (
                ("ddim_load_base", [ctypes.c_char_p, c_int, c_int, f32p], c_int),
                ("ddim_cold_degrade", [f32p, c_int, c_int, c_int, f32p], None),
                ("ddim_cold_item", [ctypes.c_char_p, c_int, c_int, c_int, f32p, f32p],
                 c_int),
                ("ddim_cold_batch", [charpp, i32p, c_int, c_int, c_int, c_int, f32p,
                                     f32p, i32p], c_int),
                ("ddim_base_batch", [charpp, c_int, c_int, c_int, c_int, f32p, i32p],
                 c_int),
                ("ddim_cold_pair_batch", [f32p, i32p, c_int, c_int, c_int, c_int, f32p,
                                          f32p], None),
                ("ddim_decode_batch", [charpp, c_int, c_int, c_int, c_int, u8p, i32p],
                 c_int)):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loaded (building it if needed)."""
    return _load() is not None


def has_decode_batch() -> bool:
    """True when the raw-u8 decode entry point exists. The library is built
    from the checkout's source, so this is :func:`available`; the datasets
    gate the uint8 transfer mode on it, as the JAX package's do."""
    lib = _load()
    return lib is not None and hasattr(lib, "ddim_decode_batch")


def supports(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in NATIVE_EXTS


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def load_base(path: str, out_hw: tuple[int, int]) -> Optional[np.ndarray]:
    """decode → [0,1] → bilinear resize → [−1,1]; None on decode failure."""
    lib = _load()
    if lib is None or not supports(path):
        return None
    h, w = out_hw
    out = np.empty((h, w, 3), np.float32)
    if lib.ddim_load_base(path.encode(), h, w, _f32(out)):
        return None
    return out


def cold_degrade(img: np.ndarray, level_scale: int) -> Optional[np.ndarray]:
    """Native D(x, s) for a square (S, S, C) float32 array; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    size, _, c = img.shape
    out = np.empty_like(img)
    lib.ddim_cold_degrade(_f32(img), size, c, int(level_scale), _f32(out))
    return out


def cold_item(path: str, size: int, t: int, chain: bool):
    """(D(x,t), target) for one file; None on failure → caller uses PIL."""
    lib = _load()
    if lib is None or not supports(path):
        return None
    noisy = np.empty((size, size, 3), np.float32)
    target = np.empty((size, size, 3), np.float32)
    if lib.ddim_cold_item(path.encode(), size, int(t), int(chain), _f32(noisy),
                          _f32(target)):
        return None
    return noisy, target


def cold_batch(paths: Sequence[str], ts: Sequence[int], size: int, chain: bool,
               num_threads: int = 8):
    """A whole (noisy, target) batch assembled in C++ threads straight into
    the final buffers. The C layer sniffs magic bytes itself, so unsupported
    or corrupt files set their slot in ``failed_mask`` for the caller's PIL
    redo. Returns ``(noisy, target, failed_mask)`` or None when the library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    noisy = np.empty((n, size, size, 3), np.float32)
    target = np.empty((n, size, size, 3), np.float32)
    failed = np.zeros(n, np.int32)
    ts_arr = np.asarray(ts, np.int32)
    lib.ddim_cold_batch(_paths_array(paths), _i32(ts_arr), n, size, int(chain),
                        int(num_threads), _f32(noisy), _f32(target), _i32(failed))
    return noisy, target, failed.astype(bool)


def cold_pair_batch(bases: np.ndarray, ts: Sequence[int], chain: bool,
                    num_threads: int = 8):
    """(D(x,t), target) pairs from already-decoded (n, S, S, 3) bases (the
    cache's warm-epoch path: no file IO, degrade in C++ threads). Returns
    ``(noisy, target)`` or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    bases = np.ascontiguousarray(bases, np.float32)
    n, size = bases.shape[0], bases.shape[1]
    noisy = np.empty_like(bases)
    target = np.empty_like(bases)
    ts_arr = np.asarray(ts, np.int32)
    lib.ddim_cold_pair_batch(_f32(bases), _i32(ts_arr), n, size, int(chain),
                             int(num_threads), _f32(noisy), _f32(target))
    return noisy, target


def decode_batch(paths: Sequence[str], out_hw: tuple[int, int], num_threads: int = 8):
    """Raw RGB8 batch for the uint8 transfer path: a slot succeeds only when
    its file decodes at exactly ``out_hw`` (no resize: the bytes are the
    pixels before normalization). Returns ``(u8_batch, failed_mask)`` or
    None when the library is unavailable; failed slots take the float path."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.uint8)
    failed = np.zeros(n, np.int32)
    lib.ddim_decode_batch(_paths_array(paths), n, h, w, int(num_threads),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          _i32(failed))
    return out, failed.astype(bool)


def base_batch(paths: Sequence[str], out_hw: tuple[int, int], num_threads: int = 8):
    """Batch of [−1,1] bases (decode and resize); ``(base, failed_mask)`` or
    None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.float32)
    failed = np.zeros(n, np.int32)
    lib.ddim_base_batch(_paths_array(paths), n, h, w, int(num_threads), _f32(out),
                        _i32(failed))
    return out, failed.astype(bool)
