"""ctypes bindings to the native C++ host ETL (``native/gcnrec.cpp``).

The port's counterpart of ``gcn_recommendation_tpu/data/native_ext.py``:
the same two functions with the same ctypes signatures, over its own
build of the same source.  ``native/gcnrec.cpp`` is compiled as it stands,
with the flags of ``native/Makefile``, into
``gcn_recommendation_tpu_torch/_build/`` (git-ignored), under a name that
carries a hash of the source and the flags, so a changed source rebuilds.
Nothing is written under ``native/``.

Several processes may reach the first build together (test workers, the
ranks of a mesh): the build runs under a file lock, into a temporary name
that ``os.replace`` moves into place, so a loader sees the whole library
or none.  Callers (``graph/build.py``, ``data/prepare.py``) take the numpy
path when the library cannot be built or loaded, as the JAX package does;
``available()`` says which path runs.  This is host ETL, not a device
fallback: both paths compute the same arrays (the weights to about 2 ULP).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "gcnrec.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]  # native/Makefile's
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_lock = threading.Lock()


def _stem(source: str) -> str:
    return "lib" + os.path.splitext(os.path.basename(source))[0]


def library_path(build_dir: str = BUILD_DIR, source: str = SOURCE) -> str:
    """Where the library of the current source and flags is built."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([CXX, *CXX_FLAGS]).encode()).hexdigest()
    return os.path.join(build_dir, f"{_stem(source)}-{digest[:16]}.so")


def build_library(build_dir: str = BUILD_DIR, source: str = SOURCE) -> str:
    """Compile ``source`` (``native/gcnrec.cpp`` by default; the parquet
    decoder passes its own) into ``build_dir`` unless it is built already;
    returns the library's path.  Safe to call from several processes at
    once.  Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    out = library_path(build_dir, source)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, f"{_stem(source)}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # another process built it while we waited
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                res = subprocess.run(
                    [CXX, *CXX_FLAGS, "-o", tmp, source],
                    capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
                )
                if res.returncode != 0:
                    raise RuntimeError(f"{CXX} failed for {source}:\n{res.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gcnrec_kcore_filter.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.gcnrec_kcore_filter.restype = None
    lib.gcnrec_build_norm_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gcnrec_build_norm_edges.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None when it cannot be built
    or loaded (no compiler, no source), remembered for the process."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _load_lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _bind(ctypes.CDLL(build_library()))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _load_failed = True
    return _lib


def available() -> bool:
    """True when the native library is loaded (building it if needed)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def kcore_filter_native(users: np.ndarray, items: np.ndarray, k: int) -> np.ndarray:
    """Native K-core keep-mask; raises if the library is unavailable."""
    lib = _require()
    u = np.ascontiguousarray(users, dtype=np.int64)
    it = np.ascontiguousarray(items, dtype=np.int64)
    if u.shape != it.shape or u.ndim != 1:
        raise ValueError(f"users {u.shape} and items {it.shape} must be equal 1-D arrays")
    if len(u) and min(u.min(), it.min()) < 0:
        raise ValueError("user and item ids must be >= 0")
    keep = np.empty(len(u), dtype=np.uint8)
    lib.gcnrec_kcore_filter(
        _ptr(u, ctypes.c_int64), _ptr(it, ctypes.c_int64), len(u), int(k),
        _ptr(keep, ctypes.c_uint8),
    )
    return keep.astype(bool)


def build_norm_edges_native(rows: np.ndarray, cols: np.ndarray, num_nodes: int):
    """Native dedup-sum + ``D^-1/2 A D^-1/2`` + dst-major sort.

    Returns (dst, src, weight) with dtypes (int32, int32, float32).
    Raises if the library is unavailable.
    """
    lib = _require()
    r = np.ascontiguousarray(rows, dtype=np.int64)
    c = np.ascontiguousarray(cols, dtype=np.int64)
    if r.shape != c.shape or r.ndim != 1:
        raise ValueError(f"rows {r.shape} and cols {c.shape} must be equal 1-D arrays")
    if len(r) and (min(r.min(), c.min()) < 0 or max(r.max(), c.max()) >= num_nodes):
        raise ValueError(f"edge ids must lie in [0, {num_nodes})")
    n = len(r)
    out_dst = np.empty(n, dtype=np.int32)
    out_src = np.empty(n, dtype=np.int32)
    out_w = np.empty(n, dtype=np.float32)
    nnz = lib.gcnrec_build_norm_edges(
        _ptr(r, ctypes.c_int64), _ptr(c, ctypes.c_int64), n, int(num_nodes),
        _ptr(out_dst, ctypes.c_int32), _ptr(out_src, ctypes.c_int32),
        _ptr(out_w, ctypes.c_float),
    )
    return out_dst[:nnz], out_src[:nnz], out_w[:nnz]
