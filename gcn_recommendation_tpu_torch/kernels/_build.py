"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and is
compiled at first use with ``nvcc`` into a shared library under
``gcn_recommendation_tpu_torch/_build/`` (git-ignored), or under the
directory that ``GCN_TORCH_BUILD_DIR`` names when this module is first
imported, named by a hash of the source and the flags so a changed
source rebuilds.  The library is loaded with ``ctypes``; every pointer
and the stream pass as ``c_void_p``.  Nothing here runs at import time: a machine without
``nvcc`` imports this module and never calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
# read once, at import: a process that times a cold build points it at a
# fresh directory, where no library can have been built before
BUILD_DIR = os.environ.get("GCN_TORCH_BUILD_DIR") or os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# name -> (argtypes, restype) of the launcher
_SIGNATURES = {
    "quant_int8": {
        # x, q, scales, n, d, q_stride, mode, seed, row_offset, stream
        "quantize_rows_int8_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "quantize_rows_int8_launch_v1": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "quant_int8_empty_launch": (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int,
        ),
    },
    "tile_spmm": {
        "tile_spmm_launch": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
    },
    "masked_topk": {
        # scores, filter, rows, n, f, k, s, vec, threads, mask_value, out_val,
        # out_idx, stream
        "masked_topk_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "masked_topk_smem_bytes": (
            [ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int64,
        ),
        # topk_idx, true_items, valid, rows, width, k, hist, stream
        "topk_hit_histogram_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int,
        ),
    },
    "ell_spmm": {
        # table, n_entries, n_blocks, x, x_bf16, w_bf16, n, d, out, out_bf16, stream
        "ell_spmm_launch": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
    },
    "tile_gather_spmm": {
        "tile_gather_spmm_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
    },
}

KERNEL_SOURCES = tuple(sorted(_SIGNATURES))

_loaded: Dict[str, ctypes.CDLL] = {}
# a serving daemon's dispatcher thread and its main thread may both reach a
# first use: one of them builds and loads, the other waits and finds it
_load_lock = threading.Lock()
# compiler output of each build in this process (ptxas register report)
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns the wall seconds taken;
    raises with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    started: List = [(n, _start_build(n)) for n in names]
    errors = []
    for name, job in started:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed),
    with the launchers' argument types declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
    return lib
