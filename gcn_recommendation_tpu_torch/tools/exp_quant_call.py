"""Experiment: the int8 quantizer's kernel variants and the host's cost of one call.

Two questions about ``csrc/quant_int8.cu`` and its wrapper in
``ops/quant.py``, answered on the card:

* the kernel: the lane-group kernel with its constants as shipped
  (``base``) and with a few lines of its source replaced (one, four or eight
  rows in flight per group, a register cap for six or eight resident blocks
  an SM, blocks of 128 threads, streaming loads and stores; and, for its
  time only, a multiply in place of the IEEE division), each built beside
  the real library, held against the plain version bit for bit in both
  rounding modes, and timed twice at the catalog shape [20000, 64], at
  [2000000, 64] (where the bytes decide, not the launch floor) and at
  request shapes in the nearest mode; beside them the first version of this
  port's kernel (one warp a row, ``quantize_rows_int8_launch_v1``) and a
  kernel that does nothing on the same grid (the launch floor);
* the call: what each host step of a wrapper costs (two ``torch.empty``,
  the library lookup, the device context, the stream lookup, wrapping
  every argument for ctypes), and one eager call of the first wrapper
  (rebuilt here from those steps) against today's, with and without
  ``out=`` buffers.

    python -m gcn_recommendation_tpu_torch.tools.exp_quant_call

Needs a CUDA card and ``nvcc``.  Prints one JSON line per measurement.
``ms`` is on the card (CUDA graph replay of 20 launches, median of 5),
``call_ms`` the time of one call in an eager loop (CUDA events), ``us`` a
host-clock time per step.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from gcn_recommendation_tpu_torch.kernels import _build
from gcn_recommendation_tpu_torch.ops import quant
from gcn_recommendation_tpu_torch.tools.exp_tile_variants import variant_source
from gcn_recommendation_tpu_torch.utils.timing import cuda_ms, graph_ms

HBM_BYTES_PER_S = 3.35e12
STOCHASTIC, NEAREST = 0, 1
# (n, d): every lane-group width, two and four float4s a lane, the
# warp-per-row path (d % 4 != 0, d > 512), ragged row counts
CHECK_SHAPES = ((20_000, 64), (1_024, 64), (1_000, 48), (37, 50), (8, 64), (32, 64),
                (64, 48), (9, 4), (9, 8), (9, 16), (33, 32), (7, 200), (100, 256),
                (100, 512), (5, 516), (3, 1000), (2_000_000, 64))
VARIANT_CHECK_SHAPES = ((20_000, 64), (1_000, 48), (37, 50), (100, 256))
TIMED = ((20_000, 64, STOCHASTIC), (2_000_000, 64, STOCHASTIC), (2_000_000, 64, NEAREST),
         (1_024, 64, NEAREST), (64, 64, NEAREST))

_ROWS = "constexpr int kRowsInFlight = 2;"
_BOUNDS = "__launch_bounds__(kBlockThreads)\nquantize_rows_vec_kernel"
# name -> [(text in csrc/quant_int8.cu, its replacement)]
VARIANTS = {
    "base": [],
    "rows1": [(_ROWS, "constexpr int kRowsInFlight = 1;")],
    "rows4": [(_ROWS, "constexpr int kRowsInFlight = 4;")],
    "rows8": [(_ROWS, "constexpr int kRowsInFlight = 8;")],
    "min_blocks_6": [(_BOUNDS, "__launch_bounds__(kBlockThreads, 6)\nquantize_rows_vec_kernel")],
    "min_blocks_8": [(_BOUNDS, "__launch_bounds__(kBlockThreads, 8)\nquantize_rows_vec_kernel")],
    "block128": [("constexpr int kBlockThreads = 256;", "constexpr int kBlockThreads = 128;")],
    "streaming": [("? x[row * d4 + j]", "? __ldcs(&x[row * d4 + j])"),
                  ("q[row * q_stride_words + j] = word;",
                   "__stcs(&q[row * q_stride_words + j], word);")],
    # wrong results, timed only: what the IEEE division costs
    "no_div": [("const float t = __fdiv_rn(x, scale);", "const float t = x * scale;")],
}
TIME_ONLY = {"no_div"}
PASSES = 2  # every variant is timed in two passes over the list: the spread of one card


# ms of one call in an eager loop: 200 calls a window, after 20 warm-up calls
_call_ms = functools.partial(cuda_ms, reps=200, warmup=20)


def _host_us(fn, reps: int = 5000) -> float:
    """Host-clock microseconds of one ``fn()`` (median of 5 loops)."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    return statistics.median(times)


def _plain(x, mode, seed):
    if mode == STOCHASTIC:
        return quant._quantize_rows_int8_reference(x, seed)
    return quant._quantize_users_int8_reference(x)


def _launch(lib, x, mode, seed, q=None, scales=None):
    """The launcher of ``lib`` called directly."""
    if q is None:
        q, scales = quant._empty_out(x)
    err = lib.quantize_rows_int8_launch(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), x.shape[0], x.shape[1], q.stride(0),
        mode, seed, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return q, scales


def _launch_v1(lib, x, seed, q=None, scales=None):
    if q is None:
        q, scales = quant._empty_out(x)
    err = lib.quantize_rows_int8_launch_v1(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), x.shape[0], x.shape[1], seed,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"v1 launch failed: CUDA error {err}")
    return q, scales


def check_variant(lib, dev, shapes, with_v1: bool) -> None:
    """``lib``'s kernel against the plain version, bit for bit, in both
    modes; also from a base that is 4- but not 16-byte aligned and into
    strided output rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, d in shapes:
        x = torch.randn((n, d), generator=gen, device=dev) * 0.05
        x[0] = 0.0  # the 1e-12 absmax guard
        for mode in (STOCHASTIC, NEAREST):
            want = _plain(x, mode, 77)
            got = {"kernel": _launch(lib, x, mode, 77)}
            if with_v1 and mode == STOCHASTIC:
                got["v1"] = _launch_v1(lib, x, 77)
            torch.cuda.synchronize()
            for name, (q, s) in got.items():
                if not (torch.equal(q, want[0]) and torch.equal(s, want[1])):
                    raise SystemExit(f"FAILED: {name} mode {mode} differs from plain at [{n}, {d}]")
            del want, got
        del x
    flat = torch.randn(1000 * 64 + 1, generator=gen, device=dev)
    x = flat[1:].view(1000, 64)
    pad = torch.zeros((1000, 72), dtype=torch.int8, device=dev)
    scales = torch.empty((1000, 1), device=dev)
    for mode in (STOCHASTIC, NEAREST):
        want = _plain(x, mode, 5)
        q, s = _launch(lib, x, mode, 5, pad[:, :64], scales)
        torch.cuda.synchronize()
        ok = torch.equal(q, want[0]) and torch.equal(s, want[1]) and not pad[:, 64:].any()
        if not ok:
            raise SystemExit(f"FAILED: misaligned base / strided rows, mode {mode}")


def time_variant(name, lib, dev, with_v1: bool) -> None:
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, d, mode in TIMED:
        x = torch.randn((n, d), generator=gen, device=dev) * 0.05
        q, s = quant._empty_out(x)
        nbytes = 4 * n * d + n * d + 4 * n
        row = {"variant": name, "shape": [n, d],
               "mode": "stochastic" if mode == STOCHASTIC else "nearest",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "ms": graph_ms(lambda: _launch(lib, x, mode, 3, q, s))}
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if with_v1:
            row["v1_ms"] = graph_ms(lambda: _launch_v1(lib, x, 3, q, s))
            row["v1_share_of_bound"] = row["bound_ms"] / row["v1_ms"]
            # the floor: a kernel that does nothing, on a grid of the shipped kernel's
            # size (at d = 64: 32 rows a block of 256 threads with two rows in flight, 16
            # with one; at most 8 blocks an SM); the stream is looked up inside the call,
            # which runs under the graph's capture stream
            per_block = 32 if n >= 32 * sms else 16
            blocks = min(-(-n // per_block), 8 * sms)
            row["empty_ms"] = graph_ms(lambda: lib.quant_int8_empty_launch(
                blocks, 256, torch.cuda.current_stream().cuda_stream))
            row["empty_grid"] = [blocks, 256]
        print(json.dumps(row), flush=True)
        del x, q, s


def run_variants(dev) -> None:
    """Build every variant (one nvcc each, all started together), check and
    time each."""
    with open(_build.source_path("quant_int8")) as f:
        source = f.read()
    signatures = _build._SIGNATURES["quant_int8"]
    with tempfile.TemporaryDirectory(prefix="quant_variants_") as tmp:
        builds = {}
        for name, edits in VARIANTS.items():
            cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
            with open(cu, "w") as f:
                f.write(variant_source(source, edits, "csrc/quant_int8.cu"))
            builds[name] = (so, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            libs = {}
            for name, (so, proc) in builds.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
                lib = libs[name] = ctypes.CDLL(so)
                for fn, (argtypes, restype) in signatures.items():
                    getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
                base = name == "base"
                if base:
                    regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                            if "Used " in ln]
                    print(json.dumps({"ptxas_registers": regs}), flush=True)
                if name not in TIME_ONLY:
                    check_variant(lib, dev, CHECK_SHAPES if base else VARIANT_CHECK_SHAPES, base)
                    print(json.dumps({"variant": name, "bit_equal": True}), flush=True)
            for _ in range(PASSES):
                for name, lib in libs.items():
                    time_variant(name, lib, dev, name == "base")
        finally:
            for _, proc in builds.values():
                if proc.poll() is None:
                    proc.kill()


def _first_wrapper(lib, x, seed):
    """The wrapper as it first was: two allocations, the library looked up,
    the device context entered, every argument wrapped for ctypes."""
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = _build.load_library("quant_int8")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_rows_int8_launch_v1(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_int64(n), ctypes.c_int(d),
            ctypes.c_uint32(int(seed) & 0xFFFFFFFF), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return q, scales


def time_call(lib, dev) -> None:
    x = torch.randn((20_000, 64), device=dev) * 0.05
    q, s = quant._empty_out(x)
    zero = torch.empty((0, 64), device=dev)  # the launcher returns at once: the call alone
    zq, zs = quant._empty_out(zero)
    index = x.device.index
    steps = {
        "two_torch_empty": lambda: quant._empty_out(x),
        "load_library_lookup": lambda: _build.load_library("quant_int8").quantize_rows_int8_launch,
        "current_device": torch.cuda.current_device,
        "stream_of_device": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "stream_of_current": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "three_data_ptr": lambda: (x.data_ptr(), q.data_ptr(), s.data_ptr()),
        "ctypes_call_wrapped_args": lambda: lib.quantize_rows_int8_launch_v1(
            ctypes.c_void_p(zero.data_ptr()), ctypes.c_void_p(zq.data_ptr()),
            ctypes.c_void_p(zs.data_ptr()), ctypes.c_int64(0), ctypes.c_int(64),
            ctypes.c_uint32(3), ctypes.c_void_p(0)),
        "ctypes_call_plain_ints": lambda: lib.quantize_rows_int8_launch_v1(
            zero.data_ptr(), zq.data_ptr(), zs.data_ptr(), 0, 64, 3, 0),
    }

    def device_context():
        with torch.cuda.device(x.device):
            pass

    steps["device_context"] = device_context
    print(json.dumps({"host_us_per_step": {k: _host_us(f) for k, f in steps.items()}}),
          flush=True)
    for n in (20_000, 1_024, 64):
        xs = x[:n].contiguous()
        out = quant._empty_out(xs)
        row = {
            "shape": [n, 64],
            "first_wrapper_call_ms": _call_ms(lambda: _first_wrapper(lib, xs, 3)),
            "call_ms": _call_ms(lambda: quant.quantize_rows_int8(xs, seed=3)),
            "call_ms_out": _call_ms(lambda: quant.quantize_rows_int8(xs, seed=3, out=out)),
            "nearest_call_ms_out": _call_ms(lambda: quant.quantize_users_int8(xs, out=out)),
            "plain_nearest_call_ms": cuda_ms(
                lambda: quant._quantize_users_int8_reference(xs), reps=50),
            # the host alone: the same calls with nothing waited for
            "first_wrapper_host_us": _host_us(lambda: _first_wrapper(lib, xs, 3), reps=500),
            "host_us": _host_us(lambda: quant.quantize_rows_int8(xs, seed=3), reps=500),
            "host_us_out": _host_us(lambda: quant.quantize_rows_int8(xs, seed=3, out=out),
                                    reps=500),
        }
        torch.cuda.synchronize()
        print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the experiment runs on the card only")
    dev = torch.device("cuda")
    run_variants(dev)
    time_call(_build.load_library("quant_int8"), dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
