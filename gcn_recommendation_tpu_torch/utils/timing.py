"""Timers of the port's tools and of ``chip_smoke.py``, and the card's name.

* ``cuda_ms`` — the device's time of one call: CUDA events around
  ``reps`` back-to-back calls, the median over ``windows`` such windows,
  after ``warmup`` calls.  Launches return before the work is done, so the
  events, not the host clock, say when the device finished.  When the host
  cannot keep the device fed, the window holds the device's idle gaps too.
* ``graph_ms`` — the same with the host taken out: ``reps`` calls captured
  into one CUDA graph, its replays timed by ``cuda_ms``.
* ``host_ms`` — the caller's time of one call: host clock around ``fn()``
  followed by ``torch.cuda.synchronize()`` on a card (a CPU call needs no
  wait), the median over ``reps`` calls after ``warmup``.
* ``card_line`` — the card's name and power limit as ``nvidia-smi``
  reports them; ``device_line`` — what a tool prints first: the device it
  runs on.

A device time is never taken on the CPU: ``cuda_ms`` and ``graph_ms``
raise there instead of timing something else.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, List, Optional

import torch


def require_cuda(device=None) -> None:
    """Raise unless a device time can be taken (a card is present, and
    ``device``, when given, is a CUDA device)."""
    if device is not None and torch.device(device).type != "cuda":
        raise RuntimeError(f"a device time needs a CUDA device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no device time on the CPU")


def cuda_windows(fn: Callable[[], object], reps: int = 20, windows: int = 5,
                 warmup: int = 3, device=None) -> List[float]:
    """ms of one ``fn()`` in each of ``windows`` CUDA-event windows of
    ``reps`` back-to-back calls, after ``warmup`` calls."""
    require_cuda(device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def cuda_ms(fn: Callable[[], object], reps: int = 20, windows: int = 5, warmup: int = 3,
            device=None) -> float:
    """Median over ``cuda_windows``: the device's ms of one ``fn()``."""
    return statistics.median(cuda_windows(fn, reps, windows, warmup, device))


def graph_ms(fn: Callable[[], object], reps: int = 20, windows: int = 5) -> float:
    """ms of one ``fn()`` on the card without the host's share: ``reps``
    calls captured into one CUDA graph (after three warm-up calls on a side
    stream: builds, lazy initialisation), 5 replays a window timed by
    ``cuda_ms``."""
    require_cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5, windows=windows) / reps


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_windows(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
                 device=None) -> List[float]:
    """Host-clock ms of each of ``reps`` calls ``fn()``, each ending in a
    synchronize of ``device`` (none on the CPU), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def host_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2, device=None) -> float:
    """Median over ``host_windows``: the caller's ms of one ``fn()``."""
    return statistics.median(host_windows(fn, reps, warmup, device))


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_line(device: Optional[torch.device]) -> str:
    """The line a tool prints first: the device its numbers come from
    (a CPU run's times are labelled ``cpu``)."""
    if device is None or torch.device(device).type != "cuda":
        return "device: cpu (times below are the CPU's, not a card's)"
    return (f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
            f"({card_line()})")
