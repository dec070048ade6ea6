"""The device's time of a call: a frozen copy of the CUDA-event timer of
the port's ``utils/timing.py`` (``cuda_windows`` / ``cuda_ms``), for the
kernel cells that time one launch, and ``CudaSpan``, one such window
around a call, which the evaluation cell puts around each pass's parts.
Launches return before the work is done, so events recorded on the
stream, not the host clock, say when the device finished.
``cuda_windows`` raises on the CPU instead of timing something else.
"""

from __future__ import annotations

import statistics
from typing import Callable, List

import torch


class CudaSpan:
    """CUDA events around a call on the current stream; ``ms()`` after the
    work is done.  On the CPU it records nothing and ``ms()`` is None."""

    def __init__(self, device="cuda"):
        self.on = torch.device(device).type == "cuda"
        if self.on:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.on:
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.end.record()

    def ms(self):
        if not self.on:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def cuda_windows(fn: Callable[[], object], reps: int = 20, windows: int = 5,
                 warmup: int = 3) -> List[float]:
    """ms of one ``fn()`` in each of ``windows`` CUDA-event windows of
    ``reps`` back-to-back calls, after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no device time on the CPU")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        with CudaSpan() as span:
            for _ in range(reps):
                fn()
        times.append(span.ms() / reps)
    return times


def cuda_ms(fn: Callable[[], object], reps: int = 20, windows: int = 5, warmup: int = 3) -> float:
    """Median over ``cuda_windows``: the device's ms of one ``fn()``."""
    return statistics.median(cuda_windows(fn, reps, windows, warmup))
