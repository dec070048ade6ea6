"""Spans, and the device trace of a ``--trace 1`` window.

``Spans`` keeps the benchmark's own spans in memory: host-clock seconds
around calls into a layer (synchronised on the card first, so that the
span holds the device's work).  CUDA events around a call are
``benchmark.timing.CudaSpan``.

``DeviceTrace`` runs ``torch.profiler`` over the measured window with CUDA
activity only (CUPTI: the device's operations and the host's CUDA calls;
recording every PyTorch operator on the host as well slowed a books
training step by 7-20% and inflated its idle share from ~4% to 9-19%),
and reduces it to what the result line carries: the seconds in which
some operation ran on the card (the union of the device events'
intervals: kernels, copies and sets), the traced window's length, the
device operations that took most time, and the idle gaps between device
operations, named by the innermost CUDA call the host was in at the
middle of each gap, or as host Python when it was in none.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

TOP = 10


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    def __init__(self, device):
        self.device = device
        self.host: Dict[str, List[float]] = defaultdict(list)   # seconds

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock seconds of the block, the card synchronised at both ends."""
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self.host[name].append(time.perf_counter() - t)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    """``torch.profiler`` over a window when ``on``; a no-op otherwise."""

    def __init__(self, on: bool, device):
        self.on = bool(on)
        self.device = device
        self.summary = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            cuda = torch.device(self.device).type == "cuda"
            self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            self.prof.__enter__()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return
        sync(self.device)
        t1 = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self._reduce(self.prof.profiler.kineto_results.events(),
                                        (t1 - self.t0) * 1e-9)
        del self.prof

    @staticmethod
    def _reduce(events, window_s: float) -> dict:
        dev, host = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.duration_ns(), e.name()))
        by_name = defaultdict(int)
        for s, t, name in dev:
            by_name[name] += t - s
        busy = _merge([(s, t) for s, t, _ in dev])
        busy_ns = sum(t - s for s, t in busy)
        # idle gaps between device operations, named by the innermost host
        # operation that covers each gap's middle
        host.sort()
        starts = [h[0] for h in host]
        gaps = defaultdict(int)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) // 2
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            # host ops are nested, so the innermost one covering ``mid`` is
            # the latest-starting one that still covers it; look back a few
            for j in range(i, max(-1, i - 64), -1):
                s, d, name = host[j]
                if s + d >= mid:
                    best = name
                    break
            gaps[best or "host python, no CUDA call"] += b - a
        top = lambda d: [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda x: -x[1])[:TOP]]
        return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
                "device_ops": top(by_name), "idle_gaps": top(gaps)}
