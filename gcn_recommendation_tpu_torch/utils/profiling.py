"""Profiling and tracing hooks.

PyTorch counterpart of ``gcn_recommendation_tpu/utils/profiling.py``:

* ``StepTimer`` — wall-clock timing that waits for the device before it
  stops the clock: CUDA launches return before the work is done, so
  ``stop(sync_on=...)`` calls ``torch.cuda.synchronize`` on the device of
  the tensor (or of the first tensor of a dict, list or tuple) it is
  given.  A CPU tensor needs no wait;
* ``trace`` — context manager around ``torch.profiler.profile`` that
  writes a Chrome trace under ``$GCN_TPU_TRACE_DIR/<name>/`` (the variable
  the JAX package reads, so one setting serves both; the CLI's
  ``--profile_dir`` sets it) and does nothing when the variable is unset.

The trainer times its epochs inline (the step losses are fetched at the
epoch's end); StepTimer is for ad-hoc experiments.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch

TRACE_FILE = "trace.json"


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


class StepTimer:
    """Accumulates per-step durations; waits for the device on stop."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            leaf = _first_tensor(sync_on)
            if leaf is not None and leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.durations) / max(1, len(self.durations))

    def best(self, k: int = 3) -> float:
        """Mean of the k fastest steps (steady-state estimate)."""
        return sum(sorted(self.durations)[:k]) / max(1, min(k, len(self.durations)))


@contextlib.contextmanager
def trace(name: str = "train"):
    """``torch.profiler`` trace if GCN_TPU_TRACE_DIR is set, else no-op.
    The Chrome trace lands in ``$GCN_TPU_TRACE_DIR/<name>/trace.json``
    (CPU activity, and CUDA activity when a card is present)."""
    trace_dir = os.environ.get("GCN_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
