"""Spans, counters and the operator's trace.

* ``span(name)`` — a context manager around one layer's work.  While
  collection is off (the default) it costs one check of a module flag and
  hands back a shared no-op object: it allocates, records and
  synchronises nothing.  While it is on, each span appends a
  ``SpanRecord`` on exit: its name, its start and end on
  ``torch.profiler``'s clock (``time.time_ns()``: the profiler's event
  times are Unix-epoch nanoseconds too, so a span and the events
  recorded inside it share one timeline), its native thread id and its
  parent, the innermost span open on the same thread.  Spans time the
  host's issue of the work and never wait for the device; which device
  work a span launched is for a trace to say (the launching runtime
  call's host time falls inside it).  On a card, autograd runs the
  backward on a thread of its own, so a backward's spans have no parent
  there: attribution goes by time, not by thread;
* ``count(name, n)`` — adds ``n`` to a named counter while collection is
  on; ``collecting()`` says whether it is, for a caller whose ``n`` costs
  something to work out;
* ``collect()`` — turns collection on for its body and yields the
  ``Recorder`` that holds the spans and counter totals;
* ``trace(name)`` — ``torch.profiler`` around its body when
  ``GCN_TPU_TRACE_DIR`` is set (the variable the JAX package reads, so
  one setting serves both; the CLI's ``--profile_dir`` sets it): a Chrome
  trace under ``$GCN_TPU_TRACE_DIR/<name>/``, in which each span is also a
  ``record_function`` range.  Nothing at all when the variable is unset.

The port's spans and its counters, by module:

    train.step, train.forward, train.loss,   train/trainer.py
    train.backward, train.adam
    spmm.forward, spmm.backward, spmm.hub,   ops/spmm.py (and the tile
    spmm.to_device                           path of ops/block_spmm.py)
    spmm.gathered_rows, spmm.kernel_slots    ops/spmm.py (the rows a propagation
    (counters)                               gathers; the ELL slots the bucket
                                             kernel reduced, 0 on the CPU)
    eval.validate, eval.metrics              train/trainer.py, train/evaluate.py
    topk.mask, topk.select, eval.metrics     ops/topk.py (topk.mask: the plain
                                             version only; on a card the
                                             kernel masks inside topk.select)
    topk.kernel_rows, eval.hist_rows         ops/topk.py (the rows the top-k
    (counters)                               kernel ranks, and that the hit
                                             histogram kernel reduces)
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"


class SpanRecord(NamedTuple):
    name: str
    start_ns: int       # time.time_ns(), the profiler's clock
    end_ns: int
    tid: int            # threading.get_native_id()
    id: int             # this span's number, in the order spans opened
    parent: Optional[int]  # the id of the innermost span open on its thread


@dataclasses.dataclass
class Recorder:
    spans: List[SpanRecord] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))


# The collection state: read by every span and counter, set only by
# collect() and trace().
_recorder: Optional[Recorder] = None
_ranges = False        # spans open record_function ranges (inside trace())
_open = threading.local()  # the spans open on this thread, innermost last
_ids = itertools.count()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rec", "id", "parent", "start", "range")

    def __init__(self, name: str, rec: Recorder):
        self.name, self.rec = name, rec

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        self.range = None
        if _ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        self.rec.spans.append(SpanRecord(self.name, self.start, end, threading.get_native_id(),
                                         self.id, self.parent))
        return False


def span(name: str):
    """A span named ``name`` around the ``with`` block (module docstring)."""
    if _recorder is None:
        return _NO_SPAN
    return _Span(name, _recorder)


def collecting() -> bool:
    return _recorder is not None


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while collection is on."""
    if _recorder is not None:
        _recorder.counters[name] += int(n)


@contextlib.contextmanager
def collect(ranges: bool = False):
    """Collection on for the body; yields the ``Recorder``.  Inside an
    outer ``collect()`` the outer recorder goes on collecting.  ``ranges``
    also opens a ``record_function`` range for each span (``trace()``)."""
    global _recorder, _ranges
    saved = _recorder, _ranges
    if _recorder is None:
        _recorder = Recorder()
    _ranges = ranges or _ranges
    try:
        yield _recorder
    finally:
        _recorder, _ranges = saved


@contextlib.contextmanager
def trace(name: str = "train"):
    """``torch.profiler`` trace, with the spans collected and shown as
    ranges, if GCN_TPU_TRACE_DIR is set, else no-op.  The Chrome trace
    lands in ``$GCN_TPU_TRACE_DIR/<name>/trace.json`` (CPU activity, and
    CUDA activity when a card is present)."""
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
    with profile(activities=activities) as prof, collect(ranges=True):
        yield
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
