"""Device time by the program's own spans, in a ``--trace 1`` window.

The port records spans and counters while its collection is on
(``gcn_recommendation_tpu_torch/utils/profiling.py``: ``collect()``; a
span is a name, a thread, and its start and end on ``time.time_ns()``,
which is the clock of ``torch.profiler``'s events).  ``attribute``
ties each device operation of a window's CUDA-activity trace to them:

    the device event -> the runtime call that launched it (the same
    correlation id) -> that call's host start -> the spans, on any
    thread, whose interval holds it.

An operation counts towards the inclusive device time and launches of
every span name that holds its launch (so ``train.step`` counts what its
``spmm.backward`` launched on autograd's own thread), and each idle gap
between device operations is named by the shortest span that holds its
middle, or ``outside program spans``.  From that, ``layer_metrics``
gives the per-layer numbers of a cell: device ms a step (or validation
pass) under propagation, the hub product, masking and selection, device
operations launched a step, gathered rows a step, and the host seconds
of the graph's layout and upload in set-up.

The load modules do not open the program's collection yet.  Until they
do, ``python3 benchmark/attribution.py --workload <cell> --seed <n>
--seconds <s>`` makes a ``run.py --trace 1`` run with collection on from
set-up to the end of the window and the window's trace attributed, and
prints its result line with ``breakdown.spans``,
``breakdown.idle_by_span``, ``breakdown.attribution`` and those metrics
added.  It imports the port's profiling module, the one part of the port
that the benchmark otherwise reaches only through ``program.py``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

if __name__ == "__main__":  # run as a script: the repository's root on the path first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import run  # noqa: F401  (its clock starts set-up)

import torch  # noqa: E402

from benchmark.trace import TOP, DeviceTrace, _merge, sync  # noqa: E402

OUTSIDE = "outside program spans"
PROBES = 20  # host-clock readings around a synchronise, to read the clocks' skew
# the span a unit of each kind of cell: a training step, a validation pass
UNITS = ("train.step", "eval.validate")
# the per-layer metrics that layer_metrics gives, and their units
METRICS = {
    "step_propagate_ms": "ms", "step_hub_ms": "ms", "step_launches": "launches",
    "step_gathered_rows": "rows", "eval_select_ms": "ms", "eval_mask_ms": "ms",
    "device_graph_s": "s",
}

Span = Tuple[str, int, int]  # (name, start_ns, end_ns)


def device_launches(events) -> Tuple[List[Tuple[int, int, str]], List[Optional[int]]]:
    """The device operations of a ``torch.profiler`` event list as
    ``(start_ns, end_ns, name)``, and the host start of the runtime call
    that launched each (None where the trace holds no such call)."""
    dev, calls = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.duration_ns() > 0 and e.correlation_id():
            calls[e.correlation_id()] = e.start_ns()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in dev]
    launch = [calls.get(e.correlation_id(), calls.get(e.linked_correlation_id())) for e in dev]
    return ops, launch


def _covering(spans: Sequence[Span], times: Sequence[int]) -> List[List[Span]]:
    """For each of ``times``, the spans whose interval holds it, shortest
    first: a sweep in time order (spans on one thread nest, so few are
    open at once)."""
    order = sorted(range(len(times)), key=times.__getitem__)
    by_start = sorted(spans, key=lambda s: s[1])
    out: List[List[Span]] = [[] for _ in times]
    open_, i = [], 0
    for q in order:
        t = times[q]
        while i < len(by_start) and by_start[i][1] <= t:
            open_.append(by_start[i])
            i += 1
        open_ = [s for s in open_ if s[2] >= t]
        out[q] = sorted((s for s in open_), key=lambda s: s[2] - s[1])
    return out


def attribute(ops: Sequence[Tuple[int, int, str]], launch: Sequence[Optional[int]],
              spans: Sequence[Span], window: Tuple[int, int]) -> dict:
    """Device operations ``ops`` (launched at host times ``launch``) and
    the program's ``spans``, over the window ``(start_ns, end_ns)``.

    Returns the unit span's name and count in the window (``steps``), by
    span name the inclusive device ms, host ms and launches a unit
    (``spans``), the idle gaps by the shortest span holding their middle
    (``idle_by_span``, seconds, the largest ``TOP``), and the share of the
    operations' device time that some span holds (``covered``) and that
    the unit span holds (``unit_covered``), against their sum
    (``device_s``)."""
    w0, w1 = window
    inside = [s for s in spans if w0 <= s[1] and s[2] <= w1]
    unit = next((u for u in UNITS if any(s[0] == u for s in inside)), None)
    steps = sum(1 for s in inside if s[0] == unit)
    known = [i for i, t in enumerate(launch) if t is not None]
    held = _covering(inside, [launch[i] for i in known])
    dev_ns, launches = defaultdict(int), defaultdict(int)
    covered = 0
    for i, hs in zip(known, held):
        d = ops[i][1] - ops[i][0]
        covered += d if hs else 0
        for name in {s[0] for s in hs}:
            dev_ns[name] += d
            launches[name] += 1
    host_ns = defaultdict(int)
    for s in inside:
        host_ns[s[0]] += s[2] - s[1]

    busy = _merge([(a, b) for a, b, _ in ops])
    mids = [(a + b) // 2 for (_, a), (b, _) in zip(busy, busy[1:])]
    gaps = defaultdict(int)
    for (_, a), (b, _), hs in zip(busy, busy[1:], _covering(inside, mids)):
        gaps[hs[0][0] if hs else OUTSIDE] += b - a

    total = sum(b - a for a, b, _ in ops)
    per = max(steps, 1)
    return {
        "unit": unit, "steps": steps,
        "spans": {name: {"device_ms": dev_ns[name] / per * 1e-6,
                         "host_ms": host_ns[name] / per * 1e-6,
                         "launches": launches[name] / per}
                  for name in sorted(host_ns)},
        "idle_by_span": [[k, v * 1e-9] for k, v in
                         sorted(gaps.items(), key=lambda x: -x[1])[:TOP]],
        "device_s": total * 1e-9,
        "covered": covered / total if total else None,
        "unit_covered": dev_ns[unit] / total if total and unit else None,
    }


def layer_metrics(att: dict, gathered_rows: Optional[int], setup_spans: Sequence[Span]) -> dict:
    """The per-layer metrics of an ``attribute`` result: those of the
    cell's kind (training steps or validation passes) whose spans the
    window holds, and ``device_graph_s`` from the set-up's
    ``spmm.to_device`` spans.  A metric with nothing to read is left out,
    and so is every device metric of a trace without device operations."""
    sp, out = att["spans"], {}
    train = att["steps"] and att["unit"] == "train.step"
    device = att["steps"] and att["device_s"] > 0
    if train and device:
        prop = [sp[n]["device_ms"] for n in ("spmm.forward", "spmm.backward") if n in sp]
        if prop:
            out["step_propagate_ms"] = sum(prop)
        if "spmm.hub" in sp:
            out["step_hub_ms"] = sp["spmm.hub"]["device_ms"]
        out["step_launches"] = sp["train.step"]["launches"]
    if train and gathered_rows:
        out["step_gathered_rows"] = gathered_rows / att["steps"]
    if device and att["unit"] == "eval.validate":
        for metric, name in (("eval_select_ms", "topk.select"), ("eval_mask_ms", "topk.mask")):
            if name in sp:
                out[metric] = sp[name]["device_ms"]
    up = [s for s in setup_spans if s[0] == "spmm.to_device"]
    if up:
        out["device_graph_s"] = sum(s[2] - s[1] for s in up) * 1e-9
    return out


def skew_ns(probes: Sequence[Tuple[int, int]], events) -> Optional[int]:
    """How far the trace's clock and the spans' disagree: the worst
    distance by which a ``cudaDeviceSynchronize`` runtime call lies outside
    the two host-clock readings taken around it (``probes``, in order), 0
    when each lies inside.  Other synchronises may come before and after
    the probes', so the probes are laid against the calls at the offset
    that fits best."""
    calls = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "cudaDeviceSynchronize" and e.duration_ns() > 0)
    n = len(probes)
    if not n or len(calls) < n:
        return None
    return min(max(max(a - s, e - b, 0) for (a, b), (s, e) in zip(probes, calls[k:k + n]))
               for k in range(len(calls) - n + 1))


class SpanTrace(DeviceTrace):
    """``DeviceTrace`` whose window's trace is also attributed to the
    program's spans in ``recorder``; its own summary is unchanged."""

    recorder = None   # the program's Recorder, set while a run collects
    found: dict = {}  # the attribution of the last window

    def __enter__(self):
        super().__enter__()
        if self.on:
            rec = type(self).recorder
            self.counters0 = dict(rec.counters) if rec is not None else {}
            self.w0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.w1 = time.time_ns()
            rec = type(self).recorder
            self.counters1 = dict(rec.counters) if rec is not None else {}
            self.probes = []
            if torch.device(self.device).type == "cuda":
                for _ in range(PROBES):
                    a = time.time_ns()
                    sync(self.device)
                    self.probes.append((a, time.time_ns()))
        return super().__exit__(*exc)

    def _reduce(self, events, window_s: float) -> dict:
        events = list(events)
        summary = DeviceTrace._reduce(events, window_s)
        rec = type(self).recorder
        if rec is not None:
            spans = [(s.name, s.start_ns, s.end_ns) for s in rec.spans]
            ops, launch = device_launches(events)
            att = attribute(ops, launch, spans, (self.w0, self.w1))
            rows = (self.counters1.get("spmm.gathered_rows", 0)
                    - self.counters0.get("spmm.gathered_rows", 0))
            att["metrics"] = layer_metrics(att, rows, [s for s in spans if s[2] <= self.w0])
            att["launched_share"] = sum(t is not None for t in launch) / max(len(launch), 1)
            att["skew_ns"] = skew_ns(self.probes, events)
            type(self).found = att
        return summary


def add_to_line(line: dict, att: dict) -> dict:
    """The result line with the attribution's metrics and breakdown."""
    for name, value in att["metrics"].items():
        line["metrics"][name] = {"value": value, "unit": METRICS[name]}
    b = line.setdefault("breakdown", {})
    b["spans"] = att["spans"]
    b["idle_by_span"] = att["idle_by_span"]
    b["attribution"] = {k: att[k] for k in ("unit", "steps", "device_s", "covered",
                                            "unit_covered", "launched_share", "skew_ns")}
    return line


@contextlib.contextmanager
def spans_attributed():
    """While open, ``harness.run_cell`` runs with the program's collection
    on, the train and eval loads' window trace is a ``SpanTrace``, and a
    traced run's line carries the attribution (``add_to_line``)."""
    from benchmark import harness
    from benchmark.loads import eval as eval_load, train as train_load
    from gcn_recommendation_tpu_torch.utils import profiling

    plain = harness.run_cell

    def run_cell(*args, **kw):
        SpanTrace.found = {}
        with profiling.collect() as rec:
            SpanTrace.recorder = rec
            try:
                line = plain(*args, **kw)
            finally:
                SpanTrace.recorder = None
        return add_to_line(line, SpanTrace.found) if SpanTrace.found else line

    loads = (train_load, eval_load)
    saved = [load.DeviceTrace for load in loads]
    for load in loads:
        load.DeviceTrace = SpanTrace
    harness.run_cell = run_cell
    try:
        yield
    finally:
        harness.run_cell = plain
        for load, cls in zip(loads, saved):
            load.DeviceTrace = cls


def main(argv=None) -> int:
    from benchmark import run

    argv = list(sys.argv[1:] if argv is None else argv)
    with spans_attributed():
        return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
