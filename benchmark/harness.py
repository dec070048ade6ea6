"""Finds a cell's parts by name and assembles its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* a configuration: the ``file`` of its ``configs`` entry (JSON);
* a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``load``
  names the general load module (``benchmark/loads/<load>.py``) that
  reads its parameters;
* a cell's comparison limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, whose
  ``read(obs)`` returns the number, or None when the run gave it nothing
  to read (the metric is then left out of the line).

A load module's ``run(ctx)`` sets the cell up, measures the window and checks
what the window produced against the plain reference; it returns an
``Outcome``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.trace import Spans

PKG = "benchmark"


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]                  # end-to-end metric name -> value
    obs: dict                              # what the per-layer readers read
    checks: Dict[str, Tuple[float, float]]  # compared number -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int


@dataclasses.dataclass
class Run:
    """What a load module is given."""

    root: str
    workload: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                               # process start, perf_counter
    spans: Spans = None

    def log(self, msg: str) -> None:
        print(f"[{self.workload} seed {self.seed}] {msg}", file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metric(root: str, name: str, obs: dict):
    path = os.path.join(root, PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{PKG}_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def setup_context(root: str, workload: str, seed: int, seconds: float, trace: bool,
                  device, t0: float) -> Tuple[dict, Run]:
    bench = load_bench(root)
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "configuration")
    ctx = Run(root=root, workload=workload, cfg=_json(os.path.join(root, conf["file"])),
              traffic=_json(os.path.join(root, PKG, "traffic", f"{cell['traffic']}.json")),
              limits=_json(os.path.join(root, PKG, "limits", f"{workload}.json")),
              seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), t0=t0, spans=Spans(device))
    return bench, ctx


def load_module(ctx: Run):
    return importlib.import_module(f"{PKG}.loads.{ctx.traffic['load']}")


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None) -> dict:
    """One run of one cell; returns the result line as a dict."""
    t0 = time.perf_counter() if t0 is None else t0
    bench, ctx = setup_context(root, workload, seed, seconds, trace, device, t0)
    out: Outcome = load_module(ctx).run(ctx)
    return result_line(bench, ctx, out)


def result_line(bench: dict, ctx: Run, out: Outcome) -> dict:
    metrics = {}
    for m in cell_metrics(bench, ctx.workload, ctx.trace):
        value = out.e2e[m["name"]] if not ctx.trace else read_metric(ctx.root, m["name"], out.obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = ctx.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cuda:
        from benchmark.roofline import card

        c = card()
        device["card"] = f"{c['name']}, {c['power_limit']}"
    line = {"attempted": int(out.attempted), "failed": int(out.failed), "metrics": metrics,
            "device": device}
    trace = out.obs.get("trace")  # DeviceTrace.summary of a traced window
    if ctx.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    ok = out.failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in out.checks.values())
    for name, (v, lim) in out.checks.items():
        ctx.log(f"check {name} {v!r} limit {lim!r}")
    line = {"correct": bool(ok), **line}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

