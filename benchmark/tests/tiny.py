"""A copy of the benchmark at a size the CPU runs in seconds, for the tests.

The copy also declares ``books_d64.serve`` with its metrics: the serving
load module and its files are kept for the cell that PERF.md's open questions
describe, and the tests keep them working."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_GRAPH = {"num_users": 300, "num_items": 200, "num_brands": 20, "mean_degree": 12.0,
              "core": 4}


def tiny_root(tmp, configs=("books_d64", "northstar_d256")):
    """``tmp`` holding BENCHMARK.json and benchmark/ with every named
    configuration cut to a tiny graph and batch, and every mix to a few
    requests; returns ``tmp``."""
    tmp = str(tmp)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    for name in configs:
        path = os.path.join(tmp, "benchmark", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["graph"].update(TINY_GRAPH)
        cfg["batch_size"] = 64
        cfg["eval_user_batch"] = 128
        with open(path, "w") as f:
            json.dump(cfg, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    if not any(w["name"] == "books_d64.serve" for w in bench["workloads"]):
        bench["workloads"].append({"name": "books_d64.serve", "config": "books_d64",
                                   "traffic": "serve", "chips": 1, "why": "tests"})
        bench["end_to_end"].append({"name": "request_p95_ms", "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["books_d64.serve"]})
        for name, unit in (("coalesce_factor", "req/dispatch"), ("device_idle_pct.serve", "%")):
            bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                       "source": "program_counter", "layer": "dispatcher",
                                       "moves": "request_p95_ms",
                                       "workloads": ["books_d64.serve"]})
        with open(path, "w") as f:
            json.dump(bench, f)
    for name in os.listdir(os.path.join(tmp, "benchmark", "traffic")):
        path = os.path.join(tmp, "benchmark", "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        if mix["load"] == "serve":
            mix.update(rate_per_s=20.0, min_users=4, max_users=32, grace_s=3.0)
            with open(path, "w") as f:
                json.dump(mix, f)
    return tmp
