"""The harness drives every cell at a tiny size on the CPU, and finds a
configuration, a traffic mix, a cell and a per-layer metric that are only
added as new files and entries."""

import json
import os

import pytest

from benchmark import harness
from tiny import tiny_root

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def cells():
    with open(os.path.join(os.path.dirname(__file__), "..", "..", "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]] + ["books_d64.serve"]


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(root, workload, trace):
    line = harness.run_cell(root, workload, SEED, 0.5, bool(trace), device="cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(harness.load_bench(root), workload, trace)}
    if not trace:  # every end-to-end metric; per-layer ones without a trace may be absent
        assert set(line["metrics"]) == names
    else:
        assert set(line["metrics"]) <= names and "graph_build_s" in line["metrics"]


def test_added_files_are_found(tmp_path):
    root = tiny_root(tmp_path)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "books_d64.json")) as f:
        cfg = json.load(f)
    cfg.update(name="books_d32", embedding_dim=32, n_layers=2)
    with open(os.path.join(b, "configs", "books_d32.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "train_short.json"), "w") as f:
        json.dump({"load": "train", "feed_steps": 4, "warmup_steps": 1}, f)
    with open(os.path.join(b, "limits", "books_d32.train_short.json"), "w") as f:
        json.dump({f"{end}{k}": v for end in ("", "end_") for k, v in
                   (("loss_gap", 1e-3), ("grad_norm_gap", 1e-2), ("change_norm_gap", 1e-2))}, f)
    with open(os.path.join(b, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(obs):\n    return obs.get('steps')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "books_d32", "source": "x",
                             "file": "benchmark/configs/books_d32.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "books_d32.train_short", "config": "books_d32",
                               "traffic": "train_short", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("train_examples_per_s", "peak_mem_gib"):
            m["workloads"].append("books_d32.train_short")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "train_examples_per_s",
                               "workloads": ["books_d32.train_short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = harness.run_cell(root, "books_d32.train_short", SEED, 0.3, True, device="cpu")
    assert line["correct"] and line["metrics"]["steps_seen"]["value"] == line["attempted"]
    line = harness.run_cell(root, "books_d32.train_short", SEED, 0.3, False, device="cpu")
    assert set(line["metrics"]) == {"setup_s", "train_examples_per_s", "peak_mem_gib"}


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of a cell through ``run.py`` on a card."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "books_d64.train",
                          "--seed", str(SEED), "--seconds", "2"], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
