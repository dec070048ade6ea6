"""What the benchmark loads: nothing of JAX or the JAX package in a run's
process, and nothing of the program in the reference."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "gcn_recommendation_tpu"}


def loaded_top_level(code: str):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def cell_modules():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    loads = set()
    for cell in bench["workloads"]:
        with open(os.path.join(REPO, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
            loads.add(json.load(f)["load"])
    metrics = [m["name"] for m in bench["per_layer"]]
    return sorted(loads | {"serve"}), metrics  # serve: kept for the cell of PERF.md §7


def test_run_loads_no_jax():
    loads, metrics = cell_modules()
    code = ("import runpy, sys; sys.argv = ['run.py']; "
            "mod = runpy.run_path('benchmark/run.py', run_name='bench_run'); "
            "sys.path.insert(0, '.'); import importlib; "
            "from benchmark import harness, control, sweep; "
            + "".join(f"importlib.import_module('benchmark.loads.{d}'); " for d in loads)
            + "".join(f"harness.read_metric('.', {m!r}, {{}}); " for m in metrics))
    found = loaded_top_level(code)
    assert "gcn_recommendation_tpu_torch" in found and "torch" in found
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_forbidden_names_compared_whole():
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        sys.modules["gcn_recommendation_tpu_torch_x"] = object()
        assert "gcn_recommendation_tpu" not in run.forbidden_modules()
        sys.modules["jaxlib.xla_client"] = object()
        assert "jaxlib" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_loads_nothing_of_the_program():
    found = loaded_top_level("import sys; sys.path.insert(0, '.'); "
                             "import benchmark.reference.lightgcn")
    assert "torch" in found
    assert "gcn_recommendation_tpu_torch" not in found and not found & FORBIDDEN


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py runs the cell instead")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "books_d64.train",
                          "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
