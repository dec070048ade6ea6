"""The benchmark of the PyTorch port ``gcn_recommendation_tpu_torch`` on
NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload books_d64.train --seed 7 --seconds 10 --trace 0

Run from the root of a checkout.  Set-up (imports, the benchmark's data,
the port's graph build and device upload, warm-up) counts as ``setup_s``
from the start of this process; then the cell's window runs for
``--seconds``; then what the window produced is checked against the
plain reference in ``benchmark/reference/``.  The last line of standard
output is one JSON object; with ``--trace 1`` it carries the per-layer
metrics, read under ``torch.profiler``, instead of the end-to-end ones.

Exits with a code other than 0, printing no result, when no CUDA card is
present, and when a JAX module or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gcn_recommendation_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed place in the checkout
    os.environ["GCN_TORCH_BUILD_DIR"] = os.path.join(CACHE, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    bench = harness.load_bench(ROOT)
    chips = harness.find(bench["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
