"""Experiment: what a cold process pays before its first steady training step.

Counterpart of the JAX package's ``tools/exp_compile_cost.py``, which
timed XLA's compile of the epoch function under a fresh compilation
cache.  Eager PyTorch compiles nothing per shape; what a cold process pays
instead is the CUDA context, lazy module loading, cuBLAS's handle and
workspace, the caching allocator's first blocks, the first Adam step's
imports, and the build of the port's CUDA kernels.  So each variant runs
in a fresh Python process:

* ``fused``     — merge-skip fused layers (``Trainer`` default)
* ``per-layer`` — per-layer propagation (``graph_fuse_layers = False``)

on the bench bundle (50k users / 20k items / 2k brands, degree 28, core 8,
seed 42; dim 64 x 3 layers, batch 2048), with ``SCAN_STEPS`` steps as the
epoch.  The child prints the CUDA initialisation on a line of its own,
builds the port's three kernels with ``nvcc`` into a fresh temporary
directory (``GCN_TORCH_BUILD_DIR``; ``--keep_build`` uses the package's
build directory instead, where they may already be built), and then the
JAX tool's line:

    [variant] host build X s  compile+first Y s  steady epoch Z s (N ex/s)

``host build`` is the trainer's construction (the device graph, the
tables, the optimizer), ``compile+first`` the first epoch of a cold
process, ``steady epoch`` the second.

    python -m gcn_recommendation_tpu_torch.tools.exp_compile_cost
    python -m gcn_recommendation_tpu_torch.tools.exp_compile_cost --variant fused

``--device cpu`` runs the children on the CPU (no kernel build, CPU times).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# bench.py workload constants
NUM_USERS = 50_000
NUM_ITEMS = 20_000
NUM_BRANDS = 2_000
MEAN_DEGREE = 28.0
BATCH = 2048
DIM = 64
LAYERS = 3
SCAN_STEPS = 60
VARIANTS = ("fused", "per-layer")
RESULT = "RESULT "
CHILD_TIMEOUT_S = 900


def child(args) -> dict:
    """One variant in this (fresh) process."""
    import numpy as np
    import torch

    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.kernels import _build
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.train.trainer import Trainer
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    # the interpreter's start and the imports, from the parent's spawn
    res = {"variant": args.variant, "startup_s": time.time() - args.t_spawn}
    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    res["cuda_init_s"] = time.perf_counter() - t0
    print(device_line(dev), flush=True)
    if dev.type == "cuda":
        print(f"[{args.variant:9s}] CUDA initialisation {res['cuda_init_s']:6.2f}s "
              f"(interpreter and imports {res['startup_s']:.2f}s)", flush=True)
        t0 = time.perf_counter()
        _build.build()
        res["nvcc_s"] = time.perf_counter() - t0
        res["build_dir"] = _build.BUILD_DIR
        print(f"[{args.variant:9s}] kernels {', '.join(_build.KERNEL_SOURCES)}: "
              f"{res['nvcc_s']:.2f}s in {_build.BUILD_DIR}", flush=True)
    else:
        print(f"[{args.variant:9s}] no CUDA initialisation and no kernel build on the CPU "
              f"(interpreter and imports {res['startup_s']:.2f}s)", flush=True)

    bundle = synthetic_bundle(num_users=args.num_users, num_items=args.num_items,
                              num_brands=args.num_brands, mean_degree=MEAN_DEGREE,
                              core=8, seed=42)
    print(f"graph: nnz={bundle.graph.nnz} train={len(bundle.train)}", flush=True)
    cfg = Config(embedding_dim=DIM, n_layers=LAYERS, batch_size=args.batch)
    fused = args.variant == "fused"

    class _T(Trainer):
        graph_fuse_layers = fused

    t0 = time.perf_counter()
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    tr = _T(cfg, model, bundle)
    tr.steps_per_epoch = args.steps
    tr.init_state()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    first = tr.run_epoch()  # ends in a copy of the losses to the host
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.run_epoch()
    steady_s = time.perf_counter() - t0
    cpu = "" if dev.type == "cuda" else " (cpu)"
    print(f"[{args.variant:9s}] host build {build_s:6.1f}s  compile+first {first_s:6.1f}s  "
          f"steady epoch {steady_s:6.2f}s ({args.steps * args.batch / steady_s:,.0f} ex/s)"
          f"{cpu}", flush=True)
    res.update(host_build_s=build_s, first_s=first_s, steady_s=steady_s,
               first_losses=[float(x) for x in np.asarray(first)])
    return res


def run_variant(variant: str, args) -> dict:
    """Run one variant in a fresh interpreter; returns its result."""
    argv = [sys.executable, "-m", "gcn_recommendation_tpu_torch.tools.exp_compile_cost",
            "--child", "--variant", variant, "--device", args.device,
            "--num_users", str(args.num_users), "--num_items", str(args.num_items),
            "--num_brands", str(args.num_brands), "--batch", str(args.batch),
            "--steps", str(args.steps),
            "--t_spawn", repr(time.time())]
    env = dict(os.environ)
    tmp = None
    if not args.keep_build:
        tmp = tempfile.mkdtemp(prefix="gcn_torch_build_cold_")
        env["GCN_TORCH_BUILD_DIR"] = tmp
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT):
            result = json.loads(line[len(RESULT):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        raise RuntimeError(f"{variant} child failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    result["process_s"] = wall
    print(f"[{variant:9s}] whole process {wall:6.1f}s", flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=VARIANTS, default=None)
    ap.add_argument("--keep_build", action="store_true",
                    help="build the kernels into the package's build directory (warm if "
                         "built before) instead of a fresh temporary one")
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=SCAN_STEPS)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--t_spawn", type=float, default=0.0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        res = child(args)
        print(RESULT + json.dumps(res), flush=True)
        return res
    from gcn_recommendation_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # raises here, before any child, without a card
    variants = [args.variant] if args.variant else list(VARIANTS)
    return {v: run_variant(v, args) for v in variants}


if __name__ == "__main__":
    main()
