#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's serving path.

    python3 chip_smoke.py

Needs one CUDA card (an H100; the kernels are built for sm_90a) and
``nvcc``.  Phases, each of which fails the run (nonzero exit) when it
fails:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA kernel of the path from ``gcn_recommendation_tpu_torch/csrc``;
3. kernel check: ``quantize_rows_int8`` on the card against its plain
   PyTorch version at the catalog shape [20000, 64] and a ragged
   [1000, 48]; q and scales must be bit-equal.  Kernel and plain times
   are CUDA-event medians over 5 windows of 20 back-to-back calls;
4. the path: the books-shaped bench bundle (72,000 nodes, ~3.03M
   adjacency nonzeros), LightGCN dim 64, 3 layers, random weights from a
   seed; ``Retriever.from_params`` with the f32 and the int8 catalog,
   then requests of 1, 7, 64 and 1024 users at k=20 through
   ``recommend``, ``recommend_pipelined`` and ``recommend_many``.
   Checked: finite scores, no seen item returned, pipelined and
   micro-batched equal per-request results, the ELL propagation equal to
   the ``propagate_coo`` oracle within 1e-5, int8 top-20 overlapping f32
   top-20 by >= 0.9, and the kernel launched during the int8 load.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without a result when
no CUDA card is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.sampler import membership_arrays
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.kernels import _build
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import quant
from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph
from gcn_recommendation_tpu_torch.serve import Retriever

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
QUANT_OPS_PER_ELEMENT = 20    # hash (~12 integer ops) + divide, add, floor, clamp
REQUEST_SIZES = (1, 7, 64, 1024)
K = 20
PROPAGATION_ATOL = 1e-5       # f32 ELL vs f32 COO: same sums, other order
MIN_INT8_OVERLAP = 0.9


def _cuda_ms(fn, reps: int = 20, windows: int = 5, warmup: int = 3) -> float:
    """CUDA-event time of one ``fn()`` in ms: the median over ``windows``
    of (``reps`` back-to-back calls) / ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock time of ``fn()`` in ms; ``fn`` ends in a copy to
    the host, which waits for the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    print(f"ok: {what}", flush=True)


def phase_kernel_check(dev):
    """Bit-equality of the quantizer kernel with its plain version, and
    its times beside the bound at the catalog shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    record = None
    for n, d, seed in ((20_000, 64, 0), (1_000, 48, 1234)):
        x = torch.randn((n, d), generator=gen, device=dev) * 0.05
        q_k, s_k = quant.quantize_rows_int8(x, seed=seed)
        q_p, s_p = quant._quantize_rows_int8_reference(x, seed=seed)
        torch.cuda.synchronize()
        err = max(
            (q_k.int() - q_p.int()).abs().max().item(),
            (s_k - s_p).abs().max().item(),
        )
        check(
            torch.equal(q_k, q_p) and torch.equal(s_k, s_p),
            f"quantize_rows_int8 kernel bit-equal to plain at [{n}, {d}] "
            f"(max abs diff {err})",
        )
        if record is None:  # the catalog shape of the path
            ms = _cuda_ms(lambda: quant.quantize_rows_int8(x, seed=seed))
            plain_ms = _cuda_ms(lambda: quant._quantize_rows_int8_reference(x, seed=seed))
            nbytes = 4 * n * d + n * d + 4 * n
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = QUANT_OPS_PER_ELEMENT * n * d / FP32_OPS_PER_S * 1e3
            record = {
                "name": "quantize_rows_int8",
                "route": "cuda",
                "source": "gcn_recommendation_tpu_torch/csrc/quant_int8.cu",
                "replaces": "gcn_recommendation_tpu/ops/quant.py:35",
                "shape": [n, d],
                "max_abs_err": err,
                "max_abs_diff_vs_plain": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,  # no PyTorch call does stochastic int8 rounding
            }
    return record


def _seen_sets(bundle, users):
    f_ptr, f_items = membership_arrays(
        bundle.train.user_idx, bundle.train.item_idx, bundle.num_users
    )
    return [set(f_items[f_ptr[u] : f_ptr[u + 1]].tolist()) for u in users]


def _same_topk(a, b, tol: float) -> bool:
    """Equal top-k lists up to the order of near-tied scores: values
    within ``tol`` everywhere, and wherever the items differ the score
    ties another entry of the row within ``tol``."""
    (va, ia), (vb, ib) = a, b
    if va.shape != vb.shape or not np.allclose(va, vb, rtol=0, atol=tol):
        return False
    for r in range(va.shape[0]):
        for j in np.flatnonzero(ia[r] != ib[r]):
            gaps = np.abs(va[r] - va[r, j])
            gaps[j] = np.inf
            if gaps.min() > tol:
                return False
    return True


def phase_path(dev):
    """Drive the serving path and check it; returns the launch counts
    of the main path."""
    t0 = time.perf_counter()
    # bench.py's books-shaped bundle
    bundle = synthetic_bundle(50_000, 20_000, 2_000, mean_degree=28.0, core=8, seed=42)
    g = bundle.graph
    bundle_s = time.perf_counter() - t0
    print(f"bundle: {g.num_nodes} nodes, {g.nnz} nonzeros, "
          f"{len(g.buckets)} ELL buckets, hub matrix {tuple(g.dense_mat.shape)}, "
          f"built in {bundle_s:.1f} s on the host", flush=True)
    cfg = Config(embedding_dim=64, n_layers=3)
    model = get_model("LightGCN")(
        bundle.num_users, bundle.num_items, bundle.num_brands, cfg, device=dev
    )
    params = model.init(torch.Generator().manual_seed(42))

    rng = np.random.default_rng(0)
    active = np.unique(bundle.train.user_idx)
    requests = [rng.choice(active, n, replace=False).astype(np.int32) for n in REQUEST_SIZES]

    # --- the main path: counts from 0, read right after ---
    quant.quantize_rows_int8.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf = Retriever.from_params(model, params, bundle)
    torch.cuda.synchronize()
    load_f32_ms = (time.perf_counter() - t0) * 1e3
    launches_f32 = quant.quantize_rows_int8.launches
    t0 = time.perf_counter()
    rq = Retriever.from_params(model, params, bundle, quantize=True)
    torch.cuda.synchronize()
    load_int8_ms = (time.perf_counter() - t0) * 1e3
    launches_int8 = quant.quantize_rows_int8.launches - launches_f32
    results = {}
    for name, r in (("f32", rf), ("int8", rq)):
        single = [r.recommend(u, k=K) for u in requests]
        piped = r.recommend_pipelined(requests, k=K)
        many = r.recommend_many(requests, k=K)
        results[name] = (single, piped, many)
    launches = {"quantize_rows_int8": quant.quantize_rows_int8.launches}
    # --- end of the main path ---

    check(launches_f32 == 0, "f32 load launches no quantizer")
    check(launches_int8 >= 1, f"int8 load launched the quantizer ({launches_int8}x)")

    for name, (single, piped, many) in results.items():
        for u, (v, i) in zip(requests, single):
            check(v.shape == (len(u), K) and np.isfinite(v).all(),
                  f"{name}: {len(u)}-user request gives finite [{len(u)}, {K}] scores")
            seen = _seen_sets(bundle, u)
            check(all(not (set(i[j].tolist()) & seen[j]) for j in range(len(u))),
                  f"{name}: {len(u)}-user request returns no seen item")
        check(all(_same_topk(a, b, 1e-5) for a, b in zip(single, piped)),
              f"{name}: recommend_pipelined equals recommend")
        check(all(_same_topk(a, b, 1e-5) for a, b in zip(single, many)),
              f"{name}: recommend_many equals recommend")

    i_f, i_q = results["f32"][0][-1][1], results["int8"][0][-1][1]
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(i_f, i_q)]))
    check(overlap >= MIN_INT8_OVERLAP,
          f"int8 top-{K} overlaps f32 top-{K} by {overlap:.4f} over {len(i_f)} users")

    # propagation against the COO oracle, and its time
    with torch.no_grad():
        graph = to_device_graph(g, include_coo=True, device=dev)
        ell = torch.cat([t for t in model(graph, path="ell")[:3]])
        coo = torch.cat([t for t in model(graph, path="coo")[:3]])
        diff = (ell - coo).abs().max().item()
        check(diff <= PROPAGATION_ATOL,
              f"ELL propagation matches propagate_coo (max abs diff {diff:.3g})")
        propagate_ms = _cuda_ms(lambda: model(graph), reps=5, warmup=2)
        coo_ms = _cuda_ms(lambda: model(graph, path="coo"), reps=5, warmup=2)

    latency = {}
    for name, r in (("f32", rf), ("int8", rq)):
        for u in requests:
            latency[f"{name}_b{len(u)}_ms"] = _host_ms(lambda: r.recommend(u, k=K))
        latency[f"{name}_many_ms"] = _host_ms(lambda: r.recommend_many(requests, k=K))
        latency[f"{name}_pipelined_ms"] = _host_ms(
            lambda: r.recommend_pipelined(requests, k=K))
    meas = {
        "bundle_host_s": bundle_s,
        "load_f32_ms": load_f32_ms,
        "load_int8_ms": load_int8_ms,
        "forward_3_layers_ms": propagate_ms,
        "forward_3_layers_coo_ms": coo_ms,
        "int8_overlap_top20": overlap,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        **latency,
    }
    print("path: " + json.dumps(meas), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    build_s = _build.build()
    print(f"build_seconds: {build_s:.2f}", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc[{name}]: {line}")

    record = phase_kernel_check(dev)
    launches = phase_path(dev)
    record["launches"] = launches[record["name"]]

    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
