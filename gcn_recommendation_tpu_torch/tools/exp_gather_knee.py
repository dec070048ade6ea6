"""Experiment: is there a gather knee on this card?

The JAX package switches to the source-chunked ELL layout
(``ops/spmm.py::to_device_chunked_graph``) above a node count where the
TPU's row-gather rate halves.  This scan asks the same question of the
CUDA card: for random user-item graphs of about 72k, 180k, 400k and 1M
nodes (users : items = 50 : 20, as the books bundle, 28 interactions per
user, built with ``build_normalized_adjacency`` on the native path), the
time of one propagation ``A_norm @ emb`` at d = 64 in f32 and in bf16
storage, plain ELL (a per-layer ``DeviceGraph``) against the chunked
layout at C = 2 and C = 4 (``ChunkedDeviceGraph``), each through
``ops/spmm.py::propagate``, in turns, ``repeats`` times.
Each chunked result is held against the plain one.

    python -m gcn_recommendation_tpu_torch.tools.exp_gather_knee \
        [--budget_s S] [--sizes 72000,180000,...] [--chunks 2,4]

Needs a CUDA card.  ``chip_smoke.py`` (phase 12c) runs ``scan`` with a
time box; ``ops/spmm.py::GATHER_KNEE_ROWS`` is written from its result.
Prints one JSON line: the scan, the sizes at which a chunked layout beat
plain ELL in every repeat (``chunked_faster_at``), and the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from gcn_recommendation_tpu_torch.data import native_ext
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.ops.spmm import (
    ChunkedDeviceGraph,
    propagate,
    to_device_chunked_graph,
    to_device_graph,
)
from gcn_recommendation_tpu_torch.utils.timing import cuda_ms

SIZES = (72_000, 180_000, 400_000, 1_000_000)
CHUNKS = (2, 4)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
MEAN_DEGREE = 28.0
DIM = 64
REPEATS = 3
# chunked vs plain on the same input: the same products, summed in another
# order; x max(1, max|plain|).  bf16 storage rounds each chunk's parts once
# where plain rounds each bucket's once: 2e-2, JAX's bound for bf16 storage
MATCH_RTOL = {"f32": 1e-5, "bf16": 2e-2}


def scan_graph(num_nodes: int, seed: int = 0):
    """A seeded random user-item graph of ``num_nodes`` nodes (no brands)."""
    num_users = num_nodes * 50 // 72
    num_items = num_nodes - num_users
    rng = np.random.default_rng(seed)
    m = int(num_users * MEAN_DEGREE)
    return build_normalized_adjacency(
        rng.integers(0, num_users, m), rng.integers(0, num_items, m), num_users, num_items, 0,
        use_brand=False)


def cast_layout(layout, dtype):
    """A device layout with its weights and hub matrix in ``dtype``."""
    if isinstance(layout, ChunkedDeviceGraph):
        return dataclasses.replace(
            layout, dense_mat=layout.dense_mat.to(dtype),
            chunk_bucket_w=tuple(tuple(tuple(w.to(dtype) for w in cell) for cell in chunk)
                                 for chunk in layout.chunk_bucket_w))
    return dataclasses.replace(layout, dense_mat=layout.dense_mat.to(dtype),
                               bucket_nbr_w=tuple(w.to(dtype) for w in layout.bucket_nbr_w))


@torch.no_grad()
def scan(device, sizes=SIZES, chunks=CHUNKS, repeats: int = REPEATS,
         budget_s: float = 60.0, graphs=None):
    """ms per propagation of each layout at each size, dtype and repeat.
    ``graphs`` maps a size to a prebuilt host graph (the books bundle's).
    Sizes are skipped, and marked so, once ``budget_s`` is spent."""
    t_start = time.perf_counter()
    out = {"native": native_ext.available(), "dim": DIM, "repeats": repeats, "sizes": {}}
    for n in sizes:
        if time.perf_counter() - t_start > budget_s:
            out["sizes"][str(n)] = "not measured: time box spent"
            continue
        t0 = time.perf_counter()
        g = (graphs or {}).get(n) or scan_graph(n)
        rec = {"nodes": g.num_nodes, "nnz": int(g.nnz), "graph_host_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        f32 = {"plain": to_device_graph(g, device=device, fuse_layers=False)}
        for c in chunks:
            f32[f"c{c}"] = to_device_chunked_graph(g, c, device=device)
        torch.cuda.synchronize()
        rec["layouts_host_s"] = time.perf_counter() - t0
        for name, dtype in DTYPES.items():
            # bf16 storage: the same layouts with their weights cast on the card
            layouts = {key: cast_layout(lay, dtype) for key, lay in f32.items()}
            emb = torch.randn(g.num_nodes, DIM, generator=torch.Generator().manual_seed(n))
            emb = emb.to(device=device, dtype=dtype)
            calls = {key: lambda lay=lay: propagate(emb, lay) for key, lay in layouts.items()}
            want = calls["plain"]().float()
            scale = max(1.0, want.abs().max().item())
            for key in calls:
                if key != "plain":
                    diff = (calls[key]().float() - want).abs().max().item()
                    rec[f"{name}_{key}_max_abs_diff"] = diff
                    rec[f"{name}_{key}_matches"] = diff <= MATCH_RTOL[name] * scale
            del want
            times = {key: [] for key in calls}
            for _ in range(repeats):  # in turns: plain, c2, c4, ..., then again
                for key, fn in calls.items():
                    times[key].append(cuda_ms(fn, reps=4, windows=3, warmup=1))
            rec[f"{name}_ms"] = times
            del layouts, calls, emb
        del f32
        torch.cuda.empty_cache()
        out["sizes"][str(n)] = rec
    out["seconds"] = time.perf_counter() - t_start
    out["chunked_faster_at"] = chunked_faster_at(out)
    return out


def chunked_faster_at(result):
    """{dtype: [(nodes, layout), ...]}: where a chunked layout was faster
    than plain ELL in every repeat."""
    found = {name: [] for name in DTYPES}
    for rec in result["sizes"].values():
        if not isinstance(rec, dict):
            continue
        for name in DTYPES:
            times = rec[f"{name}_ms"]
            for key, ts in times.items():
                if key != "plain" and all(t < p for t, p in zip(ts, times["plain"])):
                    found[name].append((rec["nodes"], key))
    return found


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--budget_s", type=float, default=300.0)
    p.add_argument("--sizes", default=",".join(str(n) for n in SIZES),
                   help="node counts, comma-separated")
    p.add_argument("--chunks", default=",".join(str(c) for c in CHUNKS),
                   help="chunk counts, comma-separated")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the experiment runs on the card only")
    result = scan(torch.device("cuda"), sizes=[int(n) for n in args.sizes.split(",")],
                  chunks=[int(c) for c in args.chunks.split(",")], budget_s=args.budget_s)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
