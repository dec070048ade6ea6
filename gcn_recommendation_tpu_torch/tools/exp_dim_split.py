"""Experiment: gather rates over (source rows x row width), for the feature-split question.

Counterpart of the JAX package's ``tools/exp_dim_split.py``.  A d = 256
propagation can run as two d = 128 halves, ``A @ [E1|E2] = [A@E1 | A@E2]``
(feature split), or over source chunks of the full width (the port's
source-chunked layout, ``ops/spmm.py``: at most ``MAX_GATHER_CHUNKS``
chunks, each under ``knee_rows_for(d)`` rows).  This measures the raw
gather rate, ns per gathered row, of ``ROWS_PER_ITER`` random rows from
tables of {90k, 180k, 360k, 720k} rows x d {128, 256}, and prints the JAX
tool's four candidate costs per 256-wide destination-row-equivalent:

  plain        720k x 256            (one gather of the whole width)
  split        2 x (720k x 128)      (feature split, no chunking)
  split+chunk  2 x (180k x 128)      (feature split over source chunks)
  chunk-only   180k x 256            (source chunks of the full width)

Each call is ``torch.index_select(e, 0, idx, out=buf)`` into a buffer made
once (the allocator stays out of the window; at 720k x 256 f32 the output
is 4 GB); ``CHAIN`` calls a CUDA-event window, the median of three
(``utils/timing.py``).  The chunked forms add their merge, which a gather
rate does not show.

    python -m gcn_recommendation_tpu_torch.tools.exp_dim_split

``--device cpu`` times the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

ROWS_PER_ITER = 4_000_000
CHAIN = 20
SRC_ROWS = (90_000, 180_000, 360_000, 720_000)
DIMS = (128, 256)


def gather_case(rng, src_rows: int, d: int, rows_per_iter: int, dev):
    """(table [src_rows, d] f32, idx [rows_per_iter] int64, out buffer),
    drawn as the JAX tool draws them."""
    emb = torch.from_numpy(rng.standard_normal((src_rows, d)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, src_rows, rows_per_iter, dtype=np.int64)).to(dev)
    return emb, idx, torch.empty((rows_per_iter, d), dtype=emb.dtype, device=dev)


def time_gather(rng, src_rows: int, d: int, rows_per_iter: int, chain: int, dev) -> dict:
    """ns per gathered row of ``index_select`` into a preallocated buffer."""
    from gcn_recommendation_tpu_torch.utils.timing import cuda_windows, host_windows

    emb, idx, buf = gather_case(rng, src_rows, d, rows_per_iter, dev)

    def call():
        torch.index_select(emb, 0, idx, out=buf)

    if dev.type == "cuda":
        times = cuda_windows(call, reps=chain, windows=3, warmup=2)
    else:
        times = host_windows(call, reps=3, warmup=1)
    ms = float(np.median(times))
    del emb, idx, buf
    return dict(rows=src_rows, d=d, ms=ms, ns_per_row=ms * 1e6 / rows_per_iter,
                spread=max(times) / min(times))


def _k(rows: int) -> str:
    return f"{rows / 1e3:.0f}k"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(SRC_ROWS),
                    help="source-table rows to sweep")
    ap.add_argument("--rows_per_iter", type=int, default=ROWS_PER_ITER)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.ops.spmm import MAX_GATHER_CHUNKS, knee_rows_for
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    dev = resolve_device(args.device)
    cpu = "" if dev.type == "cuda" else " (cpu)"
    print(device_line(dev), flush=True)
    print(f"port chunking rule: MAX_GATHER_CHUNKS = {MAX_GATHER_CHUNKS}, "
          f"knee_rows_for(256) = {knee_rows_for(256):,} rows, "
          f"knee_rows_for(128) = {knee_rows_for(128):,} rows (f32)", flush=True)
    rng = np.random.default_rng(0)
    rates, rows = {}, []
    for src in args.rows:
        for d in DIMS:
            r = time_gather(rng, src, d, args.rows_per_iter, args.chain, dev)
            rates[(src, d)] = r["ns_per_row"]
            rows.append(r)
            print(f"{'gather':28s} rows={src / 1e3:6.0f}k d={d:3d}: "
                  f"{r['ns_per_row']:5.2f} ns/gathered-row  (spread {r['spread']:.3f}){cpu}",
                  flush=True)

    big = max(args.rows)
    chunk = big // 4  # the JAX tool's 180k slices of 720k
    lines = [((big, 256), 1, f"  plain   {_k(big)} x 256          "),
             ((big, 128), 2, f"  split   2 x ({_k(big)} x 128)    "),
             ((chunk, 128), 2, f"  split+chunk 2 x ({_k(chunk)} x 128)"),
             ((chunk, 256), 1, f"  chunk-only   {_k(chunk)} x 256     ")]
    summary = {}
    print("\nPer 256-wide destination-row-equivalent (gather cost only):")
    for key, times, label in lines:
        if key in rates:
            summary[label.strip()] = times * rates[key]
            print(f"{label}: {times * rates[key]:5.2f} ns")
    print("(the chunked forms add their merge, which a gather rate leaves out:")
    print(" a split+chunk win must clear plain by more than the d=128 merge")
    print(" cost x2.)", flush=True)
    return {"device": str(dev), "rows": rows, "summary": summary,
            "knee_rows_256": knee_rows_for(256), "max_gather_chunks": MAX_GATHER_CHUNKS}


if __name__ == "__main__":
    main()
