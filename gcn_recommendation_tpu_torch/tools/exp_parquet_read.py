"""Time ``data/parquet.py::read_columns`` on a dataset of the north-star size.

The dataset is ``generate_synthetic_dataset`` at the north-star graph's
size (``tools/exp_scale.py``'s constants: 500k users, 200k items, 20k
brands, mean degree 30, core 8, the popularity style: 16.8M train rows),
written by the port's writer (required INT32 columns, PLAIN,
UNCOMPRESSED).  Where pandas and
pyarrow are installed, ``--write`` also writes the same arrays as pandas'
``to_parquet`` does (what the JAX package's ``prepare`` writes: optional
INT32 columns, SNAPPY, a PLAIN dictionary page with RLE_DICTIONARY data
pages and PLAIN fallback pages) under ``<name>.pandas.parquet``.

    python -m gcn_recommendation_tpu_torch.tools.exp_parquet_read --write DIR
    python -m gcn_recommendation_tpu_torch.tools.exp_parquet_read --read DIR

``--read`` times ``read_columns`` on every ``*.parquet`` of DIR (best and
median of ``--repeats``; the first call builds the native decoder and is
not timed) and prints one JSON line per file, then the host's
architecture and CPU count.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import platform
import statistics
import time

from gcn_recommendation_tpu_torch.tools.exp_scale import (
    CORE,
    MEAN_DEGREE,
    NUM_BRANDS,
    NUM_ITEMS,
    NUM_USERS,
    SEED,
)


def write(out_dir: str, num_users: int, num_items: int, num_brands: int) -> None:
    from gcn_recommendation_tpu_torch.data.parquet import read_columns
    from gcn_recommendation_tpu_torch.data.synthetic import generate_synthetic_dataset

    t0 = time.perf_counter()
    generate_synthetic_dataset(out_dir, num_users=num_users, num_items=num_items,
                               num_brands=num_brands, mean_degree=MEAN_DEGREE, core=CORE,
                               seed=SEED, embedding_dim=0)
    print(f"generated in {time.perf_counter() - t0:.1f} s")
    try:
        import pandas as pd
    except ImportError:
        print("no pandas: wrote the port's files only")
        return
    for name in ("train", "test"):
        cols = read_columns(os.path.join(out_dir, f"{name}.parquet"))
        pd.DataFrame(cols).to_parquet(os.path.join(out_dir, f"{name}.pandas.parquet"),
                                      index=False)


def read(in_dir: str, repeats: int) -> None:
    from gcn_recommendation_tpu_torch.data.parquet import read_columns

    for path in sorted(glob.glob(os.path.join(in_dir, "*.parquet"))):
        cols = read_columns(path)  # builds the native decoder once
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            read_columns(path)
            times.append(time.perf_counter() - t0)
        rows = len(next(iter(cols.values())))
        print(json.dumps({"file": os.path.basename(path), "rows": rows,
                          "mbytes": round(os.path.getsize(path) / 1e6, 3),
                          "best_s": min(times), "median_s": statistics.median(times),
                          "repeats": repeats}), flush=True)
    print(f"host: {platform.machine()}, {os.cpu_count()} CPUs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", type=str, default=None)
    ap.add_argument("--read", type=str, default=None)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    args = ap.parse_args(argv)
    if not (args.write or args.read):
        ap.error("give --write DIR and/or --read DIR")
    if args.write:
        write(args.write, args.num_users, args.num_items, args.num_brands)
    if args.read:
        read(args.read, args.repeats)


if __name__ == "__main__":
    main()
