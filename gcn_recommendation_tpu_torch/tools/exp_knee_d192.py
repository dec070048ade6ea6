"""Experiment: the gather rate at d = 192 across the port's bytes-model knee.

Counterpart of the JAX package's ``tools/exp_knee_d192.py``, which pinned
where the TPU's gather knee falls for rows of 1.5 lane tiles.  The port's
knee is a table size, not a tile count: ``ops/spmm.py::knee_rows_for``
scales ``GATHER_KNEE_ROWS`` (500k f32 d = 64 rows, ~128 MB) by the row's
bytes, which at d = 192 gives 166,666 rows, inside this sweep.  It times
the same gather as ``tools/exp_dim_split.py`` (``ROWS_PER_ITER`` random
rows by ``index_select`` into a buffer made once, ``CHAIN`` calls a
CUDA-event window) from d = 192 tables of {60k, 90k, 120k, 150k, 180k,
240k} rows, prints the JAX tool's ``tiles ceil= frac=`` columns as labels
(the TPU's 8 x 128 tile counts of each table; no model of this card), and
says whether the rate per row changes across the port's knee.

    python -m gcn_recommendation_tpu_torch.tools.exp_knee_d192

``--device cpu`` times the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

ROWS_PER_ITER = 4_000_000
CHAIN = 20
SRC_ROWS = (60_000, 90_000, 120_000, 150_000, 180_000, 240_000)
DIM = 192


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(SRC_ROWS))
    ap.add_argument("--rows_per_iter", type=int, default=ROWS_PER_ITER)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.ops.spmm import knee_rows_for
    from gcn_recommendation_tpu_torch.tools.exp_dim_split import time_gather
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    dev = resolve_device(args.device)
    cpu = "" if dev.type == "cuda" else " (cpu)"
    print(device_line(dev), flush=True)
    knee = knee_rows_for(DIM)
    print(f"port bytes-model knee: knee_rows_for({DIM}) = {knee:,} rows", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for src in args.rows:
        r = time_gather(rng, src, DIM, args.rows_per_iter, args.chain, dev)
        tiles_ceil = (src // 8) * -(-DIM // 128)
        tiles_frac = (src // 8) * DIM / 128
        r.update(tiles_ceil=tiles_ceil, tiles_frac=tiles_frac, above_knee=src > knee)
        rows.append(r)
        print(f"rows={src / 1e3:6.0f}k d={DIM}: {r['ns_per_row']:5.2f} ns/row  "
              f"tiles ceil={tiles_ceil / 1e3:6.1f}k frac={tiles_frac / 1e3:6.1f}k"
              f"  (spread {r['spread']:.3f}){cpu}", flush=True)
    below = [r["ns_per_row"] for r in rows if not r["above_knee"]]
    above = [r["ns_per_row"] for r in rows if r["above_knee"]]
    verdict = None
    if below and above:
        verdict = float(np.mean(above) / np.mean(below))
        print(f"across the port's knee ({knee:,} rows): mean {np.mean(below):.2f} ns/row "
              f"at or below, {np.mean(above):.2f} above (x{verdict:.3f})", flush=True)
    else:
        print(f"the sweep does not cross the port's knee ({knee:,} rows)", flush=True)
    return {"device": str(dev), "knee_rows": knee, "rows": rows, "above_over_below": verdict}


if __name__ == "__main__":
    main()
