"""The serving cell's knee: the highest offered rate that the dispatcher
holds without a growing backlog.

    python3 benchmark/sweep.py --workload books_d64.serve --seed 5 \\
        --rates 100,200,400,800 --seconds 8

One set-up (the cell's data, catalog load, dispatcher and warm-up), then
for each fixed rate one open-loop window of the cell's traffic at that
rate.  Prints a JSON line a rate: requests, offered and completed
requests/s, users served within the window a second, p50 / p95 latency,
the median latency of the window's first and last quarter of requests (a
backlog that grows shows as a last quarter far above the first) and the
generator's lateness.  A serving mix's ``rate_per_s`` is set at about 0.8
of the knee this finds; the benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from benchmark import harness
    from benchmark.loads import serve

    torch.set_num_threads(4)
    _, ctx = harness.setup_context(ROOT, args.workload, args.seed, args.seconds, False,
                                   args.device, time.perf_counter())
    ds, disp, active = serve.setup(ctx)
    try:
        serve.warm(ctx, disp, active)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            traffic = dict(ctx.traffic, rate_per_s=rate)
            due, sizes = serve.schedule(traffic, args.seconds)
            users = serve.request_users(traffic, ds, sizes, args.seed)
            lat, late, _, events, missing, window_s, served = serve.open_loop(
                disp, due, users, ctx.cfg["top_k"], keep=set(), grace_s=30.0)
            done = [ev.t for ev in events if ev.t is not None]
            q = max(1, len(lat) // 4)
            print(json.dumps({
                "rate": rate, "requests": len(due), "missing": missing,
                "users_per_request": float(np.mean(sizes)),
                "offered_per_s": len(due) / window_s,
                "completed_per_s": len(done) / (max(done) - min(done) + 1e-9) if done else 0.0,
                "served_users_per_s": served / window_s,
                "p50_ms": float(np.median(lat)) * 1e3, "p95_ms": serve.p95(lat) * 1e3,
                "first_quarter_ms": float(np.median(lat[:q])) * 1e3,
                "last_quarter_ms": float(np.median(lat[-q:])) * 1e3,
                "late_p95_ms": float(np.quantile(late, 0.95)) * 1e3}), flush=True)
    finally:
        disp.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
