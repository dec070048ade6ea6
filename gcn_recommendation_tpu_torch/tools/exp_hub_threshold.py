"""Experiment: the hub threshold of the ELL graph, swept on the card.

Counterpart of the JAX package's ``tools/exp_hub_threshold.py``.  A
destination row of more than ``dense_threshold`` neighbors leaves the ELL
buckets for the hub matrix (``graph/build.py``): an ``[H, N]`` dense
product that replaces that row's gathers.  This sweeps the threshold over
the JAX tool's values (512, 320, 256, 192, 128, 96) on its graph (50k
users / 20k items / 2k brands, degree 28, core 8) and times one
per-layer propagation of the port's ELL ``DeviceGraph`` (d = 64): forward, and
forward + backward (the gradient of ``sum(out**2)``, one step of
``e -= 1e-3 * grad``).  The port builds its graphs at 128, the JAX
package's value, which this measures on the card.

    python -m gcn_recommendation_tpu_torch.tools.exp_hub_threshold

Times are CUDA-event medians over chains of ``CHAIN`` dependent
propagations (``utils/timing.py``); ``--device cpu`` times the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CHAIN = 30
THRESHOLDS = (512, 320, 256, 192, 128, 96)


def build_graph(bundle, thresh: int):
    """The bundle's normalized adjacency with hub rows above ``thresh``."""
    from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency

    tr, ib = bundle.train, bundle.item_brand
    return build_normalized_adjacency(
        tr.user_idx, tr.item_idx, bundle.num_users, bundle.num_items, bundle.num_brands,
        item_brand_item_idx=ib.item_idx, item_brand_brand_idx=ib.brand_idx,
        dense_threshold=thresh)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=50_000)
    ap.add_argument("--num_items", type=int, default=20_000)
    ap.add_argument("--num_brands", type=int, default=2_000)
    ap.add_argument("--thresholds", type=int, nargs="+", default=list(THRESHOLDS))
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph
    from gcn_recommendation_tpu_torch.utils.timing import cuda_windows, device_line, host_windows

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    bundle = synthetic_bundle(num_users=args.num_users, num_items=args.num_items,
                              num_brands=args.num_brands, mean_degree=28.0, core=8, seed=42)
    rng = np.random.default_rng(0)
    rows = []
    for thresh in args.thresholds:
        g = build_graph(bundle, thresh)
        dg = to_device_graph(g, fuse_layers=False, device=dev)
        n = g.num_nodes
        emb = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32) * 0.1).to(dev)
        padded = sum(b.nbr_idx.size for b in g.buckets)
        h = len(g.dense_node_ids)
        cur = {}

        @torch.no_grad()
        def fwd():
            for _ in range(args.chain):
                cur["e"] = propagate(cur["e"], dg)

        def fwdbwd():
            for _ in range(args.chain):
                e = cur["e"].requires_grad_(True)
                (grad,) = torch.autograd.grad((propagate(e, dg) ** 2).sum(), e)
                cur["e"] = (e - 1e-3 * grad).detach()

        res = {}
        for tag, fn in (("fwd", fwd), ("fwd+bwd", fwdbwd)):
            cur["e"] = emb
            if dev.type == "cuda":
                times = cuda_windows(fn, reps=1, windows=3, warmup=1)
            else:
                times = host_windows(fn, reps=2, warmup=1)
            res[tag] = [t / args.chain for t in times]
        row = dict(thresh=thresh, hubs=h, dense_mb=h * n * 4 / 1e6, padded_rows=padded,
                   buckets=len(g.buckets), fwd_ms=float(np.median(res["fwd"])),
                   fwdbwd_ms=float(np.median(res["fwd+bwd"])),
                   fwd_spread=max(res["fwd"]) / min(res["fwd"]),
                   fwdbwd_spread=max(res["fwd+bwd"]) / min(res["fwd+bwd"]))
        rows.append(row)
        print(f"thresh={thresh:4d}: H={h:5d} dense={row['dense_mb']:6.0f}MB "
              f"padded_rows={padded / 1e6:.2f}M buckets={len(g.buckets):2d} "
              f"fwd={row['fwd_ms']:5.2f}ms fwd+bwd={row['fwdbwd_ms']:6.2f}ms "
              f"(spread {row['fwd_spread']:.3f} / {row['fwdbwd_spread']:.3f})"
              + ("" if dev.type == "cuda" else " (cpu)"), flush=True)
    return {"device": str(dev), "rows": rows}


if __name__ == "__main__":
    main()
