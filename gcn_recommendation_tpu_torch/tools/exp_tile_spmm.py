"""Experiment: the tile partition's propagation against the plain ELL one.

Counterpart of the JAX package's ``tools/exp_tile_spmm.py``: on the
heavy-tailed bench graph (50k users / 20k items / 2k brands, degree 28,
core 8, the latent generator with ``pop_zipf=0.6``, ``deg_sigma=1.0``,
``spectrum=1.0``, ``split="rank"``, ``rank_key="taste"``), the production
tile path (``ops/block_spmm.py::TiledDeviceGraph``: the residual ELL
and hub rows plus the tiles through ``tile_matvec``, the CUDA kernel of
the tiles' layout) is timed against the plain per-layer ELL
``DeviceGraph`` on the same graph, both through ``ops/spmm.py::propagate``,
for ``min_fill`` 64 and 128 and f32 and bf16 tiles, forward and forward +
backward (the gradient of ``sum(out**2)``, one step of ``e -= 1e-3 *
grad``).  It prints the partition, the largest difference
from the ELL propagation, and each time beside ELL's, as the JAX tool
does.

    python -m gcn_recommendation_tpu_torch.tools.exp_tile_spmm

Times are CUDA-event medians over chains of ``CHAIN`` dependent
propagations (``utils/timing.py``); ``--device cpu`` runs the tiles'
plain version and times the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

NUM_USERS = 50_000
NUM_ITEMS = 20_000
NUM_BRANDS = 2_000
MEAN_DEGREE = 28.0
DIM = 64
CHAIN = 30
MIN_FILLS = (64, 128)


def bench_bundle(num_users=NUM_USERS, num_items=NUM_ITEMS, num_brands=NUM_BRANDS):
    """The heavy-tailed graph of the JAX tool (its generator knobs)."""
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle

    return synthetic_bundle(
        num_users=num_users, num_items=num_items, num_brands=num_brands,
        mean_degree=MEAN_DEGREE, core=8, seed=42, style="latent", pop_zipf=0.6,
        deg_sigma=1.0, spectrum=1.0, split="rank", rank_key="taste")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    ap.add_argument("--min_fills", type=int, nargs="+", default=list(MIN_FILLS))
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
    from gcn_recommendation_tpu_torch.ops.block_spmm import TiledDeviceGraph, to_device_tiles
    from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph
    from gcn_recommendation_tpu_torch.utils.timing import cuda_windows, device_line, host_windows

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print(device_line(dev), flush=True)
    bundle = bench_bundle(args.num_users, args.num_items, args.num_brands)
    g = bundle.graph
    n = g.num_nodes
    print(f"graph: nodes={n} nnz={g.nnz:,} hubs={len(g.dense_node_ids)}", flush=True)
    rng = np.random.default_rng(0)
    emb0 = torch.from_numpy(rng.standard_normal((n, DIM)).astype(np.float32) * 0.1).to(dev)

    def time_variant(name, fn):
        """{tag: (median ms, spread)} of fwd and fwd+bwd chains of ``fn``."""
        cur = {}

        @torch.no_grad()
        def fwd():
            for _ in range(args.chain):
                cur["e"] = fn(cur["e"])

        def fwdbwd():
            for _ in range(args.chain):
                e = cur["e"].detach().requires_grad_(True)
                (grad,) = torch.autograd.grad((fn(e) ** 2).sum(), e)
                cur["e"] = (e - 1e-3 * grad).detach()

        out = {}
        for tag, chain in (("fwd", fwd), ("fwd+bwd", fwdbwd)):
            cur["e"] = emb0
            if on_card:
                times = cuda_windows(chain, reps=1, windows=3, warmup=1)
            else:
                times = host_windows(chain, reps=2, warmup=1)
            ms = float(np.median(times)) / args.chain
            out[tag] = (ms, max(times) / min(times))
            print(f"{name:26s} {tag:8s} {ms:7.2f} ms/prop-step   (spread {out[tag][1]:.3f})"
                  + ("" if on_card else " (cpu)"), flush=True)
        return out

    dg = to_device_graph(g, fuse_layers=False, device=dev)
    baseline = time_variant("ell (plain)", lambda e: propagate(e, dg))
    with torch.no_grad():
        ref = propagate(emb0, dg)
    result = {"device": str(dev), "nnz": int(g.nnz), "ell": baseline, "cases": []}
    for min_fill in args.min_fills:
        part = partition_tiles(g, min_fill=min_fill)
        if part is None:
            print(f"min_fill={min_fill}: no qualifying tiles", flush=True)
            continue
        cov = part.covered_edges / g.nnz * 100
        print(f"\nmin_fill={min_fill}: {part.num_tiles} tiles, "
              f"{part.covered_edges:,} edges covered ({cov:.1f}% of all), "
              f"{part.n_row_blocks} row blocks, "
              f"tile HBM {part.tile_a.nbytes / 1e6:.0f} MB f32", flush=True)
        dres = to_device_graph(part.residual, fuse_layers=False, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            tiles = to_device_tiles(part, tile_dtype=dtype, device=dev)
            tg = TiledDeviceGraph(base=dres, tiles=tiles)
            with torch.no_grad():
                out = propagate(emb0, tg)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            dname = str(dtype).replace("torch.", "")
            print(f"  [{dname}] max err vs ell: {err:.2e} (scale {scale:.2e}; "
                  f"{tiles.layout} layout)", flush=True)
            r = time_variant(f"tiles fill>={min_fill} {dname}",
                             lambda e, tg=tg: propagate(e, tg))
            for tag in r:
                print(f"    -> {tag}: {baseline[tag][0] / r[tag][0]:.2f}x vs plain ELL",
                      flush=True)
            result["cases"].append(dict(min_fill=min_fill, dtype=dname, tiles=part.num_tiles,
                                        covered=int(part.covered_edges), layout=tiles.layout,
                                        max_err=err, scale=scale, times=r))
    return result


if __name__ == "__main__":
    main()
