"""Experiment: two forms of one propagation, per-bucket gathers or one flat gather.

Counterpart of the JAX package's ``tools/exp_spmm_variants.py``, on its
graph (50k users / 20k items / 2k brands, degree 28, core 8, seed 42; the
view of ``to_device_graph(g)`` with its default arguments), d = 64:

  bucketed  the port's production ELL matvec (``ops/spmm.py::_ell_matvec``:
            per degree bucket a gather, multiply and reduce through
            ``_bucket_reduce``, the hub product, the restore gather)
  flat      one ``index_select`` over the concatenated padded neighbor
            lists, then per-bucket reshape-sums, the hub product and the
            restore gather (the JAX tool's ``matvec_flat``)

The same gathered rows in fewer launches: the question is how much of a
small graph's propagation is the host's dispatch.  Each form is timed
forward and forward + backward (one step ``e -= 1e-3 * grad(sum(A e)^2)``)
over chains of ``CHAIN`` dependent calls, with the host (CUDA events
around eager calls, ``cuda_ms``) and without it (the same calls replayed
from a CUDA graph, ``graph_ms``); the gap is the host's share.  The
bucketed backward is the production symmetric one (``_PropagateEll``:
the same gather product on the cotangent); the flat form's is autograd's
(``index_add_`` through its gathers).  One ``torch.profiler`` pass counts
the CUDA kernels of one call.  The numbers agree first: ``max |bucketed
- flat| < 1e-4``, the JAX tool's own check.

    python -m gcn_recommendation_tpu_torch.tools.exp_spmm_variants
    python -m gcn_recommendation_tpu_torch.tools.exp_spmm_variants \\
        --num_users 10000 --num_items 5000      # the books regime's size

``--device cpu`` runs the forms on the CPU, with host times only.
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


def flat_layout(dg):
    """(flat_idx, flat_w, [(nb, width)], offsets) of the concatenated
    padded neighbor lists of a DeviceGraph's buckets."""
    flat_idx = torch.cat([i.reshape(-1) for i in dg.bucket_nbr_idx])
    flat_w = torch.cat([w.reshape(-1) for w in dg.bucket_nbr_w])
    shapes = [tuple(i.shape) for i in dg.bucket_nbr_idx]
    offs = np.cumsum([0] + [nb * w for nb, w in shapes]).tolist()
    return flat_idx, flat_w, shapes, offs


def matvec_bucketed(emb, dg):
    """The production ELL matvec (forward of ``propagate_ell``)."""
    from gcn_recommendation_tpu_torch.ops.spmm import _ell_matvec

    return _ell_matvec(emb, dg.bucket_nbr_idx, dg.bucket_nbr_w, dg.gather_idx, dg.dense_mat)


def matvec_flat(emb, dg, flat):
    """One gather over all padded neighbor rows, then per-bucket sums."""
    from gcn_recommendation_tpu_torch.ops.spmm import _hub_rows

    flat_idx, flat_w, shapes, offs = flat
    gathered = emb.index_select(0, flat_idx) * flat_w[:, None]   # [R, d]
    parts = [gathered[off:off + nb * w].reshape(nb, w, -1).sum(1)
             for (nb, w), off in zip(shapes, offs)]
    if dg.dense_mat.shape[0]:
        parts.append(_hub_rows(dg.dense_mat, emb).to(emb.dtype))
    parts.append(emb.new_zeros((1, emb.shape[1])))
    return torch.cat(parts, dim=0).index_select(0, dg.gather_idx)


def cuda_kernels_per_call(fn) -> int:
    """CUDA kernels launched by one ``fn()``, from one ``torch.profiler``
    pass (copies and memsets are not kernels); -1 when the profiler
    delivers no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) if names else -1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.ops.spmm import propagate_ell, to_device_graph
    from gcn_recommendation_tpu_torch.utils.timing import (
        cuda_windows,
        device_line,
        graph_ms,
        host_windows,
    )

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(device_line(dev), flush=True)
    bundle = synthetic_bundle(num_users=args.num_users, num_items=args.num_items,
                              num_brands=args.num_brands, mean_degree=MEAN_DEGREE,
                              core=8, seed=42)
    g = bundle.graph
    n = g.num_nodes
    dg = to_device_graph(g, device=dev)
    print(f"graph: nodes={n} nnz={g.nnz} buckets={len(g.buckets)} "
          f"padded_rows={sum(b.nbr_idx.size for b in g.buckets)} "
          f"hubs={len(g.dense_node_ids)}", flush=True)
    flat = flat_layout(dg)
    rng = np.random.default_rng(0)
    emb0 = torch.from_numpy(rng.standard_normal((n, args.dim)).astype(np.float32) * 0.1).to(dev)

    with torch.no_grad():
        a, b = matvec_bucketed(emb0, dg), matvec_flat(emb0, dg, flat)
    err = float((a - b).abs().max())
    print(f"max |bucketed - flat| = {err:.2e}", flush=True)
    if not err < 1e-4:
        raise AssertionError(f"bucketed and flat disagree: {err:.2e}")
    print("backward: bucketed = the production symmetric backward (_PropagateEll, the "
          "same gather product on the cotangent); flat = autograd's (index_add_ "
          "through its gathers)", flush=True)

    graph_args = (dg.bucket_nbr_idx, dg.bucket_nbr_w, dg.gather_idx, dg.dense_mat)
    forms = {"bucketed": lambda e: propagate_ell(e, *graph_args),
             "flat": lambda e: matvec_flat(e, dg, flat)}
    rows = []
    for name, fn in forms.items():
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

        @torch.no_grad()
        def one_fwd():
            fn(cur["e"])

        def one_bwd():
            e = cur["e"].detach().requires_grad_(True)
            torch.autograd.grad((fn(e) ** 2).sum(), e)

        for tag, chain in (("fwd", fwd), ("fwd+bwd", fwdbwd)):
            cur["e"] = emb0
            row = dict(form=name, tag=tag)
            if cuda:
                times = cuda_windows(chain, reps=1, windows=3, warmup=1)
                row["ms"] = float(np.median(times)) / args.chain
                row["spread"] = max(times) / min(times)
                cur["e"] = emb0
                row["graph_ms"] = graph_ms(chain, reps=1, windows=3) / args.chain
                row["host_share"] = 1.0 - row["graph_ms"] / row["ms"]
                cur["e"] = emb0
                row["kernels"] = cuda_kernels_per_call(one_fwd if tag == "fwd" else one_bwd)
                print(f"{name:12s} {tag:8s} {row['ms']:7.2f} ms/prop-step   "
                      f"cuda graph {row['graph_ms']:7.2f} ms  host share "
                      f"{row['host_share'] * 100:5.1f}%  {row['kernels']} CUDA kernels a call  "
                      f"(spread {row['spread']:.3f})", flush=True)
            else:
                times = host_windows(chain, reps=2, warmup=1)
                row["ms"] = float(np.median(times)) / args.chain
                print(f"{name:12s} {tag:8s} {row['ms']:7.2f} ms/prop-step (cpu)", flush=True)
            rows.append(row)
    return {"device": str(dev), "max_abs_diff": err, "rows": rows,
            "bucketed": a.cpu(), "flat": b.cpu()}


if __name__ == "__main__":
    main()
