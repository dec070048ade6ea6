"""Stress test: the north-star graph on one card.

Counterpart of the JAX package's ``tools/exp_scale.py``: 500k users, 200k
items, 20k brands, mean degree 30 (~16M train interactions, ~33M-entry
normalized adjacency).  It runs the whole pipeline at that size through
the port's entry points: the ETL (``synthetic_bundle``), the ``Trainer``
(the knee rule picks the source-chunked layout at this size), 20-step
training windows, full-catalog validation over the whole validation split,
and a ``Retriever`` with the f32 and the int8 catalog (the int8 quantizer
K2 at every load and every request).

    python -m gcn_recommendation_tpu_torch.tools.exp_scale [--dim D] [--layers K]

Defaults dim 64, 3 layers; ``--dim 256 --layers 4`` is the scaled
configuration (``BASELINE.json`` ``configs[4]``).  The entry points run on
the card unless ``--device cpu`` is given; ``--num_users`` /
``--num_items`` / ``--num_brands`` shrink the graph (the tests run it
small on the CPU).  Lines, in order: ``ETL``, ``config``, ``device
setup``, ``first steps``, ``train`` (best of 3 windows of 20 steps),
``eval``, ``eval (cached batches)``, then one ``serve`` line per catalog.
A graph smaller than 20 batches of 2048 runs windows of one epoch.
Peak device memory is ``torch.cuda.max_memory_allocated`` since the
device setup began; on the CPU it is not measured.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.core.device import resolve_device
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import quant
from gcn_recommendation_tpu_torch.ops.spmm import (
    ChunkedDeviceGraph,
    to_device_chunked_graph,
    to_device_graph,
)
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.train.trainer import Trainer

NUM_USERS = 500_000
NUM_ITEMS = 200_000
NUM_BRANDS = 20_000
MEAN_DEGREE = 30.0
CORE = 8
SEED = 42
BATCH = 2048
STEPS = 20
WINDOWS = 3
REQUEST_SIZES = (1, 64, 1024)
K = 20


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return "none (cpu)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_gib(dev: torch.device) -> Optional[float]:
    """Peak device memory since the last reset, GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def _gib(x: Optional[float]) -> str:
    return "not measured (cpu)" if x is None else f"{x:.2f} GiB"


def trainer_class(chunks: Optional[int]):
    """``Trainer`` with the layout rule as asked: None = the knee rule,
    0 = the plain (fused ELL) layout, N = N source chunks."""
    if chunks is None:
        return Trainer

    class ForcedLayoutTrainer(Trainer):
        def _device_graph(self):
            g = self.model.padded_graph(self.bundle.graph)
            cdtype = getattr(torch, self.config.compute_dtype)
            if chunks == 0:
                return to_device_graph(g, compute_dtype=cdtype, device=self.device)
            print(f"Graph: source-chunked gathers ({chunks} chunks, forced)")
            return to_device_chunked_graph(g, chunks, compute_dtype=cdtype, device=self.device)

    return ForcedLayoutTrainer


def layout_of(graph) -> str:
    if isinstance(graph, ChunkedDeviceGraph):
        return f"chunked C={graph.num_chunks}"
    return "plain ELL (merge-skip)" if getattr(graph, "fused", False) else type(graph).__name__


def build_bundle(num_users: int = NUM_USERS, num_items: int = NUM_ITEMS,
                 num_brands: int = NUM_BRANDS):
    """The graph's bundle from the ETL (``synthetic_bundle``) and its seconds."""
    t0 = time.perf_counter()
    bundle = synthetic_bundle(
        num_users=num_users, num_items=num_items, num_brands=num_brands,
        mean_degree=MEAN_DEGREE, core=CORE, seed=SEED,
    )
    return bundle, time.perf_counter() - t0


def serve(model, params, bundle, dev, quantize: bool, rng) -> dict:
    """Load a ``Retriever`` and answer one request of each of
    ``REQUEST_SIZES`` users (at most the active ones), counting K2's
    launches from 0 over that load and those requests; then time each
    request (median of 5, each ending in a copy to the host).  Returns
    ``load_s``, ``k2_launches`` (stochastic, nearest), ``answers`` (users,
    values, items per request) and ``request_ms`` by request size."""
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    r = Retriever.from_params(model, params, bundle, quantize=quantize)
    _sync(dev)
    load_s = time.perf_counter() - t0
    active = np.unique(bundle.train.user_idx)
    requests = [rng.choice(active, min(n, len(active)), replace=False).astype(np.int32)
                for n in REQUEST_SIZES]
    answers = [(users, *r.recommend(users, k=K)) for users in requests]
    k2 = (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches)
    request_ms = {}
    for users, v, _ in answers:
        if v.shape != (len(users), K) or not np.isfinite(v).all():
            raise RuntimeError(f"serve: {len(users)} users gave {v.shape}, finite "
                               f"{np.isfinite(v).all()}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            r.recommend(users, k=K)
            times.append((time.perf_counter() - t0) * 1e3)
        request_ms[len(users)] = statistics.median(times)
    return {"load_s": load_s, "k2_launches": k2, "answers": answers,
            "request_ms": request_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--eval_batch", type=int, default=None,
                    help="override eval_user_batch (default 1024)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="override graph chunking: 0 = plain layout, "
                         "N = force N source chunks; default = the knee rule")
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    cli = ap.parse_args(argv)
    dev = resolve_device(cli.device)
    card = card_line(dev)

    bundle, etl_s = build_bundle(cli.num_users, cli.num_items, cli.num_brands)
    g = bundle.graph
    padded = sum(b.nbr_idx.size for b in g.buckets)
    print(
        f"ETL {etl_s:.1f}s: train={len(bundle.train):,} nnz={g.nnz:,} "
        f"buckets={len(g.buckets)} padded_rows={padded:,} "
        f"hubs={len(g.dense_node_ids)} dense={g.dense_mat.nbytes/1e6:,.0f}MB",
        flush=True,
    )

    cfg = Config(batch_size=BATCH, embedding_dim=cli.dim, n_layers=cli.layers,
                 compute_dtype=cli.compute_dtype, seed=SEED)
    if cli.eval_batch:
        cfg.eval_user_batch = cli.eval_batch
    print(f"config: dim={cli.dim} layers={cli.layers} chunks={cli.chunks} "
          f"dtype={cli.compute_dtype} nodes={g.num_nodes:,} device={dev.type} card={card}",
          flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    trainer = trainer_class(cli.chunks)(cfg, model, bundle)
    steps = trainer.steps_per_epoch = min(STEPS, trainer.steps_per_epoch)
    trainer.init_state()
    _sync(dev)
    print(f"device setup {time.perf_counter() - t0:.1f}s: layout={layout_of(trainer.graph)} "
          f"peak={_gib(peak_gib(dev))}", flush=True)

    t0 = time.perf_counter()
    losses = trainer.run_epoch()  # ends in a copy to the host
    print(f"first steps {time.perf_counter() - t0:.1f}s ({steps} steps, "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f})", flush=True)

    best = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        losses = trainer.run_epoch()
        best = min(best, time.perf_counter() - t0)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite training loss: {losses}")
    step = best / steps
    edges_per_s = 2 * cli.layers * g.nnz / step  # K fwd + K bwd propagations
    print(
        f"train: {step*1e3:.1f} ms/step  {BATCH/step:,.0f} ex/s  "
        f"({edges_per_s/1e9:.2f}B edge-ops/s)  peak={_gib(peak_gib(dev))}  "
        f"layout={layout_of(trainer.graph)}  card={card}",
        flush=True,
    )

    # full-catalog evaluation over the whole validation split
    n_eval = len(np.unique(bundle.val.user_idx))
    t0 = time.perf_counter()
    recall, _ = trainer.validate()
    dt = time.perf_counter() - t0
    print(
        f"eval: {n_eval:,} users x {bundle.num_items:,} items in {dt:.1f}s "
        f"({n_eval/dt:,.0f} users/s incl. one-time batch build) "
        f"recall={recall:.4f}  peak={_gib(peak_gib(dev))}",
        flush=True,
    )
    t0 = time.perf_counter()
    trainer.validate()
    dt = time.perf_counter() - t0
    print(f"eval (cached batches): {n_eval/dt:,.0f} users/s ({dt:.1f}s)", flush=True)

    params = trainer.params()
    rng = np.random.default_rng(0)
    for quantize in (False, True):
        s = serve(model, params, bundle, dev, quantize, rng)
        ms = "  ".join(f"{n}={t:.2f}" for n, t in s["request_ms"].items())
        k2 = (f"  K2 launches stochastic={s['k2_launches'][0]} "
              f"nearest={s['k2_launches'][1]}" if quantize else "")
        print(f"serve {'int8' if quantize else 'f32'}: load {s['load_s']:.1f}s  "
              f"request ms by users {ms}{k2}  peak={_gib(peak_gib(dev))}  card={card}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
