"""What the load modules share: the cell's data, tables and the port's objects
built from them, and the limits of the comparison."""

from __future__ import annotations

import gc
import math
import statistics
from typing import Dict, Tuple

import torch

from benchmark import data, program
from benchmark.harness import Run


def dataset(ctx: Run):
    return data.make_dataset(ctx.cfg["graph"], ctx.seed)


def tables(ctx: Run, ds, keys=data.TABLES):
    return data.draw_tables(ds, ctx.cfg["embedding_dim"], ctx.seed, ctx.device,
                            popularity=ctx.traffic.get("popularity", 0.0), keys=keys)


def compute_dtype(ctx: Run) -> str:
    return ctx.cfg["compute_dtype"]


def build_trainer(ctx: Run, ds, tabs, dtype: str = None, bundle=None):
    """The port's adjacency (unless ``bundle`` holds it already) and its
    ``Trainer`` (the ``graph_build`` span)."""
    config = program.make_config(ctx.cfg, dtype or compute_dtype(ctx))
    with ctx.spans.span("graph_build"):
        if bundle is None:
            bundle = program.make_bundle(ds, ctx.cfg["graph"]["use_brand"])
        trainer = program.make_trainer(config, ds, bundle, tabs, ctx.device)
    return trainer


def nnz(ds) -> int:
    """Stored entries of the normalized adjacency: each distinct user-item
    and item-brand pair, both directions (the train pairs are distinct)."""
    return 2 * (len(ds.train_user) + ds.num_items)


def num_nodes(ds) -> int:
    return ds.num_users + ds.num_items + ds.num_brands


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def limit(ctx: Run, name: str) -> float:
    return float(ctx.limits[name])


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keys=None) -> Tuple[float, str]:
    """The largest ``|prog - ref|`` over leaves, each against the larger of
    its own reference norm and the median leaf's."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in ref)
    worst, at = 0.0, ""
    for k in keys:
        p, r = prog[k], ref[k]
        g = abs(p - r) / max(r, med) if math.isfinite(p) else math.inf
        if g > worst or not math.isfinite(g):
            worst, at = g, k
    return worst, at
