"""Evaluation traffic: the window calls ``Trainer.validate()`` in a loop:
the no-grad forward (``Trainer._forward_eval``), then ``evaluate_batches``
over every validation user, train items masked, top-k in the stable tie
order, Recall@k and NDCG@k back on the host.

The tables carry the seed's popularity direction (``data.draw_tables``),
so that the ranking finds thousands of held-out items.  The benchmark
wraps the trainer's ``_forward_eval`` to keep the forward's output of
each pass (and, traced, to put CUDA events around it); after the window
the plain reference works the final embeddings and the ranking out again
from the same tables.  Compared: the largest gap of the final embeddings
over the largest reference entry, and how far each pass's NDCG@k lies
outside the bounds that the reference's near-ties (``TIE``) allow.

``eval_users_per_s`` is the validation users times the passes completed
over the window's time; each pass ends when its metrics reach the host.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import roofline
from benchmark.loads import common
from benchmark.harness import Outcome, Run, memory_peak
from benchmark.reference import lightgcn as ref
from benchmark.timing import CudaSpan
from benchmark.trace import DeviceTrace, sync


class ForwardTap:
    """Wraps a trainer's ``_forward_eval``: keeps the last pass's (final
    users, final items) and, when ``timed``, CUDA events around each call."""

    def __init__(self, trainer, device, timed: bool):
        self.inner, self.device, self.timed = trainer._forward_eval, device, timed
        self.spans, self.last = [], None
        trainer._forward_eval = self

    def __call__(self):
        if not self.timed:
            out = self.inner()
        else:
            with CudaSpan(self.device) as s:
                out = self.inner()
            self.spans.append(s)
        self.last = out[:2]
        return out


# Near-ties for the ranking's comparison: scores within this share of the
# user's best score.  The program's and the reference's float32 scores
# differ by ~1e-6 of it (another sum order); the control's bf16 storage
# moves them by ~1e-3.
TIE = 1e-5


def reference(ctx: Run, ds):
    """The reference's final users, final items and metric bounds."""
    t = time.perf_counter()
    ref.full_precision()
    adj = ref.adjacency(ds, ctx.device)
    rfu, rfi = ref.final_embeddings(adj, common.tables(ctx, ds), ctx.cfg["n_layers"])
    del adj
    m = ref.recall_ndcg(ds, rfu, rfi, ctx.cfg["top_k"], tie=TIE)
    ctx.log(f"reference {time.perf_counter() - t:.2f} s: {m}")
    return rfu, rfi, m


def compare(refr, results, fu, fi) -> dict:
    """The compared numbers of passes that gave ``results`` and, in the
    last of them, the final embeddings ``fu``, ``fi``: the largest gap of
    the embeddings over the largest reference entry, and how far the
    worst pass's NDCG@k lies outside the reference's near-tie bounds."""
    rfu, rfi, m = refr
    scale = float(torch.maximum(rfu.abs().max(), rfi.abs().max()))
    emb = float(torch.maximum((fu - rfu).abs().max(), (fi - rfi).abs().max())) / scale
    # Recall@k is not compared: a hit is worth 1 / users, and the control moves
    # none on some seeds; a moved hit moves NDCG@k too
    out = max(max(m["ndcg_lo"] - r[1], r[1] - m["ndcg_hi"], 0.0) if math.isfinite(r[1])
              else math.inf for r in results)
    return {"emb_gap": emb, "ndcg_outside": out}


def run(ctx: Run) -> Outcome:
    cfg = ctx.cfg
    ds = common.dataset(ctx)
    trainer = common.build_trainer(ctx, ds, common.tables(ctx, ds))
    common.free(ctx.device)
    tap = ForwardTap(trainer, ctx.device, timed=ctx.trace)
    for _ in range(int(ctx.traffic["warmup_passes"])):
        trainer.validate()
    tap.spans.clear()
    sync(ctx.device)

    results, passes = [], []
    with DeviceTrace(ctx.trace, ctx.device) as tr:
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        while time.perf_counter() < deadline:
            if ctx.trace:
                with CudaSpan(ctx.device) as s:
                    results.append(trainer.validate())
                passes.append(s)
            else:
                results.append(trainer.validate())
        t_end = time.perf_counter()
    window_s = t_end - t_start
    peak = memory_peak(ctx.device)
    n_users = len(ds.val_user)
    fu, fi = (x.detach() for x in tap.last)
    forward_ms = [s.ms() for s in tap.spans] if ctx.trace else []
    pass_ms = [s.ms() for s in passes]
    ctx.log(f"window: {len(results)} passes in {window_s:.4f} s; set-up {t_start - ctx.t0:.3f} s")
    del trainer, tap
    common.free(ctx.device)

    ctx.log(f"program's passes: first {results[0]!r}, last {results[-1]!r}")
    checks = compare(reference(ctx, ds), results, fu, fi)
    failed = sum(1 for r in results if not all(map(math.isfinite, r)))

    n = common.num_nodes(ds)
    d, k = cfg["embedding_dim"], cfg["top_k"]
    seen = int(np.bincount(ds.train_user, minlength=ds.num_users)[ds.val_user].sum())
    fwd = roofline.forward(common.nnz(ds), n, d, cfg["n_layers"])
    rank = roofline.ranking(n_users, ds.num_items, d, seen, k)
    return Outcome(
        e2e={"eval_users_per_s": len(results) * n_users / window_s,
             "setup_s": t_start - ctx.t0, "peak_mem_gib": peak / 2**30},
        obs={"graph_build_s": sum(ctx.spans.host["graph_build"]), "forward_ms": forward_ms,
             "pass_ms": pass_ms, "forward_work": (fwd.ops, fwd.nbytes),
             "rank_work": (rank.ops, rank.nbytes), "trace": tr.summary},
        checks={name: (v, common.limit(ctx, name)) for name, v in checks.items()},
        attempted=len(results), failed=failed, memory_peak_bytes=peak)
