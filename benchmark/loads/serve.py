"""Serving traffic: open-loop Poisson arrivals at a fixed rate into the
port's in-process ``server.Dispatcher`` (no HTTP), which coalesces what
is queued, up to ``max_coalesce`` requests, into one
``Retriever.recommend_many``.

The catalog is loaded once through ``Retriever.from_params`` (f32, the
default): the load-time propagation is set-up.  Each request asks for
the top-``top_k`` items of its users with their train items filtered; its
user count is log-uniform on ``[min_users, max_users]`` and its users are
uniform over the users with train rows, without repeats.  The arrival
times, the request sizes and the users are one fixed draw from the mix's
``structure_seed``, the users renumbered as the run's seed renumbers the
graph (``request_users``): every seed offers the same work at the same
moments, since the tail of a queue near its knee turns on where the
bursts fall and on how long each request's filter rows are.

A request is timed from when it was due to when its results were on the
host (the dispatcher's completion event); the generator's lateness is
printed apart.  ``request_p95_ms`` is the 95th percentile over every
request due in the window; a request that fails or never completes (the
run waits ``grace_s`` past the window for each) counts as missing, above
every latency, and in ``failed``.

Checked after the window: a sample of the requests, drawn from the seed,
against the plain reference's masked top-k over its own propagation of
the same tables.  Compared: the largest gap by which a served item's
reference score lies below the reference's score at the same rank, and
the largest gap between a served score and the reference's score of that
item, each over the request row's best reference score.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from benchmark import data, program
from benchmark.loads import common
from benchmark.harness import Outcome, Run, memory_peak
from benchmark.reference import lightgcn as ref
from benchmark.trace import DeviceTrace, sync


class Stamp(threading.Event):
    """A request's completion event: stamps the host clock when the
    dispatcher sets it, and lets go of results that will not be checked."""

    def __init__(self, keep: bool):
        super().__init__()
        self.keep, self.t, self.pending, self.shape_ok = keep, None, None, None

    def set(self):
        self.t = time.perf_counter()
        p = self.pending
        if p is not None and p.result is not None:
            self.shape_ok = all(a.shape == (len(p.users), p.k) for a in p.result)
            if not self.keep:
                p.result = None
        super().set()


def schedule(traffic: dict, seconds: float):
    """(due times in s from the window's start, request sizes) of every
    request due inside ``seconds``: one fixed draw from the mix's
    ``structure_seed``, the same for every run seed."""
    base = np.random.default_rng(int(traffic["structure_seed"]))
    n = int(traffic["rate_per_s"] * seconds * 1.5) + 64
    due = np.cumsum(base.exponential(1.0 / traffic["rate_per_s"], n))
    lo, hi = traffic["min_users"], traffic["max_users"]
    sizes = np.floor(np.exp(base.uniform(np.log(lo), np.log(hi + 1), n))).astype(np.int64)
    keep = due < seconds
    return due[keep], np.clip(sizes, lo, hi)[keep]


def request_users(traffic: dict, ds, sizes: np.ndarray, seed: int):
    """Each request's users: one fixed draw (the mix's ``structure_seed``)
    of distinct users with train rows, in the numbering before the seed's
    relabelling, then renumbered as the seed renumbers the graph.  Every
    seed so asks for the same users' work (their filter lists have the
    same lengths), under other ids."""
    pu = data.permutations(ds, seed)[0]
    active = np.sort(np.argsort(pu)[np.unique(ds.train_user)])  # before relabelling
    rng = np.random.default_rng([int(traffic["structure_seed"]), 1])
    return [np.sort(pu[rng.choice(active, size=int(s), replace=False)]) for s in sizes]


def open_loop(disp, due, users, k: int, keep=None, grace_s: float = 60.0):
    """Submit each request at its due time (sleeping until then), wait for
    all, and return (latencies s with missing ones at the give-up time,
    lateness s, pendings, events, missing count, window s, users whose
    results were on the host before the window closed)."""
    pendings, events, late = [], [], []
    t_start = time.perf_counter()
    for i, (d, u) in enumerate(zip(due, users)):
        wait = t_start + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        ev = Stamp(keep is None or i in keep)
        p = program.Pending(u, k, True, done=ev)
        ev.pending = p
        disp.submit(p)
        late.append(p.t_submit - (t_start + d))
        pendings.append(p)
        events.append(ev)
    t_close = time.perf_counter()
    give_up = t_close + grace_s
    for ev in events:
        ev.wait(timeout=max(0.0, give_up - time.perf_counter()))
    end = time.perf_counter()
    lat, missing, served = [], 0, 0
    for d, p, ev in zip(due, pendings, events):
        ok = ev.is_set() and p.error is None and ev.shape_ok
        if not ok:
            missing += 1
        elif ev.t <= t_close:
            served += len(p.users)
        lat.append((ev.t if ok else end) - (t_start + d))
    return (np.asarray(lat), np.asarray(late), pendings, events, missing, t_close - t_start,
            served)


def p95(lat: np.ndarray) -> float:
    """Nearest-rank 95th percentile."""
    s = np.sort(lat)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


def setup(ctx: Run, dtype: str = None):
    """Data, tables, the port's retriever and a started dispatcher."""
    ds = common.dataset(ctx)
    tabs = common.tables(ctx, ds)
    config = program.make_config(ctx.cfg, dtype or common.compute_dtype(ctx))
    with ctx.spans.span("graph_build"):
        bundle = program.make_bundle(ds, ctx.cfg["graph"]["use_brand"])
        retriever = program.make_retriever(config, ds, bundle, tabs, ctx.device)
    del tabs
    common.free(ctx.device)
    disp = program.Dispatcher(retriever, max_coalesce=int(ctx.traffic["max_coalesce"]))
    disp.start()
    active = np.unique(ds.train_user)
    return ds, disp, active


def warm(ctx: Run, disp, active):
    """Every padded batch the traffic can make (``min_users`` up to
    ``max_coalesce * max_users`` users, powers of two), twice, through the
    dispatcher's own thread."""
    rng = data.seed_rng(ctx.seed, 31)
    top = ctx.traffic["max_coalesce"] * ctx.traffic["max_users"]
    sizes, s = [], 1
    while s < 2 * top:
        if s >= ctx.traffic["min_users"] // 2:
            sizes.append(min(s, top))
        s *= 2
    for _ in range(2):
        for s in sizes:
            u = rng.choice(active, size=min(s, len(active)), replace=len(active) < s)
            p = disp.submit(program.Pending(u.astype(np.int32), ctx.cfg["top_k"], True))
            p.done.wait(timeout=120)
            if p.error:
                raise RuntimeError(f"warm-up dispatch of {s} users failed: {p.error}")


def check(ctx: Run, ds, pendings, sample):
    """(rank gap, score gap) of the sampled requests against the reference."""
    ref.full_precision()
    adj = ref.adjacency(ds, ctx.device)
    rfu, rfi = ref.final_embeddings(adj, common.tables(ctx, ds), ctx.cfg["n_layers"])
    del adj
    ptr, items = ref.seen_csr(ds, ctx.device)
    k = ctx.cfg["top_k"]
    rank_gap = score_gap = 0.0
    for i in sample:
        p = pendings[i]
        if p.result is None:
            continue  # missing: counted in ``failed``
        scores, got = (torch.as_tensor(a, device=ctx.device) for a in p.result)
        u = torch.as_tensor(p.users, dtype=torch.int64, device=ctx.device)
        s = ref.masked_scores(rfu[u], rfi, u, ptr, items)
        best, _ = ref.topk_stable(s, k)
        got_ref = s.gather(1, got.long())
        scale = best[:, :1].abs().clamp_min(1e-30)
        distinct = bool((got.sort(1).values.diff(dim=1) != 0).all())
        r = float(((best - got_ref) / scale).max()) if distinct else math.inf
        g = float(((scores.float() - got_ref).abs() / scale).max())
        rank_gap = max(rank_gap, r if math.isfinite(r) else math.inf)
        score_gap = max(score_gap, g if math.isfinite(g) else math.inf)
    return rank_gap, score_gap


def run(ctx: Run) -> Outcome:
    tr_ = ctx.traffic
    ds, disp, active = setup(ctx)
    try:
        warm(ctx, disp, active)
        due, sizes = schedule(tr_, ctx.seconds)
        users = request_users(tr_, ds, sizes, ctx.seed)
        rng = data.seed_rng(ctx.seed, 33)
        sample = set(rng.choice(len(due), size=min(len(due), int(tr_["check_requests"])),
                                replace=False).tolist())
        sync(ctx.device)
        with disp.lock:
            before = dict(disp.stats)
        t_setup = time.perf_counter() - ctx.t0
        with DeviceTrace(ctx.trace, ctx.device) as tr:
            lat, late, pendings, _, missing, window_s, _ = open_loop(
                disp, due, users, ctx.cfg["top_k"], keep=sample, grace_s=float(tr_["grace_s"]))
        with disp.lock:
            after = dict(disp.stats)
    finally:
        disp.stop()
    peak = memory_peak(ctx.device)
    ctx.log(f"window: {len(due)} requests due in {window_s:.4f} s, {missing} missing; "
            f"offered {sum(sizes)} users; set-up {t_setup:.3f} s")
    ctx.log(f"generator lateness ms: p50 {np.median(late) * 1e3:.4f} "
            f"p95 {np.quantile(late, 0.95) * 1e3:.4f} max {late.max() * 1e3:.4f}")
    ctx.log("latency ms: " + " ".join(f"p{q} {np.quantile(lat, q / 100) * 1e3:.4f}"
                                      for q in (50, 90, 95, 99, 100)))
    del disp
    common.free(ctx.device)
    t = time.perf_counter()
    rank_gap, score_gap = check(ctx, ds, pendings, sorted(sample))
    ctx.log(f"reference {time.perf_counter() - t:.2f} s over {len(sample)} requests")
    checks = {"rank_gap": rank_gap, "score_gap": score_gap}
    return Outcome(
        e2e={"request_p95_ms": p95(lat) * 1e3, "setup_s": t_setup},
        obs={"graph_build_s": sum(ctx.spans.host["graph_build"]), "trace": tr.summary,
             "dispatches": after["dispatches"] - before["dispatches"],
             "coalesced_requests": after["coalesced_requests"] - before["coalesced_requests"]},
        checks={name: (v, common.limit(ctx, name)) for name, v in checks.items()},
        attempted=len(due), failed=missing, memory_peak_bytes=peak)
