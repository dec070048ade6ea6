"""Experiment: the single-card training step taken apart.

Counterpart of the JAX package's ``tools/exp_step_profile.py``, on its
bench graph (50k users / 20k items / 2k brands, degree 28, core 8; dim 64,
3 layers, batch 2048) and with its rows and labels:

* the ablation ladder: the full step (per-layer and fused merge-skip) ->
  fixed negatives (sampler removed) -> SGD in place of Adam -> a dot loss
  (the batch rows' gathers and scatters removed) -> forward and backward
  of the propagation only -> forward only;
* micro rows: one propagation with and without the hub rows, the bucket
  gathers alone, the hub product alone, the restore gather alone;
* the sampler pair: the port's production sampler (all 6 rounds drawn at
  once, one ``torch.searchsorted``: ``data/sampler.py``) against a
  sequential-redraw variant written here (a draw, then 5 rounds that
  redraw the colliding entries), alone and inside the fused step;
* the batch-row gathers; then the JAX tool's attribution block.

Every row gives three times a step over a chain of ``--chain`` steps:
``wall`` (host clock, ending in ``torch.cuda.synchronize()``), ``events``
(CUDA events around the same chain, which hold the device's idle gaps when
the host cannot keep up) and ``busy`` (the device's kernel time in one
``torch.profiler`` window of the chain).  A step here is eager PyTorch:
the host dispatches every launch, so ``wall - busy`` is what the host
costs.  On ``--device cpu`` only ``wall`` is taken, labelled ``cpu``.

Each row starts from the same tables (seed 0), a fresh Adam and the
sampler's generator at seed 7.

    python -m gcn_recommendation_tpu_torch.tools.exp_step_profile [--chain 40]
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
LAYERS = 3
BATCH = 2048
CHAIN = 40


def sample_sequential(generator, users, pos_keys, num_items: int, n_rounds: int = 6):
    """One non-positive item per user by sequential redraw: a first draw,
    then ``n_rounds - 1`` rounds that test every entry against the sorted
    positive keys and redraw the colliding ones (the last draw kept when
    every round collided: the same distribution as ``sample_negatives``)."""
    neg = torch.randint(0, num_items, users.shape, generator=generator, device=users.device)
    last = pos_keys.numel() - 1
    for _ in range(n_rounds - 1):
        q = users * num_items + neg
        hit = pos_keys[torch.searchsorted(pos_keys, q).clamp_max(last)] == q
        redraw = torch.randint(0, num_items, users.shape, generator=generator,
                               device=users.device)
        neg = torch.where(hit, redraw, neg)
    return neg


def _device_busy_ms(fn, steps: int):
    """Kernel time on the card a step, from one ``torch.profiler`` window
    of ``fn()`` (which runs ``steps`` steps); None when the profiler
    delivered no device event for the window (not measured, not 0)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy_us / 1e3 / steps if busy_us > 0 else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=NUM_USERS)
    ap.add_argument("--num_items", type=int, default=NUM_ITEMS)
    ap.add_argument("--num_brands", type=int, default=NUM_BRANDS)
    ap.add_argument("--chain", type=int, default=CHAIN, help="Steps in a timed chain.")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.sampler import (
        membership_arrays,
        positive_keys,
        sample_negatives,
    )
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.ops.spmm import (
        _bucket_reduce,
        propagate,
        to_device_graph,
    )
    from gcn_recommendation_tpu_torch.train.loss import bpr_loss_reg
    from gcn_recommendation_tpu_torch.utils.timing import cuda_windows, device_line, host_ms

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    chain = args.chain
    print(device_line(dev), flush=True)
    bundle = synthetic_bundle(num_users=args.num_users, num_items=args.num_items,
                              num_brands=args.num_brands, mean_degree=MEAN_DEGREE, core=8,
                              seed=42)
    g = bundle.graph
    dg = to_device_graph(g, fuse_layers=False, device=dev)       # per-layer baseline
    dg_fused = to_device_graph(g, fuse_layers=True, device=dev)  # merge-skip views
    cfg = Config(embedding_dim=DIM, n_layers=LAYERS, batch_size=BATCH)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    params0 = {k: v.clone() for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    user_ptr, flat_items = membership_arrays(bundle.train.user_idx, bundle.train.item_idx,
                                             bundle.num_users)
    pos_keys = torch.from_numpy(positive_keys(user_ptr, flat_items, bundle.num_items)).to(dev)
    train_users = torch.from_numpy(bundle.train.user_idx.astype(np.int64)).to(dev)
    train_items = torch.from_numpy(bundle.train.item_idx.astype(np.int64)).to(dev)
    n_train = len(bundle.train)
    num_items = bundle.num_items

    padded_rows = sum(b.nbr_idx.size for b in g.buckets)
    graph_line = (f"graph: nodes={g.num_nodes} nnz={g.nnz} buckets={len(g.buckets)} "
                  f"padded_rows={padded_rows} hubs={len(g.dense_node_ids)}")
    print(f"{graph_line} sampler=searchsorted", flush=True)

    rng = np.random.default_rng(0)
    batch_idx = torch.from_numpy(rng.integers(0, n_train, (chain, BATCH))).to(dev)
    neg0 = torch.from_numpy(np.random.default_rng(1).integers(0, num_items, BATCH)).to(dev)
    gen = torch.Generator(device=dev)
    state = {}

    def reset():
        """Tables back to seed 0, a fresh Adam, the sampler reseeded."""
        model.load_params(params0)
        state["opt"] = torch.optim.Adam(
            [getattr(model, k) for k in model.trainable_keys], lr=cfg.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
        gen.manual_seed(7)
        state["step"] = 0
        state["losses"] = []

    def batch(s):
        bidx = batch_idx[s % chain]
        return train_users[bidx], train_items[bidx]

    def batch_loss(graph, users, pos, neg):
        fu_all, fi_all, _, u0_all, i0_all = model(graph)
        return bpr_loss_reg(fu_all[users], fi_all[pos], fi_all[neg], u0_all[users],
                            i0_all[pos], i0_all[neg], cfg.weight_decay)

    def adam_step(loss_fn):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        state["losses"].append(loss.detach())

    def full_step(graph, sampler):
        def step():
            users, pos = batch(state["step"])
            state["step"] += 1
            neg = sampler(gen, users, pos_keys, num_items=num_items)
            adam_step(lambda: batch_loss(graph, users, pos, neg))
        return step

    def step_fixed_neg():
        users, pos = batch(state["step"])
        state["step"] += 1
        adam_step(lambda: batch_loss(dg, users, pos, neg0))

    def step_sgd():
        users, pos = batch(state["step"])
        state["step"] += 1
        tables = [getattr(model, k) for k in model.trainable_keys]
        grads = torch.autograd.grad(batch_loss(dg, users, pos, neg0), tables)
        with torch.no_grad():
            for p, gr in zip(tables, grads):
                p.sub_(1e-3 * gr)

    def dot_loss():
        fu_all, fi_all, fb_all, _, _ = model(dg)
        return fu_all.mean() + fi_all.mean() + fb_all.mean()

    def step_dotloss():
        adam_step(dot_loss)

    def prop(x):
        return propagate(x, dg)

    def layer_mean(e):
        acc, x = e, e
        for _ in range(LAYERS):
            x = prop(x)
            acc = acc + x
        return acc / (LAYERS + 1)

    ego = {}

    def chained(update):
        def step():
            ego["x"] = update(ego["x"])
        return step

    @torch.no_grad()
    def fwd(e):
        return layer_mean(e)

    def fwdbwd(e):
        e = e.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad((layer_mean(e) ** 2).sum(), e)
        return (e - 1e-6 * grad).detach()

    @torch.no_grad()
    def prop1_nohub(x):
        parts = [_bucket_reduce(x, idx, w).to(x.dtype)
                 for idx, w in zip(dg.bucket_nbr_idx, dg.bucket_nbr_w)]
        parts.append(x.new_zeros((dg.dense_mat.shape[0] + 1, x.shape[1])))
        return torch.cat(parts).index_select(0, dg.gather_idx)

    @torch.no_grad()
    def buckets_only(x):
        s = x.new_zeros(())
        for idx, w in zip(dg.bucket_nbr_idx, dg.bucket_nbr_w):
            s = s + _bucket_reduce(x, idx, w).sum()
        return x * (1.0 + 0.0 * s)

    @torch.no_grad()
    def hub_only(x):
        h = torch.matmul(dg.dense_mat, x)
        return x * (1.0 + 0.0 * h.sum())

    nrows = sum(b.nbr_idx.shape[0] for b in g.buckets) + dg.dense_mat.shape[0] + 1
    parts_tbl = torch.from_numpy(rng.standard_normal((nrows, DIM)).astype(np.float32)).to(dev)
    users0 = batch(0)[0]

    def merge_only():
        ego["m"] = parts_tbl.index_select(0, dg.gather_idx)

    def sampler_row(sampler):
        def step():
            ego["neg"] = sampler(gen, users0, pos_keys, num_items=num_items)
        return step

    def batchgather():
        users, pos = batch(state["step"])
        state["step"] += 1
        ego["s"] = users.sum() + pos.sum()

    results = {}

    def timed(name, step, prop_input=False):
        """Time windows of ``chain`` calls of ``step``; the row starts from
        the seed-0 tables, and its first window (the warm-up) gives the
        first step's loss."""
        def run():
            for _ in range(chain):
                step()

        reset()
        if prop_input:
            ego["x"] = torch.cat([params0["user_embedding"], params0["item_embedding"],
                                  params0["brand_embedding"]]).to(dev)
        run()  # warm-up: allocator, lazy initialisation
        first = state["losses"][0] if state["losses"] else None
        row = {"wall": host_ms(run, reps=2, warmup=0, device=dev) / chain}
        if on_card:
            row["events"] = float(np.median(cuda_windows(run, reps=1, windows=2, warmup=0))) / chain
            row["busy"] = _device_busy_ms(run, chain)
            busy = "     n/a" if row["busy"] is None else f"{row['busy']:8.3f}"
            print(f"{name:34s} {row['wall']:8.3f} ms/step wall  {row['events']:8.3f} events  "
                  f"{busy} busy", flush=True)
        else:
            print(f"{name:34s} {row['wall']:8.3f} ms/step wall (cpu)", flush=True)
        if first is not None:
            row["first_loss"] = float(first)
        results[name] = row
        return row

    # ---------------- step-level ablation ladder ----------------
    timed("full_step (per-layer)", full_step(dg, sample_negatives))
    timed("full_step (fused merge-skip)", full_step(dg_fused, sample_negatives))
    timed("step fixed-neg", step_fixed_neg)
    timed("step fixed-neg+sgd", step_sgd)
    timed("step dot-loss (no batch rows)", step_dotloss)
    # ---------------- propagation-only chains ----------------
    timed("fwd 3-layer", chained(fwd), prop_input=True)
    timed("fwd+bwd 3-layer", chained(fwdbwd), prop_input=True)
    timed("prop x1 (full)", chained(torch.no_grad()(prop)), prop_input=True)
    timed("prop x1 no-hub", chained(prop1_nohub), prop_input=True)
    timed("prop x1 buckets-only", chained(buckets_only), prop_input=True)
    timed("hub matmul only", chained(hub_only), prop_input=True)
    timed("merge/restore gather only", merge_only)
    # ---------------- sampler variants ----------------
    timed("sampler batched one-pass (prod)", sampler_row(sample_negatives))
    timed("sampler seq rounds=6", sampler_row(sample_sequential))
    timed("full_step fused + seq-samp", full_step(dg_fused, sample_sequential))
    timed("batch idx gathers", batchgather)

    # ---------------- derived attribution ----------------
    cols = ("wall", "busy") if on_card else ("wall",)
    print(f"\n--- attribution (ms/step; {', '.join(cols)}) ---", flush=True)

    def derived(col, fn, *names):
        """``fn`` of the rows' ``col`` times; None where one is not measured."""
        vals = [results[n][col] for n in names]
        return None if None in vals else fn(*vals)

    full, noneg, sgd, dot, fb = ("full_step (per-layer)", "step fixed-neg", "step fixed-neg+sgd",
                                 "step dot-loss (no batch rows)", "fwd+bwd 3-layer")
    attribution = {}
    for col in cols:
        attribution[col] = {
            "sampler (ladder)": derived(col, lambda a, b: a - b, full, noneg),
            "adam - sgd (ladder)": derived(col, lambda a, b: a - b, noneg, sgd),
            "batch rows (ladder)": derived(col, lambda a, c: a - c, noneg, dot),
            "propagation fwd+bwd": derived(col, lambda a: a, fb),
            "residual (dot - fwdbwd)": derived(col, lambda a, b: a - b, dot, fb),
            "sampler isolated": derived(col, lambda a: a, "sampler batched one-pass (prod)"),
            "sampler sequential": derived(col, lambda a: a, "sampler seq rounds=6"),
            "full step fused": derived(col, lambda a: a, "full_step (fused merge-skip)"),
            "full step fused+seqsamp": derived(col, lambda a: a, "full_step fused + seq-samp"),
        }
    notes = {"batch rows (ladder)": "   [vs dot-loss, adam kept]",
             "residual (dot - fwdbwd)": "   [adam + layer-mean bwd + init concat]"}
    for label in attribution["wall"]:
        vals = "  ".join("     n/a" if attribution[c][label] is None
                         else f"{attribution[c][label]:8.3f}" for c in cols)
        print(f"{label:24s}{vals}{notes.get(label, '')}", flush=True)

    b_users, b_pos = batch(0)
    reset()
    return {"device": str(dev), "graph_line": graph_line, "rows": results,
            "attribution": attribution, "params0": params0,
            "first_batch": (b_users.cpu().numpy(), b_pos.cpu().numpy(),
                            sample_negatives(gen, b_users, pos_keys,
                                             num_items=num_items).cpu().numpy())}


if __name__ == "__main__":
    main()
