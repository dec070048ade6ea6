"""Leave-one-out full-catalog evaluation.

PyTorch counterpart of ``gcn_recommendation_tpu/train/evaluate.py``
(reference evaluate(), main.py:404-439): one held-out item per user (the
last occurrence wins), one propagation per evaluation, and per user
batch dense scores, seen-item masking, top-k (in ``lax.top_k``'s tie
order) and the held-out items' positions.  The metric is a mean over
users, so the filter-width tiers only group users into batches of
similar padding.  Each batch gives an exact histogram of positions
(``ops/topk.py::hit_histogram``); a pass sums them on the device and
brings the k + 1 counts to the host once (the ``eval.metrics`` span, as
each batch's histogram in ``ops/topk.py``), where Recall@k and NDCG@k
are formed in float64.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.data.loader import Interactions
from gcn_recommendation_tpu_torch.data.sampler import membership_arrays, padded_filter_rows
from gcn_recommendation_tpu_torch.ops.topk import compare_max_f, topk_eval_batch
from gcn_recommendation_tpu_torch.utils.profiling import span


def dedup_eval_users(eval_inter: Interactions) -> Tuple[np.ndarray, np.ndarray]:
    """(users, true_items) with the last occurrence winning, like
    ``dict(zip(users, items))`` at main.py:406."""
    users = eval_inter.user_idx
    items = eval_inter.item_idx
    _, last_pos_rev = np.unique(users[::-1], return_index=True)
    pos = len(users) - 1 - last_pos_rev
    pos.sort()
    return users[pos], items[pos]


def build_eval_batches(
    eval_inter: Interactions,
    filter_inter: Interactions,
    num_users: int,
    num_items: int,
    batch_size: int = 1024,
    device: DeviceLike = None,
) -> List[Tuple[torch.Tensor, ...]]:
    """Device-resident eval batches, built once per run: a list of
    (users [B], true [B], filt [B, F] int64, valid [B] bool).  Users are
    grouped into tiers by seen-list length (the JAX package's ladder:
    the compare-width tier, then x4 widths), so a heavy user does not
    widen everyone's filter rows; tiers under one batch coalesce upward."""
    dev = resolve_device(device)
    users, true_items = dedup_eval_users(eval_inter)
    if len(users) == 0:
        return []
    f_ptr, f_items = membership_arrays(filter_inter.user_idx, filter_inter.item_idx, num_users)
    deg = f_ptr[1:] - f_ptr[:-1]

    c0 = compare_max_f(num_items)
    deg_u = deg[users]
    max_deg_u = int(deg_u.max())
    caps = [c0]
    w = 32
    while w <= c0:
        w *= 4
    while w < max_deg_u:
        caps.append(w)
        w *= 4
    if caps[-1] < max_deg_u:
        caps.append(max_deg_u)

    tier_of = np.searchsorted(np.asarray(caps, dtype=np.int64), deg_u)
    counts = np.bincount(tier_of, minlength=len(caps))
    for i in range(len(caps) - 1):
        if 0 < counts[i] < batch_size:
            tier_of[tier_of == i] = i + 1
            counts[i + 1] += counts[i]
            counts[i] = 0

    batches = []
    for i in range(len(caps)):
        if not counts[i]:
            continue
        t_users, t_items = users[tier_of == i], true_items[tier_of == i]
        fmax = max(1, int(deg[t_users].max()))
        filt = padded_filter_rows(f_ptr, f_items, t_users, fmax, num_items)
        for s in range(0, len(t_users), batch_size):
            n = min(batch_size, len(t_users) - s)
            pad = batch_size - n
            bu = np.concatenate([t_users[s : s + n], np.zeros(pad, np.int32)])
            bt = np.concatenate([t_items[s : s + n], np.zeros(pad, np.int32)])
            bf = np.full((batch_size, fmax), num_items, dtype=np.int64)
            bf[:n] = filt[s : s + n]
            valid = np.arange(batch_size) < n
            batches.append(tuple(
                torch.from_numpy(a).to(dev)
                for a in (bu.astype(np.int64), bt.astype(np.int64), bf, valid)
            ))
    return batches


def evaluate_batches(fu, fi, batches, k: int) -> Tuple[float, float]:
    """Recall@k / NDCG@k over prebuilt batches, from the batches' summed
    ``hit_histogram``: ``hist[p]`` hits at position p < k over ``hist[k]``
    users."""
    if not batches:
        return 0.0, 0.0
    hists = [topk_eval_batch(fu, fi, users, true_items, filt, valid, k)
             for users, true_items, filt, valid in batches]
    with span("eval.metrics"):
        hist = torch.stack(hists).sum(dim=0).tolist()
    n = hist[k]
    if n == 0:
        return 0.0, 0.0
    return (sum(hist[:k]) / n,
            sum(h / math.log2(p + 2) for p, h in enumerate(hist[:k])) / n)


def evaluate_embeddings(
    fu,
    fi,
    eval_inter: Interactions,
    filter_inter: Interactions,
    num_users: int,
    num_items: int,
    k: int,
    batch_size: int = 1024,
) -> Tuple[float, float]:
    """Recall@k / NDCG@k from precomputed final embeddings."""
    batches = build_eval_batches(
        eval_inter, filter_inter, num_users, num_items, batch_size, device=fu.device
    )
    return evaluate_batches(fu, fi, batches, k)


@torch.no_grad()
def evaluate(
    model,
    device_graph,
    eval_inter: Interactions,
    filter_inter: Interactions,
    num_users: int,
    num_items: int,
    k: int,
    batch_size: int = 1024,
) -> Tuple[float, float]:
    """Recall@k / NDCG@k of ``model``'s current tables over the eval
    interactions.  ``filter_inter`` is the seen set to mask: train for
    validation, train + val for test (main.py:576)."""
    fu, fi, *_ = model(device_graph)
    return evaluate_embeddings(
        fu, fi, eval_inter, filter_inter, num_users, num_items, k, batch_size
    )
