"""Plain float32 LightGCN: the benchmark's reference.

Written from the LightGCN paper (He et al., SIGIR 2020, arXiv:2002.02126)
and the reference repository's equations, with plain PyTorch only:

* the normalized adjacency ``D^-1/2 A D^-1/2`` over ``[users | items |
  brands]`` as a COO matrix (user-item edges and item-brand edges, both
  directions; duplicate pairs summed; isolated nodes scaled by 0), applied
  with ``torch.sparse.mm`` (reference ``main.py:321-331``,
  ``models/lightgcn.py:44-46``);
* the final embedding as the mean of the K+1 layer outputs;
* BPR ``-mean(log(sigmoid(pos - neg) + 1e-8))`` plus
  ``lambda * (|u0|^2 + |p0|^2 + |n0|^2) / B`` on the layer-0 rows
  (``main.py:366-402``);
* Adam (beta 0.9 / 0.999, eps 1e-8, no weight decay), written out;
* full-catalog scores, the user's train items masked, top-k with the
  lower item id first among tied scores, Recall@k and NDCG@k over one
  held-out item a user (``main.py:404-439``).

It imports nothing of the program under test, and it is given the
benchmark's arrays and tables: it builds its own adjacency from the
interactions.  The one exception is the training check after a measured
window, which goes on from the program's tables and Adam state at the
window's close (``train_steps(adam=...)``): the window's hundreds of
steps are more than the reference can follow in the time.  Everything
runs in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EPS = 1e-8


def full_precision() -> None:
    """float32 products in float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def adjacency(ds, device) -> torch.Tensor:
    """The normalized symmetric adjacency of ``ds`` (a ``benchmark.data.Dataset``)
    as a coalesced float32 COO matrix over ``[users | items | brands]``."""
    nu, ni, nb = ds.num_users, ds.num_items, ds.num_brands
    n = nu + ni + nb
    u = _t(ds.train_user, device)
    i = _t(ds.train_item, device) + nu
    bi = torch.arange(ni, device=device, dtype=torch.int64) + nu
    bb = _t(ds.item_brand, device) + nu + ni
    rows = torch.cat([u, i, bi, bb])
    cols = torch.cat([i, u, bb, bi])
    ones = torch.ones(rows.numel(), dtype=torch.float32, device=device)
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), ones, (n, n),
                                check_invariants=False).coalesce()
    r, c = a.indices()
    v = a.values()
    deg = torch.zeros(n, dtype=torch.float32, device=device).index_add_(0, r, v)
    dinv = deg.pow(-0.5)
    dinv[torch.isinf(dinv)] = 0.0
    return torch.sparse_coo_tensor(a.indices(), v * dinv[r] * dinv[c], (n, n),
                                   check_invariants=False).coalesce()


def propagate_mean(adj: torch.Tensor, ego: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Mean of ``ego, A ego, ..., A^K ego``."""
    acc, x = ego, ego
    for _ in range(n_layers):
        x = torch.sparse.mm(adj, x)
        acc = acc + x
    return acc / (n_layers + 1)


def final_embeddings(adj, tables: Dict[str, torch.Tensor], n_layers: int):
    """(final users, final items) of the tables."""
    nu, ni = tables["user_embedding"].shape[0], tables["item_embedding"].shape[0]
    ego = torch.cat([tables["user_embedding"], tables["item_embedding"],
                     tables["brand_embedding"]])
    final = propagate_mean(adj, ego, n_layers)
    return final[:nu], final[nu:nu + ni]


def bpr_l2_loss(adj, tables, users, pos, neg, n_layers: int, lam: float) -> torch.Tensor:
    fu_all, fi_all = final_embeddings(adj, tables, n_layers)
    fu, fp, fn = fu_all[users], fi_all[pos], fi_all[neg]
    bpr = -torch.log(torch.sigmoid((fu * fp).sum(1) - (fu * fn).sum(1)) + EPS).mean()
    u0, i0 = tables["user_embedding"], tables["item_embedding"]
    reg = lam * (u0[users].square().sum() + i0[pos].square().sum()
                 + i0[neg].square().sum()) / users.shape[0]
    return bpr + reg


def train_steps(adj, tables: Dict[str, torch.Tensor], batches: Sequence[Tuple], n_layers: int,
                lr: float, lam: float, betas=(0.9, 0.999), eps: float = 1e-8, adam=None):
    """Adam steps from ``tables`` (left unchanged) on ``batches`` of
    (users, pos, neg).  ``adam``, if given, is Adam's state to go on from:
    (first moments, second moments, steps taken); else Adam starts fresh.
    Returns (losses, first gradient by table, tables after the last step)."""
    b1, b2 = betas
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tables.items()}
    if adam is None:
        m = {k: torch.zeros_like(v) for k, v in tables.items()}
        v2 = {k: torch.zeros_like(v) for k, v in tables.items()}
        taken = 0
    else:
        m0, v0, taken = adam
        m = {k: m0[k].detach().clone() for k in tables}
        v2 = {k: v0[k].detach().clone() for k in tables}
    losses: List[float] = []
    first_grad = None
    for t, (users, pos, neg) in enumerate(batches, start=taken + 1):
        loss = bpr_l2_loss(adj, params, users, pos, neg, n_layers, lam)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        del grads
    return losses, first_grad, {k: p.detach() for k, p in params.items()}


def seen_csr(ds, device):
    """(ptr [U+1], items) of each user's train items, by user id."""
    order = np.argsort(ds.train_user, kind="stable")
    items = _t(ds.train_item[order], device)
    counts = np.bincount(ds.train_user, minlength=ds.num_users)
    ptr = np.zeros(ds.num_users + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return torch.as_tensor(ptr, device=device), items


def masked_scores(fu_rows, fi, users, ptr, items):
    """Scores of ``users`` (rows ``fu_rows``) against every item, each
    user's train items at ``-inf``."""
    scores = fu_rows @ fi.T
    starts, ends = ptr[users], ptr[users + 1]
    lens = ends - starts
    row = torch.repeat_interleave(torch.arange(users.numel(), device=users.device), lens)
    offs = torch.arange(int(lens.sum()), device=users.device) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    col = items[torch.repeat_interleave(starts, lens) + offs]
    scores[row, col] = -math.inf
    return scores


def topk_stable(scores: torch.Tensor, k: int):
    """Top-k in descending order, the lower index first among ties."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def recall_ndcg(ds, fu, fi, k: int, tie: float = 0.0, block: int = 4096) -> Dict[str, float]:
    """Recall@k and NDCG@k over the validation users (one held-out item
    each), train items masked.

    The held-out item's rank is the number of unmasked items that score
    above it.  Scores within ``tie`` times the user's best score of the
    held-out item's are near-ties, whose order another float32 sum order
    may turn: the bounds ``*_lo`` / ``*_hi`` take each user's rank at the
    far end (every near-tie ahead of it) and at the near end (every one
    behind it).  With ``tie`` 0 the bounds are the values, up to exact
    ties, which the stable order breaks to the lower item id."""
    device = fu.device
    ptr, items = seen_csr(ds, device)
    users_all = _t(ds.val_user, device)
    true_all = _t(ds.val_item, device)
    sums = torch.zeros(6, dtype=torch.float64, device=device)

    def gains(rank):
        hit = rank < k
        return hit.double(), torch.where(hit, 1.0 / torch.log2(rank.double() + 2.0),
                                         torch.zeros_like(rank, dtype=torch.float64))

    for s in range(0, users_all.numel(), block):
        users, true = users_all[s:s + block], true_all[s:s + block]
        scores = masked_scores(fu[users], fi, users, ptr, items)
        _, top = topk_stable(scores, k)
        match = top == true[:, None]
        hit = match.any(1)
        pos = match.int().argmax(1).double()
        s_true = scores.gather(1, true[:, None])
        eps = tie * scores.max(1, keepdim=True).values.abs()
        near_lo = (scores > s_true + eps).sum(1)        # rank with near-ties behind
        near_hi = (scores >= s_true - eps).sum(1) - 1   # rank with near-ties ahead
        r_hi_rank, n_hi_rank = gains(near_lo)
        r_lo_rank, n_lo_rank = gains(near_hi)
        sums += torch.stack([
            hit.double().sum(),
            torch.where(hit, 1.0 / torch.log2(pos + 2.0), torch.zeros_like(pos)).sum(),
            r_lo_rank.sum(), r_hi_rank.sum(), n_lo_rank.sum(), n_hi_rank.sum()])
    n = users_all.numel()
    recall, ndcg, r_lo, r_hi, n_lo, n_hi = (float(x) / n for x in sums)
    return {"recall": recall, "ndcg": ndcg, "recall_lo": r_lo, "recall_hi": r_hi,
            "ndcg_lo": n_lo, "ndcg_hi": n_hi, "users": n}
