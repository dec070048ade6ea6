"""Full-catalog scoring + seen-item masking + top-k.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/topk.py``.  Filter
lists are ``[B, F]`` int64 item ids padded with ``N`` (the catalog size),
which masking drops.

Tie order.  ``lax.top_k`` puts the lower index first among tied scores;
``torch.topk`` promises no order.  Hit and NDCG depend on it, so
evaluation (``topk_eval_batch``) selects with ``stable=True``: a stable
descending sort, which keeps tied scores in index order.  Serving keeps
``torch.topk``; callers comparing its indices with the JAX package
compare them outside tie groups only.

Spans (``utils/profiling.py``): ``topk.mask`` around the masking,
``topk.select`` around the selection, ``eval.metrics`` around an
evaluation batch's hit/NDCG.
"""

from __future__ import annotations

import torch

from gcn_recommendation_tpu_torch.utils.profiling import span

MASK_VALUE = -1e10  # main.py:424

# The JAX package's crossover between comparison and scatter masking
# (ops/topk.py there, measured on a TPU).  The port only uses it to group
# evaluation users into filter-width tiers, which changes no metric.
COMPARE_MAX_WORK = 64 * 20_000
COMPARE_MAX_F_CAP = 512


def compare_max_f(num_items: int) -> int:
    """Filter width of the first evaluation tier at this catalog size."""
    return max(1, min(COMPARE_MAX_F_CAP, COMPARE_MAX_WORK // max(num_items, 1)))


def _topk(x: torch.Tensor, k: int, stable: bool):
    with span("topk.select"):
        if not stable:
            return torch.topk(x, k, dim=1)
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]


def masked_topk(
    scores: torch.Tensor,
    filter_idx: torch.Tensor,
    k: int,
    *,
    strategy: str = "auto",
    stable: bool = False,
):
    """Top-k of ``scores`` [B, N] with each row's ``filter_idx`` entries
    set to MASK_VALUE.  Returns (values [B, k], indices [B, k] int64);
    ``stable`` puts the lower index first among tied scores.

    * ``scatter`` — one ``scatter_`` into a ``[B, N+1]`` copy, so pad
      index N lands in a spare column (``scatter_`` cannot drop it).
    * ``compare`` — ``seen = any_f(filter[b, f] == i)``; materializes a
      ``[B, F, N]`` bool tensor in eager PyTorch (8.7 GB at B=1024,
      F=425, N=20,000).

    ``auto`` picks ``scatter``: the JAX package's crossover to ``compare``
    was measured on a TPU, and eager PyTorch pays the compare mask's
    memory in full.
    """
    b, n = scores.shape
    if strategy == "auto":
        strategy = "scatter"
    if strategy == "scatter":
        with span("topk.mask"):
            masked = torch.cat([scores, scores.new_empty((b, 1))], dim=1)
            masked.scatter_(1, filter_idx, MASK_VALUE)
        return _topk(masked[:, :n], k, stable)
    if strategy == "compare":
        with span("topk.mask"):
            iota = torch.arange(n, dtype=filter_idx.dtype, device=filter_idx.device)
            seen = (filter_idx[:, :, None] == iota[None, None, :]).any(dim=1)
            masked = scores.masked_fill(seen, MASK_VALUE)
        return _topk(masked, k, stable)
    raise ValueError(f"unknown masking strategy {strategy!r}")


def masked_topk_scores(
    user_emb_batch: torch.Tensor,  # [B, d]
    item_emb: torch.Tensor,        # [I, d]
    filter_idx: torch.Tensor,      # [B, F] int64, padded with I
    k: int,
    *,
    strategy: str = "auto",
    stable: bool = False,
):
    """Score a user batch against the catalog, mask seen items, top-k."""
    scores = user_emb_batch.float() @ item_emb.float().T
    return masked_topk(scores, filter_idx, k, strategy=strategy, stable=stable)


def topk_hit_metrics(topk_idx: torch.Tensor, true_items: torch.Tensor, valid: torch.Tensor):
    """(recall_sum, ndcg_sum, count) of a top-k index batch against the
    leave-one-out held-out items (main.py:430-438: recall = hit
    indicator, ndcg = 1/log2(pos+2) on a hit), over the ``valid`` rows."""
    hit_matrix = topk_idx == true_items[:, None]
    hit = hit_matrix.any(dim=1)
    pos = hit_matrix.int().argmax(dim=1)
    ndcg = torch.where(
        hit, 1.0 / torch.log2(pos.float() + 2.0), torch.zeros_like(pos, dtype=torch.float32)
    )
    validf = valid.float()
    return (hit.float() * validf).sum(), (ndcg * validf).sum(), validf.sum()


def merge_topk_candidates(all_vals: torch.Tensor, all_idx: torch.Tensor, k: int):
    """Re-select the global top-k from per-shard candidates.

    ``all_vals`` / ``all_idx`` are ``[m, B, k]`` stacks (one slice per item
    shard, global indices); returns ([B, k] values, [B, k] indices).  The
    candidates are flattened shard-major and selected with a stable sort,
    so tied scores resolve in ``lax.top_k``'s order (earlier shard, then
    earlier slot, first)."""
    m, b, kk = all_vals.shape
    cand_vals = all_vals.permute(1, 0, 2).reshape(b, m * kk)
    cand_idx = all_idx.permute(1, 0, 2).reshape(b, m * kk)
    best_vals, pos = _topk(cand_vals, k, stable=True)
    return best_vals, cand_idx.gather(1, pos)


def topk_eval_batch(user_emb, item_emb, users, true_items, filter_idx, valid, k: int):
    """One evaluation batch: masked top-k of the batch users' scores in
    ``lax.top_k``'s tie order, then its (recall_sum, ndcg_sum, count)."""
    u = user_emb.index_select(0, users)
    _, topk_idx = masked_topk_scores(u, item_emb, filter_idx, k, stable=True)
    with span("eval.metrics"):
        return topk_hit_metrics(topk_idx, true_items, valid)
