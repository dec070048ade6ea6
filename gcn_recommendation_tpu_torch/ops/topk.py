"""Full-catalog scoring + seen-item masking + top-k.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/topk.py``.  Filter
lists are ``[B, F]`` int64 item ids padded with ``N`` (the catalog size),
which masking drops.  ``torch.topk`` does not promise the lower index
first on tied scores, as ``lax.top_k`` does; callers comparing with the
JAX package compare indices outside tie groups only.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e10  # main.py:424


def masked_topk(
    scores: torch.Tensor, filter_idx: torch.Tensor, k: int, *, strategy: str = "auto"
):
    """Top-k of ``scores`` [B, N] with each row's ``filter_idx`` entries
    set to MASK_VALUE.  Returns (values [B, k], indices [B, k] int64).

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
        masked = torch.cat([scores, scores.new_empty((b, 1))], dim=1)
        masked.scatter_(1, filter_idx, MASK_VALUE)
        return torch.topk(masked[:, :n], k, dim=1)
    if strategy == "compare":
        iota = torch.arange(n, dtype=filter_idx.dtype, device=filter_idx.device)
        seen = (filter_idx[:, :, None] == iota[None, None, :]).any(dim=1)
        return torch.topk(scores.masked_fill(seen, MASK_VALUE), k, dim=1)
    raise ValueError(f"unknown masking strategy {strategy!r}")


def masked_topk_scores(
    user_emb_batch: torch.Tensor,  # [B, d]
    item_emb: torch.Tensor,        # [I, d]
    filter_idx: torch.Tensor,      # [B, F] int64, padded with I
    k: int,
    *,
    strategy: str = "auto",
):
    """Score a user batch against the catalog, mask seen items, top-k."""
    scores = user_emb_batch.float() @ item_emb.float().T
    return masked_topk(scores, filter_idx, k, strategy=strategy)
