"""BPR loss + L2 regularization (+ optional brand preference term).

PyTorch copy of ``gcn_recommendation_tpu/train/loss.py`` (reference
``bpr_loss_reg``, main.py:366-402):

* BPR: ``-mean(log(sigmoid(pos - neg) + 1e-8))`` on the final embeddings;
* optional brand BPR term, weight 0.1 by default, scoring users against
  the final brand embeddings of the positive and negative items' brands;
  pairs where either item carries the -1 "no brand" sentinel are masked
  out of the mean;
* L2: ``lambda * (||u0||^2 + ||i0+||^2 + ||i0-||^2) / B`` on the layer-0
  rows of the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8  # main.py:379


def bpr_loss_reg(
    final_user_emb: torch.Tensor,      # [B, d]
    final_pos_item_emb: torch.Tensor,  # [B, d]
    final_neg_item_emb: torch.Tensor,  # [B, d]
    initial_user_emb: torch.Tensor,    # [B, d] layer-0 rows
    initial_pos_item_emb: torch.Tensor,
    initial_neg_item_emb: torch.Tensor,
    lambda_reg: float,
    brand_loss: bool = False,
    final_brand_emb: Optional[torch.Tensor] = None,     # [num_brands, d]
    pos_item_brand_idx: Optional[torch.Tensor] = None,  # [B], -1 = no brand
    neg_item_brand_idx: Optional[torch.Tensor] = None,  # [B]
    brand_loss_weight: float = 0.1,
    brand_denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``brand_denom`` replaces the brand term's divisor (this batch's
    count of valid pairs): a data-parallel rank that holds a slice of the
    batch passes the whole batch's count over the data-axis size, so the
    mean of the ranks' losses is the whole batch's loss."""
    pos_scores = (final_user_emb * final_pos_item_emb).sum(dim=1)
    neg_scores = (final_user_emb * final_neg_item_emb).sum(dim=1)
    bpr = -torch.log(torch.sigmoid(pos_scores - neg_scores) + EPS).mean()

    loss = bpr
    if brand_loss and final_brand_emb is not None:
        valid = (pos_item_brand_idx >= 0) & (neg_item_brand_idx >= 0)
        pos_brand = final_brand_emb.index_select(0, pos_item_brand_idx.clamp_min(0).long())
        neg_brand = final_brand_emb.index_select(0, neg_item_brand_idx.clamp_min(0).long())
        brand_pos = (final_user_emb * pos_brand).sum(dim=1)
        brand_neg = (final_user_emb * neg_brand).sum(dim=1)
        per_pair = -torch.log(torch.sigmoid(brand_pos - brand_neg) + EPS)
        denom = valid.sum().clamp_min(1) if brand_denom is None else brand_denom
        brand_val = torch.where(valid, per_pair, torch.zeros_like(per_pair)).sum() / denom
        loss = loss + brand_loss_weight * brand_val

    batch = final_user_emb.shape[0]
    reg = (
        lambda_reg
        * (
            initial_user_emb.square().sum()
            + initial_pos_item_emb.square().sum()
            + initial_neg_item_emb.square().sum()
        )
        / float(batch)
    )
    return loss + reg
