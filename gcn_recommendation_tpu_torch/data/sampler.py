"""Per-user item lists for seen-item filtering (host side, numpy).

The two numpy helpers of ``gcn_recommendation_tpu/data/sampler.py`` that
serving needs.  The negative sampler belongs to the training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def membership_arrays(
    user_idx: np.ndarray, item_idx: np.ndarray, num_users: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (user_ptr, flat_items): per-user sorted positive item lists."""
    order = np.lexsort((item_idx, user_idx))
    u_sorted = np.asarray(user_idx)[order]
    flat_items = np.asarray(item_idx)[order].astype(np.int32)
    counts = np.bincount(u_sorted, minlength=num_users)
    user_ptr = np.zeros(num_users + 1, dtype=np.int32)
    np.cumsum(counts, out=user_ptr[1:])
    return user_ptr, flat_items


def padded_filter_rows(
    f_ptr: np.ndarray,
    f_items: np.ndarray,
    users: np.ndarray,
    width: int,
    pad_value: int,
) -> np.ndarray:
    """``[len(users), width]`` padded per-user item lists; unused slots
    hold ``pad_value`` (``num_items``, which masking drops)."""
    lens = (f_ptr[1:] - f_ptr[:-1])[users]
    filt = np.full((len(users), width), pad_value, dtype=np.int32)
    total = int(lens.sum())
    if total:
        rows = np.repeat(np.arange(len(users)), lens)
        offs = np.cumsum(lens) - lens
        cols = np.arange(total) - np.repeat(offs, lens)
        flat = np.repeat(f_ptr[users], lens) + cols
        filt[rows, cols] = f_items[flat]
    return filt
