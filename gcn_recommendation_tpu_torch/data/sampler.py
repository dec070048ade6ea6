"""Per-user item lists, BPR negative sampling and epoch batching.

Counterpart of ``gcn_recommendation_tpu/data/sampler.py``:

* ``membership_arrays`` / ``padded_filter_rows`` — numpy copies (host).
* ``sample_negatives`` — one uniform non-positive item per example,
  on the device: ``n_rounds`` candidates drawn up front, each tested
  for membership in the user's train positives, the first clean draw
  kept (the last draw when all collide, a p**n_rounds residual as in the
  JAX package).  The membership test is ``torch.searchsorted`` over the
  sorted keys ``user * num_items + item`` (``positive_keys``): the same
  function as the JAX package's per-user binary search, in one call.
* ``epoch_batches`` — a shuffled ``[steps, batch]`` index matrix whose
  last batch wraps to the head of the permutation.

Draws come from an explicit ``torch.Generator`` on the tensors' device;
its numbers differ from ``jax.random``'s, so tests compare distributions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def positive_keys(user_ptr: np.ndarray, flat_items: np.ndarray, num_items: int) -> np.ndarray:
    """Sorted int64 keys ``user * num_items + item`` of the positives held
    by ``membership_arrays`` (its per-user lists are sorted, so the keys
    are sorted globally)."""
    users = np.repeat(np.arange(len(user_ptr) - 1, dtype=np.int64), np.diff(user_ptr))
    return users * num_items + flat_items.astype(np.int64)


def sample_negatives(
    generator: torch.Generator,
    users: torch.Tensor,
    pos_keys: torch.Tensor,
    *,
    num_items: int,
    n_rounds: int = 6,
) -> torch.Tensor:
    """One uniform non-positive item per entry of ``users`` (any shape),
    int64, on ``users``' device."""
    cands = torch.randint(
        0, num_items, tuple(users.shape) + (n_rounds,),
        generator=generator, device=users.device,
    )
    if pos_keys.numel() == 0:
        return cands[..., 0]
    q = users.long()[..., None] * num_items + cands
    at = torch.searchsorted(pos_keys, q).clamp_max(pos_keys.numel() - 1)
    ok = pos_keys[at] != q
    first = ok.int().argmax(dim=-1)  # first clean draw
    pick = torch.where(ok.any(dim=-1), first, torch.full_like(first, n_rounds - 1))
    return cands.gather(-1, pick[..., None])[..., 0]


def epoch_batches(
    generator: torch.Generator, n: int, batch_size: int, device=None
) -> torch.Tensor:
    """``[steps, batch]`` int64 indices covering a shuffled epoch; the last
    batch wraps to the permutation head so every batch is full."""
    steps = max(1, -(-n // batch_size))
    perm = torch.randperm(n, generator=generator, device=device)
    total = steps * batch_size
    if total != n:
        perm = perm.repeat(-(-total // n))[:total]
    return perm.view(steps, batch_size)
