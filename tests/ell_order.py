"""The order in which ``csrc/ell_spmm.cu`` sums an ELL bucket, in plain
PyTorch, for the tests: on a card the kernel must equal it bit for bit.

Each row is summed slot by slot in column order, in float32, from -0 (so
the first term enters exactly); a term is the product of the widened
operands rounded to float32, and rounded once more to bfloat16 when both
operands are bfloat16 (as the plain version's bfloat16 multiply rounds).
A row at least ``SPLIT_MIN_WIDTH`` wide is summed in ``GROUPS_PER_BLOCK``
contiguous slices of ``ceil(width / GROUPS_PER_BLOCK)`` slots, whose sums
are then added in slice order.
"""

import torch

from gcn_recommendation_tpu_torch.ops.spmm import GROUPS_PER_BLOCK, SPLIT_MIN_WIDTH


def kernel_order(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One bucket's ``sum_j w[:, j] * x[idx[:, j]]`` as ``[rows, d]`` float32,
    summed as the kernel sums it."""
    rows, width = idx.shape
    rounds = x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16

    def slice_sum(lo: int, hi: int) -> torch.Tensor:
        acc = torch.full((rows, x.shape[1]), -0.0, dtype=torch.float32, device=x.device)
        for j in range(lo, hi):
            t = x.index_select(0, idx[:, j]).float() * w[:, j, None].float()
            if rounds:
                t = t.to(torch.bfloat16).float()
            acc = acc + t
        return acc

    if width < SPLIT_MIN_WIDTH:
        return slice_sum(0, width)
    step = -(-width // GROUPS_PER_BLOCK)
    parts = [slice_sum(min(width, g * step), min(width, (g + 1) * step))
             for g in range(GROUPS_PER_BLOCK)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def sum_order_bound(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """How far two float32 sums of one bucket's terms in different orders
    may lie apart, element by element: each lies within (width - 1) units
    of 2^-24 of the sum of the terms' magnitudes from the exact sum, so the
    two within twice that."""
    width = idx.shape[1]
    mags = kernel_order(x.abs(), idx, w.abs())
    return 2.0 * max(width - 1, 0) * 2.0**-24 * mags
