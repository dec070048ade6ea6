"""The collectives of the sharded schedules, with explicit backwards.

JAX transposes collectives inside ``shard_map`` by itself.  PyTorch's
``torch.distributed.nn`` all-gather sums its gradient over the group
(every model rank computes the same loss, so that is ``m`` times too
much) and fails in its backward on a sub-group of a device mesh.  So each
collective that autograd must see is a ``torch.autograd.Function`` here,
named by what its result feeds:

* ``gather_rows`` — all-gather of row shards whose result every rank of
  the group uses identically (replicated compute): the backward keeps
  the rank's own rows of the cotangent, which every rank holds whole;
* ``row_slice`` — this rank's rows of a replicated tensor, used by each
  rank for its own rows: the backward all-gathers the slices' cotangents.

The propagation layers themselves (``spmd.py``, ``halo.py``) are
autograd Functions whose backward is the same sharded product on the
cotangent, since ``A_norm`` is symmetric; they call ``all_gather_rows``.

Every call is the list form of ``all_gather`` or ``all_reduce`` on
contiguous, equal-shaped tensors, which gloo and NCCL both take.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` (equal shapes) along rows, in rank
    order of ``group``.  Not differentiable."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_mean_(x: torch.Tensor, group, divisor: int) -> torch.Tensor:
    """In place: the sum of ``x`` over ``group``, divided by ``divisor``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    if divisor != 1:
        x.div_(divisor)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.rows : (r + 1) * ctx.rows], None


class _RowSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        rows = x.shape[0] // n
        r = dist.get_rank(group)
        return x[r * rows : (r + 1) * rows].clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_rows(grad, ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather row shards into the whole tensor, for compute that every
    rank of ``group`` then does alike (differentiable)."""
    return _GatherRows.apply(x, group)


def row_slice(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of a replicated ``x`` whose row count
    the group size divides, for compute that differs by rank
    (differentiable)."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split {n} ways")
    return _RowSlice.apply(x, group)
