"""Sparse propagation ``A_norm @ emb`` over the degree-bucketed ELL graph.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/spmm.py``:

* ``propagate_ell`` — per bucket a gather, multiply and reduce over the
  padded neighbor axis, the hub rows as one dense matrix product, a
  zeros row for degree-0 nodes, and one gather restoring node order.
  These are ``index_select`` and ``torch.matmul``: the JAX package
  leaves them to XLA, not to a Pallas kernel.  ``A_norm`` is symmetric,
  so its backward pass is the same gather product applied to the
  cotangent (a ``torch.autograd.Function``), never autograd's
  ``index_add_`` scatter through the gathers.
* ``propagate_coo`` — ``index_add_`` over the dst-sorted COO list; the
  in-port oracle for the ELL path.

Index arrays are converted to int64 once, in ``to_device_graph``:
``index_select`` and ``index_add_`` take int64 indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.build import Graph


@dataclasses.dataclass
class DeviceGraph:
    """Device-resident adjacency.  The COO view is empty unless built
    with ``include_coo=True``."""

    src: torch.Tensor                          # [nnz_pad] int64, dst-sorted COO
    dst: torch.Tensor                          # [nnz_pad] int64
    weight: torch.Tensor                       # [nnz_pad] compute dtype
    bucket_nbr_idx: Tuple[torch.Tensor, ...]   # per bucket [nb, width] int64
    bucket_nbr_w: Tuple[torch.Tensor, ...]     # per bucket [nb, width]
    gather_idx: torch.Tensor                   # [num_nodes] int64 into
                                               # concat(buckets, hub rows, zeros row)
    dense_mat: torch.Tensor                    # [H, num_nodes] hub rows


def to_device_graph(
    g: Graph,
    compute_dtype: torch.dtype = torch.float32,
    include_coo: bool = False,
    device: DeviceLike = None,
) -> DeviceGraph:
    """Ship the ELL view (and, with ``include_coo``, the COO view, ~20
    bytes per edge) to ``device`` with weights in ``compute_dtype``."""
    dev = resolve_device(device)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    def val(a):
        return torch.as_tensor(a, device=dev).to(compute_dtype)

    empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
    return DeviceGraph(
        src=idx(g.src) if include_coo else empty_i,
        dst=idx(g.dst) if include_coo else empty_i,
        weight=val(g.weight) if include_coo
        else torch.zeros(0, dtype=compute_dtype, device=dev),
        bucket_nbr_idx=tuple(idx(b.nbr_idx) for b in g.buckets),
        bucket_nbr_w=tuple(val(b.nbr_w) for b in g.buckets),
        gather_idx=idx(g.gather_idx),
        dense_mat=val(g.dense_mat),
    )


def to_device_graph_auto(
    g: Graph,
    compute_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> DeviceGraph:
    """The layout single-device entry points use.  Always the plain ELL
    layout: the JAX package's source-chunked layout works around a TPU
    gather-rate knee that has not been measured on this card."""
    return to_device_graph(g, compute_dtype=compute_dtype, device=device)


def propagate_coo(
    emb: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """``out[v] = sum_{e: dst[e]=v} w[e] * emb[src[e]]``."""
    msgs = emb.index_select(0, src) * weight[:, None]
    out = torch.zeros((num_nodes, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    return out.index_add_(0, dst, msgs)


# Widths up to this use a sum of width-1 gathers instead of one
# [nb, width, d] gather (JAX ops/spmm.py:145, chosen there for the TPU's
# tile padding).  Kept so both packages sum in the same order; the
# crossover on this card is not measured.
COLSUM_MAX_WIDTH = 4


def _bucket_reduce(emb: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One ELL bucket's ``sum_j emb[idx[:, j]] * w[:, j]`` as f32 rows
    (f32 accumulation even when ``emb`` is stored in bf16: widths reach
    2048, where a bf16 sum loses about two digits)."""
    width = idx.shape[1]
    if width <= COLSUM_MAX_WIDTH:
        acc = None
        for j in range(width):
            t = (emb.index_select(0, idx[:, j]) * w[:, j, None]).float()
            acc = t if acc is None else acc + t
        return acc
    gathered = emb[idx]                                  # [nb, width, d]
    return (gathered * w[..., None]).sum(dim=1, dtype=torch.float32)


def _ell_matvec(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat):
    parts = [
        _bucket_reduce(emb, idx, w).to(emb.dtype)
        for idx, w in zip(bucket_nbr_idx, bucket_nbr_w)
    ]
    if dense_mat.shape[0]:
        # hub rows: one dense product replaces the power-law gather tail;
        # f32 accumulation as in the JAX package's preferred_element_type
        hub = torch.matmul(dense_mat.float(), emb.to(dense_mat.dtype).float())
        parts.append(hub.to(emb.dtype))
    parts.append(emb.new_zeros((1, emb.shape[1])))  # degree-0 row
    return torch.cat(parts, dim=0).index_select(0, gather_idx)


class _PropagateEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat):
        ctx.graph = (bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)
        return _ell_matvec(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)

    @staticmethod
    def backward(ctx, grad):
        # A_norm is symmetric: d(emb) = A_norm^T @ grad = A_norm @ grad
        return (_ell_matvec(grad, *ctx.graph),) + (None,) * 4


def propagate_ell(
    emb: torch.Tensor,
    bucket_nbr_idx: Tuple[torch.Tensor, ...],
    bucket_nbr_w: Tuple[torch.Tensor, ...],
    gather_idx: torch.Tensor,
    dense_mat: torch.Tensor,
) -> torch.Tensor:
    """Scatter-free SpMM over the ELL adjacency plus dense hub rows,
    differentiable in ``emb``."""
    return _PropagateEll.apply(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)


def propagate(emb: torch.Tensor, graph, num_nodes: int, *, path: str = "ell"):
    """One propagation step ``A_norm @ emb``.  ``graph`` is a DeviceGraph
    (``path`` 'ell' or 'coo') or an ``ops/block_spmm.py``
    TiledDeviceGraph, which always takes the tile path."""
    from gcn_recommendation_tpu_torch.ops.block_spmm import (
        TiledDeviceGraph,
        propagate_ell_tiles,
    )

    if isinstance(graph, TiledDeviceGraph):
        return propagate_ell_tiles(emb, graph.base, graph.tiles)
    if path == "ell":
        return propagate_ell(
            emb, graph.bucket_nbr_idx, graph.bucket_nbr_w, graph.gather_idx,
            graph.dense_mat,
        )
    if path == "coo":
        if graph.src.shape[0] == 0:
            raise ValueError(
                "COO view not on device — build with "
                "to_device_graph(..., include_coo=True)"
            )
        return propagate_coo(emb, graph.src, graph.dst, graph.weight, num_nodes)
    raise ValueError(f"unknown propagation path {path!r}")
